"""Two full baroclinic steps of the PyTorch Model on the whole-solve path
(mega="on", the plain version of the megakernel on the CPU) against the JAX
Model with mega="on", use_pallas="on" (its megakernel in interpret mode):
f64, each field to 1e-10 of its max, as tests/test_mega.py::test_mega_full_steps
holds the JAX megakernel to its default path. Also the port's two paths
against each other, and f32 at 1e-4 of each field's max (two steps = 400
stages of f32 roundoff in two different summation orders)."""
import numpy as np
import pytest
import torch

from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu_torch.convert import from_numpy_tables
from hnumo_tpu_torch.model import Model as TorchModel
from test_torch_common import TDTYPE, jax_config, to_np, torch_config
from test_torch_common import one_thread  # noqa: F401  (autouse)

FIELDS = ("qb_df", "q_df", "qprime_df")
REL = {"float64": 1e-10, "float32": 1e-4}


@pytest.fixture(scope="module", params=["float64", "float32"])
def stepped(request):
    dtype = request.param
    jm = JaxModel(jax_config(dtype=dtype, mega="on"))
    assert jm.static.mega and jm.static.use_pallas
    tables = from_numpy_tables(to_np(jm.P), to_np(jm.g), to_np(jm.state0), "cpu",
                               TDTYPE[dtype])
    s = jm.state0
    for _ in range(2):
        s = jm.step(s)
    return dtype, to_np(s), tables


def _check(dtype, got, want):
    assert bool(got.ok)
    for name in FIELDS:
        a = np.asarray(getattr(want, name), np.float64)
        b = getattr(got, name).double().numpy()
        scale = np.abs(a).max() + 1e-30
        assert np.abs(a - b).max() / scale < REL[dtype], name


@pytest.mark.parametrize("tables", ["own", "converted"])
def test_two_mega_steps_match_jax(stepped, tables):
    dtype, want, (P, g, state0) = stepped
    cfg = torch_config(dtype=dtype, mega="on")
    if tables == "own":
        tm = TorchModel(cfg, device="cpu")
    else:
        tm = TorchModel.from_tables(cfg, P, g, state0, device="cpu")
    assert tm.static.mega and tm.static.impl == "plain"
    assert tm.mega_ops is not None
    s0 = tm.state0
    keep = [t.clone() for t in s0]
    s = tm.run(s0, 2)
    _check(dtype, s, want)
    for a, b in zip(tm.state0, keep):
        assert torch.equal(a, b)
    assert s.qb_df.dtype == TDTYPE[dtype]


def test_two_steps_mega_against_per_stage_path(stepped):
    """mega="auto" takes the whole-solve path on this 30-element grid and
    agrees with mega="off" to the same tolerance."""
    dtype = stepped[0]
    auto = TorchModel(torch_config(dtype=dtype, mega="auto"), device="cpu")
    off = TorchModel(torch_config(dtype=dtype, mega="off"), device="cpu")
    assert auto.static.mega and auto.mega_ops is not None
    assert not off.static.mega and off.mega_ops is None
    _check(dtype, auto.run(auto.state0, 2), off.run(off.state0, 2))
