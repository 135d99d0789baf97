"""Two baroclinic steps of the PyTorch Model against the JAX Model on the
path the port mirrors (use_pallas="on" in interpret mode, mega="off"):
on the port's own tables and on tables converted from the JAX package.
f64 at 1e-11*max(|a|, 1) as tests/test_pallas.py; f32 at 1e-4 of each
field's max (two steps = 400 stages of f32 roundoff in two different
summation orders)."""
import numpy as np
import pytest
import torch

from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu_torch.convert import from_numpy_tables
from hnumo_tpu_torch.model import Model as TorchModel
from test_torch_common import TDTYPE, jax_config, to_np, torch_config
from test_torch_common import one_thread  # noqa: F401  (autouse)

FIELDS = ("qb_df", "q_df", "qprime_df")


@pytest.fixture(scope="module", params=["float64", "float32"])
def stepped(request):
    dtype = request.param
    jm = JaxModel(jax_config(dtype=dtype))
    assert jm.static.use_pallas and not jm.static.mega
    tables = from_numpy_tables(to_np(jm.P), to_np(jm.g), to_np(jm.state0), "cpu",
                               TDTYPE[dtype])
    s = jm.state0
    for _ in range(2):
        s = jm.step(s)
    return dtype, to_np(s), tables


def _check(dtype, got, want):
    for name in FIELDS:
        a = getattr(want, name)
        b = getattr(got, name).numpy()
        if dtype == "float64":
            atol = 1e-11 * max(np.abs(a).max(), 1)
        else:
            atol = 1e-4 * np.abs(a).max()
        np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=name)
    assert bool(got.ok) == bool(want.ok) is True
    np.testing.assert_allclose(float(got.t), float(want.t), rtol=1e-6 if dtype == "float32" else 1e-15)


def test_two_steps_own_tables(stepped):
    dtype, want, _ = stepped
    tm = TorchModel(torch_config(dtype=dtype), device="cpu")
    s0 = tm.state0
    keep = [t.clone() for t in s0]
    s = tm.step(tm.step(s0))
    _check(dtype, s, want)
    # the input state is unchanged after step (the port does not donate)
    for a, b in zip(tm.state0, keep):
        assert torch.equal(a, b)
    assert s.qb_df.dtype == TDTYPE[dtype]


def test_two_steps_converted_tables(stepped):
    dtype, want, (P, g, state0) = stepped
    tm = TorchModel.from_tables(torch_config(dtype=dtype), P, g, state0, device="cpu")
    _check(dtype, tm.run(tm.state0, 2), want)


def test_from_tables_refuses_other_dtype(stepped):
    dtype, _, (P, g, state0) = stepped
    other = "float32" if dtype == "float64" else "float64"
    with pytest.raises(ValueError, match="tables are"):
        TorchModel.from_tables(torch_config(dtype=other), P, g, state0, device="cpu")


def test_run_aborts_on_negative_thickness():
    tm = TorchModel(torch_config(dt=4.0e6, dt_btp=2.0e5), device="cpu")
    with pytest.raises(RuntimeError, match="Negative mass"):
        tm.run(tm.state0, 5)
    # check_ok=False runs on, and the flag stays down
    s = tm.run(tm.state0, 1, check_ok=False)
    assert not bool(s.ok)


def test_precision_is_set_at_construction():
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    TorchModel(torch_config(nelx=2, nely=2), device="cpu")
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_lake_at_rest_stays_flat():
    """Lake at rest over a bump is an exact steady state: after 3 steps in f64
    the barotropic pressure perturbation and the layer momenta stay at
    roundoff (1e-11 of the reference pressure scale)."""
    tm = TorchModel(torch_config(test_case="lakeatrest", f0=0.0, beta=0.0,
                                 xdims=(0.0, 2e3), ydims=(0.0, 2e3), dt=1.0,
                                 dt_btp=0.25, visc_mlswe=0.0, botfr=0),
                    device="cpu")
    s = tm.run(tm.state0, 3)
    scale = float(tm.P.pbprime_df.max())
    assert float(s.qb_df[1].abs().max()) < 1e-11 * scale
    assert float(s.q_df[1:].abs().max()) < 1e-11 * scale
