"""The port replays the JAX package's frozen float64 trajectories: the CI
bump case (tests/goldens/bump_traj.npz, steps 3 and 10) here, and the
108-step CI bump against the reference's FIN values with the 1e-12 mass
gate (slow-marked, as in tests/test_golden.py). The double gyre is in
tests/test_torch_golden_dgyre.py, so that the two replays run side by side.

The port's configurations are built field by field from
tools/freeze_goldens.py's, and its own copies (hnumo_tpu_torch/tools/
goldens.py, which chip_smoke.py runs on the card) are held equal to them,
so the configurations cannot drift. The tolerances are tests/test_golden.py's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from hnumo_tpu_torch.config import Config as TorchConfig
from hnumo_tpu_torch.model import Model
from hnumo_tpu_torch.tools import goldens
from tools.freeze_goldens import bump_config, dgyre_config


@pytest.fixture(autouse=True)
def one_thread():
    """A step here is thousands of operations on small tensors: one intra-op
    thread runs it several times faster than many, and the suite's workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(jax_cfg) -> TorchConfig:
    """The port's Config with every one of its fields taken from a JAX one."""
    return TorchConfig(**{f.name: getattr(jax_cfg, f.name)
                          for f in dataclasses.fields(TorchConfig)})


def test_the_port_s_golden_configs_are_the_frozen_ones():
    assert goldens.bump_config() == port_config(bump_config())
    assert goldens.dgyre_config() == port_config(dgyre_config())
    assert goldens.dgyre_config(dtype="float32") == port_config(dgyre_config(dtype="float32"))


def test_the_port_s_tolerances_and_fin_values_are_the_frozen_ones():
    import tests.test_golden as tg

    assert goldens.REF_FIN == tg._REF_FIN
    assert (goldens.RTOL, goldens.ATOL_OVER_SCALE) == (1e-9, 1e-13)


def test_the_fingerprint_is_the_freezing_tool_s():
    """The port's fingerprint of a state equals tools/freeze_goldens.py's of
    the same numbers."""
    import jax.numpy as jnp

    from hnumo_tpu.core.types import State as JaxState
    from tools.freeze_goldens import fingerprint

    m = Model(dataclasses.replace(goldens.bump_config(), nelx=3, nely=2), device="cpu")
    s = m.step(m.state0)
    js = JaxState(*[jnp.asarray(t.numpy()) for t in s])
    want = fingerprint(js, None)
    got = goldens.fingerprint(s)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bump_short_golden():
    m = Model(port_config(bump_config()), device="cpu")
    assert m.static.mega       # 100 elements: the megakernel path, as the JAX package
    worst, _ = goldens.replay(m, "bump_traj")
    assert worst <= 1.0


@pytest.mark.slow
def test_bump_full_ci_golden():
    m = Model(port_config(bump_config()), device="cpu")
    assert m.nsteps_total == 108
    out = goldens.ci_bump(m)
    assert out["mass_rel_loss"] < goldens.MASS_LOSS_TOL
    assert out["fin_rel_dev"] < goldens.FIN_RTOL
