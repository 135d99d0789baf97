"""The port replays the JAX package's frozen float64 double-gyre trajectory
(tests/goldens/dgyre_traj.npz, reference Examples/double_gyre/numo3d.in:
wind, linear bottom friction, beta plane, nodal-family viscosity): steps 3
and 10 every run, steps 50 and 100 slow-marked, as tests/test_golden.py
does; its tolerances. The configuration is built field by field from
tools/freeze_goldens.py's (tests/test_torch_golden.py holds the port's own
copy equal to it)."""
import pytest
import torch

from hnumo_tpu_torch.model import Model
from hnumo_tpu_torch.tools import goldens
from test_torch_golden import one_thread, port_config  # noqa: F401  (one_thread: autouse)
from tools.freeze_goldens import dgyre_config


def test_double_gyre_short_golden():
    m = Model(port_config(dgyre_config()), device="cpu")
    assert m.static.mega       # 625 elements: the megakernel path, as the JAX package
    assert goldens.replay(m, "dgyre_traj", max_steps=10)[0] <= 1.0


@pytest.mark.slow
def test_double_gyre_long_golden():
    m = Model(port_config(dgyre_config()), device="cpu")
    assert goldens.replay(m, "dgyre_traj")[0] <= 1.0
