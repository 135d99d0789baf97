"""Whole baroclinic steps on periodic grids, the port's own Model against
the JAX package's, on the per-stage and on the fused path: periodic in x
with a no-slip south and a copy north side, periodic in y with a copy west
and a free-slip east side (walls hide a wrong sign at a boundary face, a
copy side shows it), and periodic in both. Two f64 steps, each channel of
each state field to 1e-11 of its max; f32 at 1e-4 on the fused path. The
port's path is proved by the counters of the plain versions it calls
(tests/test_torch_common.check_steps_against_jax)."""
import pytest

from test_torch_common import STEP_CASES_PERIODIC, check_steps_against_jax
from test_torch_common import one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("case", STEP_CASES_PERIODIC, ids=[c[0] for c in STEP_CASES_PERIODIC])
def test_periodic_steps_match_jax(case, monkeypatch):
    check_steps_against_jax(*case[1:], monkeypatch=monkeypatch)
