"""Whole baroclinic steps with the vertical shear stress (ad_mlswe>0, with
and without compat_reference_stress) and with quadratic bottom drag
(botfr=2) on each of the three barotropic paths, the port's own Model
against the JAX package's: two f64 steps, each channel of each state field
to 1e-11 of its max; f32 at 1e-4 of each field's max. The port's path is
proved by the counters of the plain versions it calls
(tests/test_torch_common.check_steps_against_jax)."""
import pytest

from test_torch_common import (SHEAR, STEP_CASES_DRAG, check_steps_against_jax,
                               torch_config)


@pytest.mark.parametrize("case", STEP_CASES_DRAG, ids=[c[0] for c in STEP_CASES_DRAG])
def test_steps_match_jax(case, monkeypatch):
    check_steps_against_jax(*case[1:], monkeypatch=monkeypatch)


@pytest.mark.parametrize("mega", ["on", "off"])
def test_shear_stress_acts(mega):
    """The shear term moves the layer momenta: the branch is live, on the
    megakernel path and on the per-stage path."""
    from hnumo_tpu_torch.model import Model

    on = Model(torch_config(mega=mega, **SHEAR), device="cpu")
    off = Model(torch_config(mega=mega), device="cpu")
    a, b = on.step(on.state0), off.step(off.state0)
    assert bool(a.ok)
    assert float((a.q_df[1:] - b.q_df[1:]).abs().max()) > 0.0
