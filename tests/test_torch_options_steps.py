"""Whole baroclinic steps of the per-direction faces, the quad-family LDG
viscosity (method_visc=1) and LSRK sub-cycling, the port's own Model
against the JAX package's (tests/test_torch_options.py holds the stage
functions and one solve; tests/test_torch_options_drag.py the shear stress
and quadratic bottom drag, tests/test_torch_options_periodic.py periodic
grids).

Two f64 steps, each channel of each state field to 1e-11 of its max; one
step of `lsrk_ref`, which diverges by design within three; f32 at 1e-4 of
each field's max for one configuration of each option. Every JAX model
takes the path the port mirrors (use_pallas="on", interpret mode;
mega="off" unless the megakernel is the path), and the port's path is
proved by the counters of the plain versions each step calls
(tests/test_torch_common.check_steps_against_jax)."""
import pytest

from test_torch_common import STEP_CASES_FACES_LSRK, check_steps_against_jax
from test_torch_common import one_thread  # noqa: F401  (autouse)


@pytest.mark.filterwarnings("ignore:ti_method_btp='lsrk_ref'")
@pytest.mark.parametrize("case", STEP_CASES_FACES_LSRK,
                         ids=[c[0] for c in STEP_CASES_FACES_LSRK])
def test_steps_match_jax(case, monkeypatch):
    check_steps_against_jax(*case[1:], monkeypatch=monkeypatch)


def test_lsrk_ref_warns_with_the_jax_package_s_words():
    import warnings

    from hnumo_tpu.model import Model as JaxModel
    from hnumo_tpu_torch.model import Model as TorchModel
    from test_torch_common import jax_config, torch_config

    msgs = []
    for build, config in ((JaxModel, jax_config), (TorchModel, torch_config)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            kw = {"device": "cpu"} if build is TorchModel else {}
            build(config(nelx=2, nely=2, ti_method_btp="lsrk_ref"), **kw)
        msgs.append([str(w.message) for w in rec if "lsrk_ref" in str(w.message)])
    assert len(msgs[1]) == 1 and msgs[1] == msgs[0]
    assert "DIVERGES within a few steps" in msgs[1][0]
