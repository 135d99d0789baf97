"""The plain reference agrees with the port's eager step at a tiny size,
and the seeded state is the port's rest state where the seed draws nothing."""
import json

import numpy as np
import pytest
import torch

from portbench import state as seeded
from portbench.reference import Reference, State as RState
from portbench.tests.conftest import ROOT


def _cfg(**over):
    cfg = json.loads((ROOT / "portbench/configs/dgyre_p4_25.json").read_text())["config"]
    cfg.update(nelx=4, nely=3, xdims=[0.0, 4e6 / 3], **over)
    return cfg


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_reference_matches_the_ports_eager_step(dtype):
    from hnumo_tpu_torch.core.types import State
    from hnumo_tpu_torch.model import Model

    from portbench.drive import program_config

    cfg = _cfg(dtype=dtype)
    fields = seeded.initial_fields(cfg, 123456789012, {"amplitude_m": 20.0, "modes": 4})
    tdt = torch.float64 if dtype == "float64" else torch.float32
    ref = Reference(seeded.ref_config(cfg), "cpu", tdt)
    got = ref.run(seeded.as_state(RState, fields, tdt, "cpu"), 2)
    m = Model(program_config(cfg, mega="off"), device="cpu")
    s = seeded.as_state(State, fields, tdt, "cpu")
    for _ in range(2):
        s = m.step(s)
    for a, b in zip(got, s):
        assert torch.equal(a, b)


def test_seeded_state_is_the_rest_state_displaced():
    from hnumo_tpu_torch.model import Model

    from portbench.drive import program_config

    cfg = _cfg(dtype="float64")
    m = Model(program_config(cfg), device="cpu")
    rest = seeded.initial_fields(cfg, 1, {"amplitude_m": 0.0 + 1e-300, "modes": 2})
    for name, mine in (("qb_df", rest["qb"]), ("q_df", rest["q"]), ("qprime_df", rest["qprime"])):
        np.testing.assert_allclose(mine, getattr(m.state0, name).numpy(), rtol=0, atol=1e-6)
    a = seeded.initial_fields(cfg, 7, {"amplitude_m": 20.0, "modes": 4})
    b = seeded.initial_fields(cfg, 7, {"amplitude_m": 20.0, "modes": 4})
    c = seeded.initial_fields(cfg, 8, {"amplitude_m": 20.0, "modes": 4})
    assert np.array_equal(a["q"], b["q"]) and not np.array_equal(a["q"], c["q"])
    # the same largest displacement on every seed: 20 m of the upper layer
    g, alpha = 9.806, 9.7370e-4
    for f in (a, c):
        assert np.abs(f["q"][0, 0]).max() == pytest.approx(g / alpha * 20.0, rel=1e-12)
    assert np.abs(a["q"][1:]).max() == 0.0
    seeded.initial_fields(cfg, 2**64 + 5, {"amplitude_m": 20.0, "modes": 4})
