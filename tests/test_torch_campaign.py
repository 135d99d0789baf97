"""The port's double-gyre campaign: its diagnostics against the JAX
package's, and the committed H100 campaign inside the f32 acceptance band.

`hnumo_tpu_torch.io.diagnostics.derived_fields` / `compute_mass` and the
port tool's `sample` equal the JAX package's on the same float64 state.
docs/artifacts/dgyre_f32_h100.json — 100 model days of the reference's
double gyre, f32 at 25x25, stepped by the port through its captured CUDA
graph on an H100 (hnumo_tpu_torch/tools/dgyre_campaign.py) — is held inside
the band of tests/test_campaign.py around docs/artifacts/dgyre_f64_cpu.json,
unchanged: KE 2%, |u|max 3%, spin-up SSH extrema 10%, mass drift < 1e-5. The
artifact is committed: its absence fails the test.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnumo_tpu.io.diagnostics import compute_mass as jax_compute_mass
from hnumo_tpu.io.diagnostics import derived_fields as jax_derived_fields
from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu_torch.io.diagnostics import compute_mass, derived_fields
from hnumo_tpu_torch.model import Model
from hnumo_tpu_torch.tools import dgyre_campaign as port_tool
from test_torch_golden import port_config
from tools import dgyre_campaign as jax_tool
from tools.freeze_goldens import dgyre_config

ART = os.path.join(os.path.dirname(__file__), "..", "docs", "artifacts")
REL = 1e-13


def _load(name):
    with open(os.path.join(ART, name)) as f:     # committed: no skip
        return json.load(f)


@pytest.fixture(scope="module")
def pair():
    """A JAX and a port model of one small double gyre, f64, and one
    perturbed state of each holding the same numbers."""
    cfg = dataclasses.replace(dgyre_config(), nelx=5, nely=4)
    jm, tm = JaxModel(cfg), Model(port_config(cfg), device="cpu")
    rng = np.random.default_rng(11)
    s = tm.step(tm.state0)
    q = s.q_df.numpy()
    q = q + 1e-3 * np.abs(q).max() * rng.normal(size=q.shape)
    ts = s._replace(q_df=torch.tensor(q))
    js = jm.state0._replace(q_df=jnp.asarray(q), qb_df=jnp.asarray(s.qb_df.numpy()))
    return jm, js, tm, ts


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float64, (name, got.shape, got.dtype)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max(), err_msg=name)


def test_derived_fields_are_the_jax_package_s(pair):
    jm, js, tm, ts = pair
    got, want = derived_fields(tm, ts), jax_derived_fields(jm, js)
    for i, name in enumerate(("h", "u", "v", "dp", "ssh")):
        _close(got[i], want[i], name)


def test_compute_mass_is_the_jax_package_s(pair):
    jm, js, tm, ts = pair
    _close(compute_mass(tm, ts), jax_compute_mass(jm, js), "mass")


def test_sample_is_the_jax_tool_s(pair):
    jm, js, tm, ts = pair
    got, want = port_tool.sample(tm, ts), jax_tool.sample(jm, js)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], k)


def test_campaign_config_is_the_jax_tool_s():
    for f64 in (False, True):
        for nel in (25, 10):
            want = dgyre_config(dtype="float64" if f64 else "float32")
            if nel != 25:
                want = dataclasses.replace(want, nelx=nel, nely=nel, dt=500.0 * 25 / nel,
                                           dt_btp=25.0 * 25 / nel)
            assert port_tool.campaign_config(f64, nel) == port_config(want)


def test_a_short_campaign_writes_the_jax_tool_s_schema(tmp_path):
    """On the CPU at 4x4: every sample taken, the artifact written, and its
    keys those of the JAX tool's artifacts."""
    m = Model(port_tool.campaign_config(nel=4), device="cpu")
    out = tmp_path / "a.json"
    every = 2 * m.cfg.dt / 86400.0        # a sample every 2 steps, 3 samples
    art = port_tool.run(m, days=3 * every, sample_days=every, out=str(out))
    assert json.loads(out.read_text()) == json.loads(json.dumps(art))
    ref = _load("dgyre_f32_tpu.json")
    assert art.keys() == ref.keys()
    assert set(ref["config"]) <= set(art["config"])
    assert art["records"][0].keys() == ref["records"][0].keys()
    assert art["complete"] and art["ok"] and art["config"]["device"] == "cpu"
    assert [r["step"] for r in art["records"]] == [2, 4, 6] and art["steps"] == 6
    assert art["mass_rel_drift"] < 1e-5


def test_f32_h100_is_complete():
    d = _load("dgyre_f32_h100.json")
    assert d["complete"] and d["ok"]
    assert d["records"][-1]["t_days"] >= 99.0
    assert d["config"]["dtype"] == "float32" and d["config"]["step_impl"] == "graph"
    assert d["config"]["device"].startswith("NVIDIA H100"), d["config"]["device"]
    assert d["config"]["device"].endswith(" W"), "the card's power limit"


def test_f32_h100_tracks_f64_band():
    """The band of tests/test_campaign.py::test_f32_tpu_tracks_f64_band, on
    the port's H100 campaign."""
    d64 = _load("dgyre_f64_cpu.json")
    d32 = _load("dgyre_f32_h100.json")
    assert d32["complete"] and d32["ok"]
    assert d32["mass_rel_drift"] < 1e-5, "f32 telescoping mass leak"
    r64 = {round(r["t_days"], 3): r for r in d64["records"]}
    r32 = {round(r["t_days"], 3): r for r in d32["records"]}
    common = sorted(set(r64) & set(r32))
    assert len(common) >= 100, "campaigns sample different time grids"
    ke64 = np.array([r64[t]["ke_total"] for t in common])
    ke32 = np.array([r32[t]["ke_total"] for t in common])
    scale = np.maximum(np.abs(ke64), 0.05 * np.abs(ke64).max())
    rel = np.abs(ke32 - ke64) / scale
    assert rel.max() < 0.02, (
        f"f32 KE deviates from f64 band: max rel {rel.max():.3e} "
        f"at day {common[int(rel.argmax())]}")
    u64 = np.array([r64[t]["umax"] for t in common])
    u32 = np.array([r32[t]["umax"] for t in common])
    urel = np.abs(u32 - u64) / np.maximum(u64, 0.05 * u64.max())
    assert urel.max() < 0.03, f"umax deviates: {urel.max():.3e}"
    early = [t for t in common if t <= 25.0]
    s64 = np.array([[r64[t]["ssh_min"], r64[t]["ssh_max"]] for t in early])
    s32 = np.array([[r32[t]["ssh_min"], r32[t]["ssh_max"]] for t in early])
    sscale = np.abs(s64).max()
    assert np.abs(s32 - s64).max() / sscale < 0.10


def test_the_tool_s_band_is_the_test_s():
    """The band chip_smoke.py holds the campaign's spin-up to
    (dgyre_campaign.band) passes the committed f32 campaigns and refuses the
    bf16 one, whose free surface left the band (docs/float32.md)."""
    d64 = _load("dgyre_f64_cpu.json")
    for name in ("dgyre_f32_h100.json", "dgyre_f32_tpu.json"):
        out = port_tool.band(_load(name), d64)
        assert out["samples"] == 201 and out["ke_rel"] < 0.02 and out["ssh_rel"] < 0.10
    with pytest.raises(AssertionError, match="outside the f64 band"):
        port_tool.band(_load("dgyre_f32_tpu_bf16.json"), d64)
    with pytest.raises(AssertionError, match="in common"):
        port_tool.band(_load("dgyre_f32_h100.json"), {"records": d64["records"][:5]})
