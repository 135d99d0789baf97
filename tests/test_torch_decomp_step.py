"""The decomposed model of the port, whole steps, on the grid of
tests/test_sharding.py (8x8 elements, p=3, the bump, f64), split (2, 2) and
(1, 4) over spawned gloo ranks:

- against the port's serial run on the same path (mega="off"; the split
  model never takes the megakernel): each channel within 1e-12 of its max,
  and bitwise in the two f32 cases (per stage and fused).
  Measured: bitwise, every case, both splits (each block folds the whole
  grid's first-element metric into its uniform operators, as the serial
  run does; with its own first element the fused path differed by up to
  9e-14 here, and by 5e-10 in chip_smoke.py phase 27's 32x32 f64 case on
  an H100, amplified by a copy wall);
- against the JAX package's sharded run (make_mesh, the same split): 1e-6,
  its own bound in tests/test_sharding.py (XLA reassociates under
  shard_map);
- against the JAX package's serial run: 1e-11, on the port's own tables
  and on the JAX package's, cut to each block (convert.block_from_numpy);
- per-layer mass change within 1e-12 on closed and periodic domains;
- the barotropic path by the plain versions' counters on every rank.

The options under decomposition: periodic sides along a split axis (px > 1)
and along an axis of one block (the serial wrap), the nodal viscosity with
both face pipelines, the lake at rest (tests/test_sharding.py's bounds), the
fused path with a no-slip and a copy wall (kernel U's wall masks are per
block), and the quad family.
"""
import pathlib

import jax
import numpy as np
import pytest
import torch

import torch_decomp_ranks as R
from hnumo_tpu.config import Config as JaxConfig
from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu.parallel.sharding import make_mesh
from hnumo_tpu_torch.model import Model as TorchModel
from hnumo_tpu_torch.parallel.launch import start_function
from test_torch_common import to_np

TESTS = pathlib.Path(__file__).resolve().parent
SHAPES = [(2, 2), (1, 4)]
VISC = dict(method_visc=2, visc_mlswe=10.0)
# name -> (config overrides, steps, barotropic path, closed or periodic domain)
CASES = {
    "bump": (dict(), 3, "per_stage", True),
    "periodic_x": (dict(x_boundary=(3, 3), y_boundary=(4, 4), **VISC), 2, "per_stage", True),
    "periodic_x-batched_on": (dict(x_boundary=(3, 3), y_boundary=(4, 4),
                                   batched_faces="on", **VISC), 2, "per_stage", True),
    "periodic_x-per_direction": (dict(x_boundary=(3, 3), y_boundary=(4, 4),
                                      batched_faces="off", **VISC), 2, "per_stage", True),
    "periodic_y-walls0420": (dict(x_boundary=(0, 4), y_boundary=(3, 3), **VISC), 2,
                             "per_stage", False),
    "lakeatrest": (dict(test_case="lakeatrest"), 5, "per_stage", True),
    "fused-walls20": (dict(x_boundary=(2, 0), fused_tail="on", **VISC), 2, "fused", False),
    "fused-periodic_x": (dict(x_boundary=(3, 3), y_boundary=(2, 4), fused_tail="on",
                              **VISC), 2, "fused", True),
    "quad-walls20": (dict(x_boundary=(2, 0), method_visc=1, visc_mlswe=10.0), 2,
                     "per_stage", False),
    # f32: where chip_smoke.py phase 27 reads a split f32 run apart from the
    # serial one on the card, these say whether the CPU does too
    "bump-f32": (dict(dtype="float32"), 3, "per_stage", True),
    "fused-f32": (dict(dtype="float32", fused_tail="on", **VISC), 3, "fused", True),
}
# the cases the JAX package's tests/test_sharding.py runs sharded, with its
# bound; taken at each split of this file
JAX_SHARDED = {"bump": ((2, 2), (1, 4)), "periodic_x": ((2, 2),),
               "periodic_x-batched_on": ((2, 2),)}
SERIAL_REL = 1e-12
JAX_SHARDED_REL = 1e-6
JAX_SERIAL_REL = 1e-11
RANK_TIMEOUT = 300.0


def _fields(s):
    return {f: np.asarray(getattr(s, f)) for f in R.FIELDS}


@pytest.fixture(scope="module")
def runs():
    """The ranks of both splits run every case; meanwhile the parent steps
    the references: the port serial, the JAX package sharded and serial."""
    cases = [(name, over, n) for name, (over, n, _, _) in CASES.items()]
    jser = JaxModel(JaxConfig(**R.BUMP))
    tables = dict(over={}, nsteps=CASES["bump"][1], P_np=to_np(jser.P),
                  g_np=to_np(jser.g), state_np=to_np(jser.state0))
    jobs = [("steps", "steps_ranks", dict(cases=cases)),
            ("jax_tables", "jax_tables_ranks", tables)]
    ranks = {shape: start_function("torch_decomp_ranks:run_jobs", shape, "gloo",
                                   device="cpu", kwargs=dict(jobs=jobs),
                                   pythonpath=[TESTS])
             for shape in SHAPES}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        serial = {}
        for name, (over, n, _, _) in CASES.items():
            m = TorchModel(R.bump_config(**over, mega="off"), device="cpu")
            serial[name] = _fields(m.run(m.state0, n))
    finally:
        torch.set_num_threads(threads)
    jax_sharded = {}
    for name, shapes in JAX_SHARDED.items():
        over, n, _, _ = CASES[name]
        for shape in shapes:
            jm = JaxModel(JaxConfig(**{**R.BUMP, **over}),
                          mesh=make_mesh(jax.devices()[:shape[0] * shape[1]], shape=shape))
            s = jm.state0
            for _ in range(n):
                s = jm.step(s)
            jax_sharded[(name, shape)] = _fields(s)
    s = jser.state0
    for _ in range(CASES["bump"][1]):
        s = jser.step(s)
    jax_serial = _fields(s)
    results = {shape: r.result(RANK_TIMEOUT) for shape, r in ranks.items()}
    port = {shape: [rk["steps"] for rk in res] for shape, res in results.items()}
    on_jax_tables = {shape: res[0]["jax_tables"] for shape, res in results.items()}
    return port, serial, jax_sharded, jax_serial, on_jax_tables


def _scaled_err(got, want):
    """Largest |got - want| over each channel's max |want|, per channel."""
    return [float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-300))
            for g, w in zip(got, want)]


def _check(got, want, rel, what):
    for f in R.FIELDS:
        errs = _scaled_err(got[f], want[f])
        assert max(errs) <= rel, f"{what} {f}: {errs} > {rel}"


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", CASES)
def test_decomposed_steps_match_the_serial_port(runs, name, shape):
    port, serial, *_ = runs
    res = port[shape][0][name]
    assert res["ok"] and res["t"] == CASES[name][1] * R.BUMP["dt"]
    # f32: bitwise (0), what locates chip_smoke.py's f32 split difference on
    # the card in the card's own libraries and kernels, not in the port
    rel = 0.0 if CASES[name][0].get("dtype") == "float32" else SERIAL_REL
    _check(res, serial[name], rel, f"{name} {shape} vs the serial port")
    # the run moved the state (lake at rest excepted: it must not move)
    if name != "lakeatrest":
        assert np.abs(res["q_df"][1]).max() > 0.0


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", CASES)
def test_every_rank_takes_the_path_and_its_kernels(runs, name, shape):
    """Per rank: its block's shape, the barotropic path (never the
    megakernel) proved by the plain versions' counters, the face pipeline of
    the per-stage path, and exchanges on every rank."""
    port, *_ = runs
    _, _, path, _ = CASES[name]
    py, px = shape
    for rank, out in enumerate(port[shape]):
        res = out[name]
        assert res["block"] == (8 // py, 8 // px)
        assert not res["path"]["mega"] and res["path"]["fused"] == (path == "fused")
        nsub = res["nsub"]
        want = dict.fromkeys(res["calls"], 0)
        if path == "fused":
            want.update(volume_uni=nsub, faces=nsub, update=nsub)
        else:
            want["volume"] = nsub
        assert res["calls"] == want, (rank, res["calls"])
        if path == "per_stage":
            flat = res["path"]["batched"]
            assert res["face_pipeline"] == {"flat": nsub if flat else 0,
                                            "per_dir": 0 if flat else nsub}
        assert res["exchange_calls"] > 0 and res["ok"]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[3]])
def test_mass_is_conserved_per_layer(runs, name, shape):
    """Within 1e-12 in f64; within chip_smoke.py's 1e-6 in f32."""
    port, *_ = runs
    res = port[shape][0][name]
    change = np.abs(res["mass"] - res["mass0"]) / res["mass0"]
    tol = 1e-6 if CASES[name][0].get("dtype") == "float32" else 1e-12
    assert (change <= tol).all(), change


@pytest.mark.parametrize("name,shape", [(n, s) for n, ss in JAX_SHARDED.items() for s in ss],
                         ids=str)
def test_decomposed_steps_match_the_jax_sharded_run(runs, name, shape):
    port, _, jax_sharded, *_ = runs
    _check(port[shape][0][name], jax_sharded[(name, shape)], JAX_SHARDED_REL,
           f"{name} {shape} vs the JAX package sharded")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_decomposed_bump_matches_the_jax_serial_run(runs, shape):
    port, _, _, jax_serial, _ = runs
    _check(port[shape][0]["bump"], jax_serial, JAX_SERIAL_REL,
           f"bump {shape} vs the JAX package serial")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_decomposed_bump_on_the_jax_tables(runs, shape):
    """The same blocks of the same tables in both packages: the split port
    on the JAX package's tables against its serial run, and against the
    split port on its own tables."""
    port, _, _, jax_serial, on_jax_tables = runs
    _check(on_jax_tables[shape], jax_serial, JAX_SERIAL_REL,
           f"bump {shape} on the JAX tables vs the JAX package serial")
    _check(on_jax_tables[shape], port[shape][0]["bump"], JAX_SERIAL_REL,
           f"bump {shape} on the JAX tables vs on its own")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_lake_stays_at_rest_across_blocks(runs, shape):
    """tests/test_sharding.py's bounds: the free surface flat to 1e-9, the
    momenta below 1e-4 (u*dp units, dp ~2e5: u ~5e-10 m/s), after 5 steps."""
    port, *_ = runs
    res = port[shape][0]["lakeatrest"]
    m = TorchModel(R.bump_config(test_case="lakeatrest"), device="cpu")
    alpha = m.P.alpha.numpy()
    dp = m.init_fields.qprime_df[0] + res["q_df"][0]
    h = alpha[:, None, None, None, None] / m.static.gravity * dp
    ssh = m.P.zbot_df.numpy() + h.sum(0)
    assert np.abs(ssh - ssh.mean()).max() < 1e-9
    assert np.abs(res["q_df"][1:]).max() < 1e-4


def test_a_block_s_first_step_is_the_serial_one_function_by_function():
    """chip_smoke.py --split-probe's comparison, on the CPU: in f32, every
    function of the port's first step gives block 0 of a 2x2 split bitwise
    what it gives the whole grid, cut to that block, on the per-stage and on
    the fused path (on the card the plain PyTorch contractions do not:
    PERF.md)."""
    import chip_smoke

    cases = [("per_stage", chip_smoke.main_path_config(16, "float32", mega="off",
                                                       batched_faces="off")),
             ("fused", chip_smoke.main_path_config(16, "float32", mega="off",
                                                   fused_tail="on"))]
    run = start_function("chip_smoke:split_stage_ranks", (2, 2), "gloo", device="cpu",
                         kwargs=dict(cases=cases), pythonpath=[TESTS.parent])
    rows = run.result(RANK_TIMEOUT)[0]
    for name, fns in rows.items():
        compared = [r for r in fns if r["compared"]]
        assert len(compared) >= 40 and len(compared) >= len(fns) - 2, (name, len(fns))
        assert all(r["calls_block"] == r["calls_serial"] for r in fns), name
        differ = [(r["function"], r["err"]) for r in compared if not r["bitwise"]]
        assert not differ, (name, differ)
