"""Domain decomposition in the port, function by function, against the JAX
package's shard_map (hnumo_tpu/parallel/sharding.py, hnumo_tpu/core/faces.py):

- `local_tables` on every rank of a (2, 2) and a (1, 4) split equals, bitwise,
  the shard's slice of the JAX package's `blockify_tables` + `table_specs`,
  on the same tables (and by field name where a shape test is ambiguous);
- every face function of core/faces on each rank, with its halos exchanged
  over gloo between spawned ranks, equals bitwise the JAX function under
  shard_map on the 8 fake CPU devices of conftest.py, on the same random
  inputs (numpy, from a seed): walls (2, 0) in x and (4, 4) in y, periodic
  in x with px = 2 and px = 1, periodic in y;
- the port's exchange calls per step equal the `ppermute`s in the JAX
  package's sharded step (its jaxpr), on the per-stage and the fused path.

The ranks (tests/torch_decomp_ranks.py) are spawned once per split for the
whole module and joined with a time limit; the tests read what they saved.
"""
import dataclasses
import pathlib

import jax
import jax.extend.core as jcore
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_decomp_ranks as R
from hnumo_tpu.config import Config as JaxConfig
from hnumo_tpu.core import faces as jf
from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu.parallel.sharding import blockify_tables, make_mesh, table_specs
from hnumo_tpu_torch.config import Config as TorchConfig
from hnumo_tpu_torch.core.init import static_for_blocks
from hnumo_tpu_torch.model import Model as TorchModel
from hnumo_tpu_torch.parallel.launch import run_command, run_function, start_function
from hnumo_tpu_torch.parallel.sharding import (Decomposition, block_bounds,
                                               init_decomposition, local_state,
                                               local_tables)
from test_torch_common import leaves, to_np

TESTS = pathlib.Path(__file__).resolve().parent
SEED = 20261017
FACE_SHAPES = [(2, 2), (2, 1)]
FACE_CASES = [(2, 0, 4, 4),      # no-slip west, copy east: walls show signs
              (3, 3, 4, 4),      # periodic x (wrapped across blocks when px > 1)
              (0, 4, 3, 3)]      # periodic y
# the per-stage and the fused path, with viscosity: 8 and 4 exchanges a stage
COUNT_CASES = {
    "per_stage": dict(x_boundary=(2, 0), method_visc=2, visc_mlswe=10.0, mega="off"),
    "fused": dict(x_boundary=(2, 0), method_visc=2, visc_mlswe=10.0, mega="off",
                  fused_tail="on"),
}
RANK_TIMEOUT = 240.0
FACE_OUTPUTS = ("stacked.xl", "stacked.xr", "stacked.yl", "stacked.yr", "slabs.xl",
                "slabs.xr", "slabs.yl", "slabs.yr", "views_x.w", "views_x.e",
                "views_y.s", "views_y.n", "scatter_x", "scatter_x.right", "scatter_y",
                "scatter_y.right", "wall.u", "wall.v", "masks.u", "masks.v")


@pytest.fixture(scope="module")
def ranks():
    """One run of spawned gloo ranks per split, for every case of the
    module: started together, then the JAX side is computed while they run."""
    jobs = {
        (2, 2): [("faces", "faces_ranks", dict(seed=SEED, cases=FACE_CASES)),
                 ("steps", "steps_ranks", dict(cases=[(k, v, 1) for k, v in
                                                      COUNT_CASES.items()]))],
        (2, 1): [("faces", "faces_ranks", dict(seed=SEED, cases=FACE_CASES))],
    }
    runs = {shape: start_function("torch_decomp_ranks:run_jobs", shape, "gloo",
                                  device="cpu", kwargs=dict(jobs=j), pythonpath=[TESTS])
            for shape, j in jobs.items()}
    jax_side = {"faces": {shape: _jax_faces(shape) for shape in FACE_SHAPES},
                "ppermutes": {k: _jax_ppermutes(v) for k, v in COUNT_CASES.items()}}
    return {shape: r.result(RANK_TIMEOUT) for shape, r in runs.items()}, jax_side


# ---- local tables ------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tables():
    jm = JaxModel(JaxConfig(**R.BUMP))
    return jm, to_np(jm.g), to_np(jm.P)


def _jax_shard(a, spec, shape, block):
    """The slice of `a` (blocked layout) that shard `block` holds under `spec`."""
    (py, px), (iy, ix) = shape, block
    idx = []
    for n, s in zip(a.shape, tuple(spec) + (None,) * (a.ndim - len(tuple(spec)))):
        parts, i = {"y": (py, iy), "x": (px, ix), None: (1, 0)}[s]
        idx.append(slice(i * (n // parts), (i + 1) * (n // parts)))
    return a[tuple(idx)]


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=str)
def test_local_tables_are_the_jax_shard_slices(shape, jax_tables):
    """Every field of DeviceGeom and Precomputed on every rank, bitwise."""
    jm, g, Pj = jax_tables
    py, px = shape
    cfg = jm.cfg
    gb, Pb = blockify_tables(g, Pj, px, py)
    gs = table_specs(gb, cfg.nely, cfg.nelx, px, py)
    ps = table_specs(Pb, cfg.nely, cfg.nelx, px, py)
    specs = jax.tree.leaves((gs, ps), is_leaf=lambda x: isinstance(x, P))
    blocked = list(leaves((gb, Pb)))
    assert len(specs) == len(blocked)
    for iy in range(py):
        for ix in range(px):
            gl, Pl = local_tables(g, Pj, (shape, (iy, ix)))
            ported = list(leaves((gl, Pl)))
            assert [n for n, _ in ported] == [n for n, _ in blocked]
            for (name, got), (_, a), spec in zip(ported, blocked, specs):
                want = _jax_shard(np.asarray(a), spec, shape, (iy, ix))
                assert got.shape == want.shape and np.array_equal(got, want), (
                    shape, (iy, ix), name)


def test_local_tables_go_by_field_name_where_shapes_coincide():
    """nlayers == nely == nelx (2): a shape test cannot tell the layer axis
    from the element rows; the blocks are cut by field name."""
    m = TorchModel(TorchConfig(**{**R.BUMP, "nelx": 2, "nely": 2}), device="cpu")
    g, Pt = m.g, m.P
    assert g.wjac.shape[:2] == (2, 2) and Pt.dpp_ref_df.shape[:3] == (2, 2, 2)
    for iy in range(2):
        for ix in range(2):
            gl, Pl = local_tables(g, Pt, ((2, 2), (iy, ix)))
            assert torch.equal(Pl.dpp_ref_df, Pt.dpp_ref_df[:, iy:iy + 1, ix:ix + 1])
            assert torch.equal(Pl.gz_ref, Pt.gz_ref[..., iy:iy + 1, ix:ix + 1, :, :])
            assert torch.equal(Pl.faces.x.dpp_ref_face,
                               Pt.faces.x.dpp_ref_face[:, iy:iy + 1, ix:ix + 2])
            assert torch.equal(Pl.faces.y.Hk_ref_edge,
                               Pt.faces.y.Hk_ref_edge[:, iy:iy + 2, ix:ix + 1])
            assert torch.equal(gl.nx_y, g.nx_y[iy:iy + 2, ix:ix + 1])
            assert torch.equal(Pl.alpha, Pt.alpha) and torch.equal(gl.psiq, g.psiq)
            st = local_state(m.state0, ((2, 2), (iy, ix)))
            assert torch.equal(st.q_df, m.state0.q_df[:, :, iy:iy + 1, ix:ix + 1])
            assert st.q_df.is_contiguous()


def test_blocks_must_divide_the_grid():
    assert block_bounds(8, 4, 3) == (6, 8)
    with pytest.raises(ValueError, match="equal blocks"):
        block_bounds(10, 4, 0)
    dec = Decomposition(shape=(1, 3), rank=0, backend="gloo", transport="gloo",
                        device=torch.device("cpu"))
    with pytest.raises(ValueError, match="equal blocks"):
        TorchModel(TorchConfig(**R.BUMP), device="cpu", decomp=dec)


# ---- the face functions --------------------------------------------------------

def _jax_faces(shape):
    """face_functions of the JAX package under shard_map on a (py, px) mesh,
    for every case; outputs in the blocked global layout."""
    py, px = shape
    mesh = make_mesh(jax.devices()[:py * px], shape=shape)
    inputs = {k: jnp.asarray(v) for k, v in R.face_inputs(SEED, py, px).items()}
    names = list(inputs)
    el, fs = P(None, "y", "x", None, None), P(None, "y", "x", None)
    in_specs = tuple(fs if k.startswith("S") else el for k in names)
    ney, nex, m = R.FACE_GRID["nely"], R.FACE_GRID["nelx"], R.FACE_GRID["m"]
    out = {}
    for codes in FACE_CASES:
        bc = jf.BCs(*codes, ax="x", ay="y")

        def local(*arrays):
            res = R.face_functions(bc, xp=jf, **dict(zip(names, arrays)))
            mu, mv = jf.wall_projection_masks((ney // py, nex // px, m, m), bc, jnp.float64)
            res["masks.u"], res["masks.v"] = mu[None], mv[None]
            return res

        # traces and edge views (C, ly, lx(+1), m); fields (C, ly, lx, m, m)
        out_specs = {k: (fs if k.startswith(("stacked", "slabs", "views")) else el)
                     for k in FACE_OUTPUTS}
        fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                                   check_vma=False))
        out[codes] = {k: np.asarray(v) for k, v in fn(*inputs.values()).items()}
    return out


@pytest.mark.parametrize("codes", FACE_CASES, ids=lambda c: "bc" + "".join(map(str, c)))
@pytest.mark.parametrize("shape", FACE_SHAPES, ids=str)
def test_face_functions_match_jax_under_shard_map(ranks, shape, codes):
    """Every output of every face function on every rank is the JAX shard's
    block, bitwise; four exchange calls per trace extraction (two per axis
    of more than one block, none on an axis of one block)."""
    port, jax_side = ranks
    want = jax_side["faces"][shape][codes]
    py, px = shape
    for rank, res in enumerate(port[shape]):
        got = res["faces"][codes]
        block = divmod(rank, px)
        for name, w in want.items():
            g = got[name] if not name.startswith("masks") else got[name][None]
            ws = _jax_shard(w, (None, "y", "x"), shape, block)
            assert g.shape == ws.shape and np.array_equal(g, ws), (shape, codes, rank, name)
        # extract_faces_stacked and extract_faces_from_slabs: 2 per split axis
        assert got["calls"] == 2 * 2 * ((px > 1) + (py > 1))


@pytest.mark.parametrize("shape", FACE_SHAPES, ids=str)
def test_wall_masks_are_ones_away_from_the_domain_edge(ranks, shape):
    """A block that owns no wall has no zero in its masks (kernel U's
    operands): a mask built from the whole grid's codes would zero its
    edges, inside the domain."""
    port, _ = ranks
    py, px = shape
    for rank, res in enumerate(port[shape]):
        iy, ix = divmod(rank, px)
        got = res["faces"][(2, 0, 4, 4)]
        mu, mv = got["masks.u"], got["masks.v"]
        west, south, north = ix == 0, iy == 0, iy == py - 1
        # no-slip west zeroes both components on its edge nodes; copy east none
        assert (mu[:, 0, :, 0] == 0).all() == west and (mv[:, 0, :, 0] == 0).all() == west
        assert (mu[:, -1, :, -1] != 0).all() or ix != px - 1
        # free-slip south/north zero v only
        assert (mv[0, :, 0, :] == 0).all() == south and (mv[-1, :, -1, :] == 0).all() == north
        interior = mu[1:-1, 1:-1] if mu.shape[0] > 2 else mu[:, 1:-1]
        assert (interior[..., 1:-1, 1:-1] == 1).all()


# ---- exchanges per step ------------------------------------------------------------

def _subjaxprs(eqn):
    for v in eqn.params.values():
        for x in (v if isinstance(v, (tuple, list)) else [v]):
            if isinstance(x, jcore.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jcore.Jaxpr):
                yield x


def _count(jaxpr, name="ppermute"):
    """`name` primitives executed by one evaluation of `jaxpr`: a scan's body
    counts `length` times; no loop of unknown trip count may hold one."""
    n = 0
    for eqn in jaxpr.eqns:
        n += eqn.primitive.name == name
        subs = list(_subjaxprs(eqn))
        if eqn.primitive.name in ("while", "cond"):
            assert all(_count(j, name) == 0 for j in subs), eqn.primitive.name
            continue
        mult = eqn.params["length"] if eqn.primitive.name == "scan" else 1
        n += mult * sum(_count(j, name) for j in subs)
    return n


def _jax_ppermutes(over):
    """ppermutes in one step of the JAX package's model on a (2, 2) mesh,
    stages unrolled (scan_stages="off"); the fused path with its Pallas
    kernels (interpret mode on the CPU)."""
    over = dict(over)
    if over.get("fused_tail") == "on":
        over["use_pallas"] = "on"
    jm = JaxModel(JaxConfig(**{**R.BUMP, **over, "scan_stages": "off"}),
                  mesh=make_mesh(jax.devices()[:4], shape=(2, 2)))
    assert jm.static.fused_tail == (over.get("fused_tail") == "on")
    return _count(jax.make_jaxpr(jm._step)(jm.state0).jaxpr), jm.static


@pytest.mark.parametrize("path", COUNT_CASES)
def test_exchange_calls_per_step_equal_jax_ppermutes(ranks, path):
    """Calls of _from_prev/_from_next in one step on each rank of the (2, 2)
    split = ppermutes in the JAX package's sharded step (docs/parallelism.md:
    8 a stage on the per-stage path, 4 on the fused one)."""
    port, jax_side = ranks
    n_jax, jstatic = jax_side["ppermutes"][path]
    per_stage = 8 if path == "per_stage" else 4
    stages = 2 * jstatic.n_btp * jstatic.kstages
    for res in port[(2, 2)]:
        got = res["steps"][path]
        assert got["exchange_calls"] == n_jax, (path, got["exchange_calls"], n_jax)
        assert got["path"]["fused"] == (path == "fused") and not got["path"]["mega"]
        assert got["path"]["batched"] == jstatic.batched_faces_on or path == "fused"
    # the barotropic stages carry per_stage exchanges each; the rest is the
    # baroclinic part's
    assert (n_jax - per_stage * stages) == _baroclinic_ppermutes(jax_side)


def _baroclinic_ppermutes(jax_side):
    """Exchanges of one step outside the barotropic solves: the same on both
    paths."""
    counts = {p: n - (8 if p == "per_stage" else 4) * 2 * s.n_btp * s.kstages
              for p, (n, s) in jax_side["ppermutes"].items()}
    assert len(set(counts.values())) == 1, counts
    return counts["per_stage"]


# ---- the pieces without a group ---------------------------------------------------

def test_static_for_blocks_resolves_batched_faces_per_block():
    """batched_faces="auto" is resolved on one block's elements (the JAX
    package under a mesh, hnumo_tpu/model.py:134-146), and the megakernel is
    off under any split, "on" included."""
    from hnumo_tpu_torch.core.init import StaticConfig

    st = StaticConfig(nlayers=2, kstages=5, n_btp=20, dt=1.0, dt_btp=0.05,
                      gravity=9.8, botfr=1, cd_mlswe=0.0, method_visc=2,
                      visc_mlswe=1.0, ad_mlswe=0.0, max_shear_dz=1.0,
                      alpha_bot=1e-3, Pstress=1.0, Pbstress=1.0, uniform_geom=True,
                      mega_on=True, batched_faces_on=False)
    big = TorchConfig(nelx=128, nely=128, batched_faces="auto")
    assert static_for_blocks(st, big, 4).batched_faces_on        # 4096 a block
    assert not static_for_blocks(st, big, 1).batched_faces_on    # 16384
    assert not static_for_blocks(st, dataclasses.replace(big, nelx=256, nely=256),
                                 4).batched_faces_on     # 16384 a block
    off = dataclasses.replace(big, batched_faces="off")
    assert not static_for_blocks(st, off, 4).batched_faces_on
    on = dataclasses.replace(big, batched_faces="on")
    assert static_for_blocks(dataclasses.replace(st, batched_faces_on=True), on,
                             1).batched_faces_on
    assert not static_for_blocks(st, big, 4).mega


def test_graph_step_is_refused_under_a_decomposition():
    """Over gloo on the CPU the graph is refused as on one CPU device (over
    NCCL it is the default: tests/test_torch_decomp_graph.py)."""
    dec = Decomposition(shape=(1, 2), rank=0, backend="gloo", transport="gloo",
                        device=torch.device("cpu"))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        TorchModel(TorchConfig(**R.BUMP), device="cpu", step_impl="graph", decomp=dec)


@pytest.mark.parametrize("backend,device,exc,match", [
    ("mpi", "cpu", ValueError, "backend"),
    ("nccl", "cpu", ValueError, "NCCL"),
    (None, None, RuntimeError, "CUDA"),
])
def test_init_decomposition_refuses_what_no_transport_serves(monkeypatch, backend,
                                                             device, exc, match):
    if device is None and torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(exc, match=match):
        init_decomposition((1, 1), backend=backend, device=device)
    with pytest.raises(ValueError, match="ranks"):
        init_decomposition((2, 2), backend="gloo", device="cpu")


@pytest.mark.parametrize("target,exc,match", [
    ("fail_on_rank_one", RuntimeError, "rank one fails on purpose"),
    # a failed rank leaves at once, whatever its exit would run: it fails the
    # run, not the time limit
    ("fail_with_a_slow_exit_on_rank_one", RuntimeError, "rank one fails on purpose"),
    ("hang_on_rank_one", TimeoutError, "still running"),
])
def test_a_failed_or_hung_rank_fails_the_run(target, exc, match):
    """The launcher kills the other ranks and raises: a failed rank or a hung
    one never passes, and never outlasts its time limit."""
    with pytest.raises(exc, match=match):
        run_function(f"torch_decomp_ranks:{target}", (1, 2), "gloo", device="cpu",
                     timeout=10.0, pythonpath=[TESTS])


def test_the_time_limit_starts_once_every_rank_has_joined(monkeypatch):
    """A rank that is slow to start (here: rank 1 sleeps 12 s before it joins
    the group) does not eat the run's time limit of 10 s: the limit counts
    from the moment every rank has joined (`launch.STARTUP_TIMEOUT` bounds
    the start), so the run completes."""
    monkeypatch.setenv("PYTHONPATH", str(TESTS))
    logs = run_command(["-c", "import torch_decomp_ranks as R; R.late_join_on_rank_one(12.0)"],
                       2, timeout=10.0)
    assert "decomposition 1x2: 2 ranks, backend gloo" in logs[0]
