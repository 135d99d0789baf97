"""The rank side of the decomposition tests (tests/test_torch_decomp*.py): the
functions that each rank of a decomposed run calls (through
hnumo_tpu_torch.parallel.launch.start_function). They import torch and the
port only, and return numpy arrays.

No test cases here: pytest does not collect this file.
"""
import numpy as np
import torch

from hnumo_tpu_torch.config import Config
from hnumo_tpu_torch.core import btp
from hnumo_tpu_torch.core import faces as tf
from hnumo_tpu_torch.model import Model
from hnumo_tpu_torch.ops import btp_tail, btp_volume, btp_volume_uni, mega

# the grid of tests/test_sharding.py
BUMP = dict(nelx=8, nely=8, nopx=3, nopy=3, xdims=(0.0, 2e3), ydims=(0.0, 2e3),
            nlayers=2, dt=20.0, dt_btp=2.0, time_final=300.0, test_case="bump",
            dtype="float64")
FIELDS = ("qb_df", "q_df", "qprime_df")

# faces test: element grid, nodes per edge, channels
FACE_GRID = dict(nely=4, nelx=6, m=4, C=4)


def bump_config(**over) -> Config:
    return Config(**{**BUMP, **over})


# ---- face functions --------------------------------------------------------

def face_inputs(seed: int, py: int, px: int):
    """The whole grid's random inputs of the face functions, numpy from a
    seed: element fields (C, ney, nex, m, m) and face values in the blocked
    layout of `blockify_tables` (x-faces (C, ney, px*(lx+1), m), y-faces
    (C, py*(ly+1), nex, m)), where each block's faces are its own entries."""
    ney, nex, m, C = (FACE_GRID[k] for k in ("nely", "nelx", "m", "C"))
    rng = np.random.default_rng(seed)
    lx, ly = nex // px, ney // py
    return dict(
        q=rng.normal(size=(C, ney, nex, m, m)),
        q8=rng.normal(size=(2 * C, ney, nex, m, m)),
        Sx=rng.normal(size=(3, ney, px * (lx + 1), m)),
        Srx=rng.normal(size=(3, ney, px * (lx + 1), m)),
        Sy=rng.normal(size=(3, py * (ly + 1), nex, m)),
        Sry=rng.normal(size=(3, py * (ly + 1), nex, m)),
        rhs=rng.normal(size=(3, ney, nex, m, m)),
        qu=rng.normal(size=(2, ney, nex, m, m)),
        qv=rng.normal(size=(2, ney, nex, m, m)),
    )


def face_functions(bc, q, q8, Sx, Srx, Sy, Sry, rhs, qu, qv, xp):
    """Every face function of core/faces on one block, in a fixed order, as
    a dict; `xp` is the package's faces module (the port's or the JAX
    package's), the arrays its own. Shared by both sides of the test."""
    out = {}
    for k, v in zip(("xl", "xr", "yl", "yr"),
                    xp.extract_faces_stacked(q, bc, vec_pairs=((2, 3),))):
        out[f"stacked.{k}"] = v
    slabs = (q8[..., :, -1], q8[..., :, 0], q8[..., -1, :], q8[..., 0, :])
    for k, v in zip(("xl", "xr", "yl", "yr"),
                    xp.extract_faces_from_slabs(*slabs, bc,
                                                vec_pairs=((2, 3), (4, 5), (6, 7)))):
        out[f"slabs.{k}"] = v
    out["views_x.w"], out["views_x.e"] = xp.face_views_x(Sx, bc)
    out["views_y.s"], out["views_y.n"] = xp.face_views_y(Sy, bc)
    out["scatter_x"] = xp.scatter_face_x(rhs, Sx, bc)
    out["scatter_x.right"] = xp.scatter_face_x(rhs, Sx, bc, S_right=Srx)
    out["scatter_y"] = xp.scatter_face_y(rhs, Sy, bc)
    out["scatter_y.right"] = xp.scatter_face_y(rhs, Sy, bc, S_right=Sry)
    out["wall.u"], out["wall.v"] = xp.apply_wall_projection(qu, qv, bc)
    return out


def _block(a, ys, xs, axes):
    idx = [slice(None)] * a.ndim
    idx[axes[0]], idx[axes[1]] = ys, xs
    return np.array(a[tuple(idx)])


def faces_ranks(dec, seed, cases):
    """Each case (codes,) of face_functions on this rank's block of
    face_inputs(seed); returns {codes: {name: array}} and the exchange calls
    per case."""
    (py, px), (iy, ix) = dec.shape, dec.coords
    ney, nex, m = FACE_GRID["nely"], FACE_GRID["nelx"], FACE_GRID["m"]
    ly, lx = ney // py, nex // px
    ys, xs = slice(iy * ly, (iy + 1) * ly), slice(ix * lx, (ix + 1) * lx)
    xsf = slice(ix * (lx + 1), (ix + 1) * (lx + 1))
    ysf = slice(iy * (ly + 1), (iy + 1) * (ly + 1))
    g = face_inputs(seed, py, px)
    loc = {k: torch.tensor(_block(v, ys, xs, (1, 2))) for k, v in g.items()
           if k in ("q", "q8", "rhs", "qu", "qv")}
    loc.update(Sx=torch.tensor(_block(g["Sx"], ys, xsf, (1, 2))),
               Srx=torch.tensor(_block(g["Srx"], ys, xsf, (1, 2))),
               Sy=torch.tensor(_block(g["Sy"], ysf, xs, (1, 2))),
               Sry=torch.tensor(_block(g["Sry"], ysf, xs, (1, 2))))
    out = {}
    for codes in cases:
        bc = tf.BCs(*codes, *dec.axes(codes[0] == 3, codes[2] == 3))
        before = dec.exchange_calls
        res = {k: v.numpy() for k, v in face_functions(bc, xp=tf, **loc).items()}
        mu, mv = tf.wall_projection_masks((ly, lx, m, m), bc, torch.float64, "cpu")
        res["masks.u"], res["masks.v"] = mu.numpy(), mv.numpy()
        res["calls"] = dec.exchange_calls - before
        out[tuple(codes)] = res
    return out


# ---- whole steps -----------------------------------------------------------

_COUNTERS = {"volume": btp_volume.btp_volume_plain,
             "volume_uni": btp_volume_uni.btp_volume_uni_plain,
             "faces": btp_tail.btp_faces_plain, "update": btp_tail.btp_update_plain,
             "mega": mega.barotropic_solve_mega_plain}


def _mass(P_ref_dp, wjac, q):
    return ((wjac[None] * (P_ref_dp + q[0])).sum(axis=(1, 2, 3, 4)))


def steps_ranks(dec, cases):
    """For each case (name, config overrides, steps): the decomposed model's
    run from its initial state; returns, per case, the gathered fields and
    mass (rank 0; None elsewhere) and this rank's counters: exchange calls,
    plain-version calls per barotropic stage, the per-stage face pipeline
    calls, the path flags of its StaticConfig, its block's shape."""
    out = {}
    for name, over, nsteps in cases:
        m = Model(bump_config(**over), device="cpu", decomp=dec)
        seen = {"flat": 0, "per_dir": 0}
        flat, per_dir = btp._btp_faces_visc_flat, btp._btp_faces_visc

        def count(fn, key):
            def wrapper(*a, **k):
                seen[key] += 1
                return fn(*a, **k)
            return wrapper
        btp._btp_faces_visc_flat = count(flat, "flat")
        btp._btp_faces_visc = count(per_dir, "per_dir")
        before = {k: f.calls for k, f in _COUNTERS.items()}
        calls0 = dec.exchange_calls
        try:
            s = m.run(m.state0, nsteps)
        finally:
            btp._btp_faces_visc_flat, btp._btp_faces_visc = flat, per_dir
        st = m.static
        res = dict(
            exchange_calls=dec.exchange_calls - calls0,
            calls={k: f.calls - before[k] for k, f in _COUNTERS.items()},
            face_pipeline=seen, block=tuple(m.g.wjac.shape[:2]),
            path=dict(mega=st.mega, fused=st.fused_tail, batched=st.batched_faces),
            nsub=2 * nsteps * st.n_btp * st.kstages,
            ok=bool(s.ok))
        whole = m.gather(s)
        init = m.gather(m.state0)
        if whole is not None:
            ref = m.init_fields.qprime_df[0]
            wj = m.global_table("wjac_df").numpy()
            res.update({f: getattr(whole, f).numpy() for f in FIELDS})
            res["mass0"] = _mass(ref, wj, init.q_df.numpy())
            res["mass"] = _mass(ref, wj, whole.q_df.numpy())
            res["t"] = float(whole.t)
        out[name] = res
    return out


HOST_READS = ("__bool__", "item", "tolist", "__float__", "__int__", "numpy", "cpu")


def _refuse_host_reads():
    """Patch every Tensor method of HOST_READS (tests/test_torch_graph.py's
    list) to raise; returns what undoes it."""
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}
    for name in HOST_READS:
        def refuse(*args, _name=name, **kw):
            raise AssertionError(f"Tensor.{_name} called inside the step")
        setattr(torch.Tensor, name, refuse)

    def undo():
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
    return undo


def plan_ranks(dec, cases):
    """For each case (name, config overrides): the decomposed model's first
    two steps, each with its exchange plan recorded (Decomposition.plan),
    the second with every host read patched to raise (what a CUDA graph's
    capture forbids), then the second again unpatched. Returns per case the
    two plans (tuples of Exchange's fields), whether the patched and the
    unpatched second step agree bitwise, the model's step_impl, and the
    exchange calls of the two steps."""
    out = {}
    for name, over in cases:
        m = Model(bump_config(**over), device="cpu", decomp=dec)
        calls0 = dec.exchange_calls
        dec.plan = []
        s1 = m.step(m.state0)
        plan1, dec.plan = dec.plan, []
        undo = _refuse_host_reads()
        try:
            try:
                bool(torch.tensor(True))
                patched = False
            except AssertionError:
                patched = True
            s2 = m.step(s1)
        finally:
            undo()
        plan2, dec.plan = dec.plan, None
        calls = dec.exchange_calls - calls0
        again = m.step(s1)
        out[name] = dict(
            plans=[[tuple(e) for e in p] for p in (plan1, plan2)],
            posting=[sum(e.posts for e in p) for p in (plan1, plan2)],
            same=all(torch.equal(getattr(s2, f), getattr(again, f)) for f in FIELDS),
            patched=patched,
            ok=bool(s2.ok), step_impl=m.step_impl, calls=calls, mega=m.static.mega,
            fused=m.static.fused_tail)
    return out


def mass_ranks(dec, cases):
    """For each case (name, config overrides, whole-grid numpy inputs of
    tests/test_torch_bcl_mass.mass_inputs): this rank's block of the inputs
    through core/stepper._thickness_update on the decomposed model; returns,
    per case, the new q_df of the block, the block's bounds, the plain
    version's calls with the `ok` each returned (the block's own), the
    and-reduced `ok`, and the halo exchanges the update made."""
    from hnumo_tpu_torch.core import stepper
    from hnumo_tpu_torch.core.bcl import extract_qprime_faces
    from hnumo_tpu_torch.core.types import BtpAverages, BtpFaceAvg, Pair

    out = {}
    for name, over, (q_df, qp, avg, faces) in cases:
        m = Model(bump_config(**over), device="cpu", decomp=dec)
        (y0, y1), (x0, x1) = bounds = dec.bounds(m.cfg.nely, m.cfg.nelx)
        cut = {"e": lambda a: a[..., y0:y1, x0:x1, :, :],
               "x": lambda a: a[..., y0:y1, x0:x1 + 1, :],
               "y": lambda a: a[..., y0:y1 + 1, x0:x1, :]}

        def t(a, part):
            return torch.tensor(np.ascontiguousarray(cut[part](a)), dtype=torch.float64)

        zero = torch.zeros(())

        def face(d):
            return BtpFaceAvg(**{f: t(faces[d][f], d) if f in faces[d] else zero
                                 for f in BtpFaceAvg._fields})

        a = BtpAverages(**{f: t(avg[f], "e") if f in avg else zero
                           for f in BtpAverages._fields if f != "faces"},
                        faces=Pair(face("x"), face("y")))
        qpt = t(qp, "e")
        qpf = extract_qprime_faces(m.bc, qpt)
        plain, local = stepper.bcl_mass_plain, []

        def spy(*ops):
            q, ok = plain(*ops)
            local.append(bool(ok))
            return q, ok

        stepper.bcl_mass_plain = spy
        calls0 = dec.exchange_calls
        try:
            q, ok = stepper._thickness_update(m.static, m.P, m.g, m.bc, a, t(q_df, "e"), qpt,
                                              qpf)
        finally:
            stepper.bcl_mass_plain = plain
        out[name] = dict(q=q.numpy(), bounds=bounds, calls=len(local), local_ok=local[0],
                         ok=bool(ok), exchanges=dec.exchange_calls - calls0)
    return out


def run_jobs(dec, jobs):
    """Several of the functions above in one set of ranks: `jobs` is a list
    of (key, function name, kwargs); returns {key: result}."""
    return {key: globals()[name](dec, **kw) for key, name, kw in jobs}


# ---- the launcher's failure paths --------------------------------------------

def fail_on_rank_one(dec):
    """Rank 1 raises; the others wait for it in a collective."""
    if dec.rank == 1:
        raise ValueError("rank one fails on purpose")
    dec.barrier()


def fail_with_a_slow_exit_on_rank_one(dec):
    """Rank 1 raises, and its interpreter's exit would then take an hour, as
    an NCCL group's teardown can while the peers wait in a collective; the
    others wait for it in a collective."""
    import atexit
    import time

    if dec.rank == 1:
        atexit.register(time.sleep, 3600)
        raise ValueError("rank one fails on purpose")
    dec.barrier()


def hang_on_rank_one(dec):
    """Rank 1 never reaches the collective the others wait in."""
    import time

    if dec.rank == 1:
        time.sleep(3600)
    dec.barrier()


def late_join_on_rank_one(delay: float):
    """A rank's whole program, run through `launch.run_command`: rank 1
    sleeps `delay` seconds before it joins the group (a slow start), then
    every rank meets the others in a collective and leaves."""
    import os
    import time

    import torch.distributed as dist

    from hnumo_tpu_torch.parallel.sharding import init_decomposition

    if os.environ["RANK"] == "1":
        time.sleep(delay)
    dec = init_decomposition((1, 2), backend="gloo", device="cpu")
    dec.barrier()
    dist.destroy_process_group()


# ---- checkpoints across decompositions ----------------------------------------

def checkpoint_ranks(dec, over, runs):
    """Each run (load, nsteps, save, itime): from the npz checkpoint `load`
    (the initial state when None), `nsteps` steps, saved to `save` (gathered;
    rank 0 writes)."""
    from hnumo_tpu_torch.io import snapshots as snap

    m = Model(bump_config(**over), device="cpu", decomp=dec)
    for load, nsteps, save, itime in runs:
        s = m.state0 if load is None else snap.load_checkpoint(load, m)[0]
        s = m.run(s, nsteps)
        snap.save_checkpoint(save, s, itime, model=m)


def jax_tables_ranks(dec, over, nsteps, P_np, g_np, state_np):
    """The decomposed model stepping on the JAX package's tables and initial
    state (convert.block_from_numpy); the gathered fields on rank 0."""
    from hnumo_tpu_torch.convert import block_from_numpy

    P, g, s0 = block_from_numpy(P_np, g_np, state_np, dec, "cpu", torch.float64)
    m = Model.from_tables(bump_config(**over), P, g, s0, device="cpu", decomp=dec)
    whole = m.gather(m.run(m.state0, nsteps))
    return None if whole is None else {f: getattr(whole, f).numpy() for f in FIELDS}
