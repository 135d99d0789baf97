"""Smoke run of the PyTorch/CUDA port (hnumo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # everything; needs one CUDA device + nvcc
    python3 chip_smoke.py --profile [FILE]  # also torch.profiler tables (default
                                            # chiprun_out/chip_smoke_profile.txt)
    python3 chip_smoke.py --log FILE  # the whole output (default chiprun_out/chip_smoke.log)
    python3 chip_smoke.py --decomposition-only  # phases 1-2 and 27-27d only

Builds the five CUDA kernels from the sources in this checkout (and, to be
timed only, two ablated variants of each of the four streaming kernels: the
two volume kernels, the face kernel and the update kernel, and four of the
megakernel), holds each against its plain PyTorch version on the card (the
megakernel on both of its routes), and drives the port's main
paths through `Model.run` on the double-gyre configuration (f32, p=4,
2 layers, SSP(5,3), N_btp=20): 32x32 elements through the whole-solve
megakernel (two launches per step, its resident route), 64x64 and a short run at 256x256
through the per-stage path with the volume kernel (at 256x256, above 8192
elements, with the per-direction face pipeline that `batched_faces="auto"`
chooses there), and the same two grids
through the fused path (`mega="off", fused_tail="on"`: the uniform-geometry
volume kernel, the all-faces kernel and the update kernel, 200 launches of
each per step). `Model` steps through a captured CUDA graph by default: the
wrappers' launch counters move in a model's first step only (eager warm-up
and capture), so a `torch.profiler` trace of one replayed step counts the
kernels the replays run. Then the graphed step against the eager one,
bitwise, on the three paths (and a step of each under the sync debug
mode), the frozen f64 trajectories and the 108-step CI bump on the graphed
step, the f32 double-gyre campaign's first 2 model days against the f64
band, and eager against graphed ms/step in turns. Then the run layer: the
32x32 configuration written as a namelist and run through the CLI
(`hnumo_tpu_torch.driver.main`, snapshots, FIN file), restarted from a
snapshot and held against the straight run, in f32 and f64; and a deformed
32x32 grid read from an MSH file with its $BC and $Bathy sections, whose
metric varies from node to node, stepped through the general volume kernel
(200 launches per step), which is held against its plain version on that
metric. Then the options off the main path, each at the full width of the
double gyre, graphed, with its launches counted in a replay's trace, its
kernels held against their plain versions on the operands of that path,
and f64 steps at 12x12 or 6x5 against another path: the quad-family LDG
viscosity (method_visc=1) at 64x64, which takes kernel 1 and the
per-direction faces (phase 22); the two face pipelines of the per-stage
path at 128x128 timed in turns (23); LSRK with 5 and 14 stages at 64x64,
and lsrk_ref through the fused path at 32x32 (24); periodic boundaries at
64x64 through the fused and the per-stage path, and at 32x32 off the
megakernel (25); the vertical shear stress through the megakernel and
quadratic bottom drag (botfr=2) through the megakernel and the fused path
(26). Then the domain decomposition (27): the 128x128 f32 configuration and
a 32x32 f64 one with a no-slip and a copy wall, each split 2x2 over four
ranks that share the card over gloo (halos staged through host memory),
eager, on the per-stage and the fused path, against the serial model, with
every rank's launches counted; over NCCL with a GPU per rank where the
machine has two or more (27b; otherwise a line says it was not run), eager
and graphed: the graphed split step bitwise the eager one on every rank,
its replay's kernels and NCCL launches counted in a trace, ms/step in
turns; the capture of the split step on one GPU (27c): a one-rank NCCL
group whose axes exchange with the rank itself replays rank 0's exchange
plans of phase 27 and the `ok` all-reduce as one CUDA graph (received
bitwise what was sent, the all-reduce right, one NCCL launch per call), and
a doubly periodic 64x64 model on those axes graphed against eager and
serial; the double gyre at 256x256 split 2x2 over NCCL, eager and graphed
beside the serial model, where the machine has four GPUs (27d); and
the native C++ mesh front end (28): phase 21's MSH file read through it,
its geometry bitwise the Python path's, and the CLI decomposed 2x2 against
the serial CLI. Last the flat unstructured faces (29): mesh/flatfaces.py's
tables of the 256x256 brick, its traces and scatter on the card in f32 and
f64 against the CPU and against the structured path's traces, the adjoint
identity, and the geometry of the pinwheel and of a deformed 256x256 brick.
Then the bench tool (30): hnumo_tpu_torch/tools/bench.py's graphed runs in
turns, 32x32 p=4 on each of its paths and 16x16 p=8 per stage, uniform
volume and fused, each held to its gates and its captured graph's kernels.
Any failure raises and the run exits non-zero; there is no CPU path.

Output: one line per phase, then a `{"kernels": [...], "flatfaces_256": {...}}`
line (five kernels; each entry that a phase from 22 on launched carries that
phase's readings under a key of its own, phase 30's under "bench_30";
phase 29's readings beside them:
the flat faces are library calls, no kernel), the card's name and power
limit, and as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Everything written to standard output and standard error also goes, line
by line, to `--log` (default chiprun_out/chip_smoke.log), so a long or
failing run keeps every line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from hnumo_tpu_torch.tools._measure import (
    HBM_BYTES_PER_S, KERNEL_SYMBOLS, MASS_TOL, card, device_rows, fused_bounds, gates,
    graph_kernels, graph_path_counts, mega_bound, path_launches_per_step, replay_profile,
    total_mass, volume_bound)
from hnumo_tpu_torch.tools import bench

# Builds of the four streaming kernels with one of their two halves compiled
# out (BTP_ABLATE in ops/csrc/btp_volume_common.cuh and btp_tail_common.cuh):
# they compute wrong numbers on purpose and are only timed, to say what
# limits the real kernel.
ABLATIONS = (("memory_only", "BTP_ABLATE=1"),    # contractions compiled out
             ("compute_only", "BTP_ABLATE=2"))   # no global reads
ABLATED_SOURCES = ("btp_volume", "btp_volume_uni", "btp_faces", "btp_update")
# the megakernel's (ops/csrc/btp_mega.cu), a third: its nsub stages left
# empty but for their grid barriers, the floor of any design with one grid
# barrier per stage, and a fourth that computes the right numbers: the
# resident route with one grid barrier per stage in place of its neighbour
# counters
MEGA_ABLATIONS = ABLATIONS + (("barrier_only", "BTP_ABLATE=3"),
                              ("grid_barrier", "BTP_ABLATE=4"))

F64_TOL = 1e-12     # kernel vs plain, f64: same operations, other summation order
F32_TOL = 2e-5      # kernel vs plain, f32: ~100-term sums in another order
SOLVE_TOL = 1e-11   # f64 barotropic solve, kernel vs plain, over N_btp*kstages stages
# f32 megakernel vs its f32 plain version after 100 stages, per field over
# the field's max: both round every operation to f32 but sum in different
# orders (sum-factorised loops with FMAs against library matrix products),
# and the difference is carried through 100 stable stages. Measured 5e-6 at
# 32x32; the tolerance leaves a factor of 20.
F32_MEGA_TOL = 1e-4
STEP_TOL = 1e-10    # f64, two full steps, megakernel vs per-stage path
# the viscosity of the sheared-state check (phase 7): the neighbours' viscous
# gradient enters a solve with small weights; at the model's 100 m^2/s a
# fault there moves qb by no more than rounding, so no tolerance could see
# it. With u, v ~ 1 m/s and this viscosity, the same fault moves qb by more
# than 1e-8 of its scale, three orders above SOLVE_TOL
# (tests/test_torch_mega_layout.py shows it on a model of the kernel); the
# solve stays stable and finite.
SHEAR_VISC = 1e12


def main_path_config(nel: int, dtype: str, nop: int = 4, mega: str = "auto", **over):
    """The double-gyre basin of the JAX package's bench.py (same dt
    scaling; hnumo_tpu_torch/tools/bench.bench_config); `over` replaces any
    of its fields."""
    return bench.bench_config(nel, nop, dtype, mega=mega, **over)


def fused_config(nel: int, dtype: str):
    """The same basin on the fused path: three kernels per barotropic stage."""
    return main_path_config(nel, dtype, mega="off", fused_tail="on")


FREE_SLIP = ((4, 4), (4, 4))
# copy (0) west and north boundaries and a no-slip (2) south wall: at
# free-slip and no-slip walls every boundary flux vanishes or is masked, so
# only a copy boundary shows the sign a boundary face lands with
OTHER_WALLS = ((0, 4), (2, 0))


def small_config(nelx: int, nely: int, dtype: str, botfr: int, mega: str = "off",
                 visc: bool = True, kstages: int = 5, nop: int = 4,
                 walls=FREE_SLIP, **over):
    """A small double-gyre grid; `mega="off"` keeps it on the per-stage path
    (under 1024 elements "auto" would take the megakernel). `walls`:
    boundary codes ((west, east), (south, north))."""
    from hnumo_tpu_torch.config import Config

    kw = dict(nelx=nelx, nely=nely, nopx=nop, nopy=nop, xdims=(0.0, 2e6),
              ydims=(0.0, 2e6), nlayers=2, dt=400.0, dt_btp=20.0,
              time_final=1e9, test_case="double_gyre", f0=9.3e-5,
              beta=2e-11, botfr=botfr, cd_mlswe=1e-7, kstages=kstages,
              x_boundary=walls[0], y_boundary=walls[1],
              method_visc=2 if visc else 0, visc_mlswe=100.0 if visc else 0.0,
              dtype=dtype, mega=mega)
    return Config(**{**kw, **over})


def perturbed_inputs(m, seed: int, state=None):
    """A state off `state` (default the rest state, so nothing is all zeros)
    and its coupling."""
    from hnumo_tpu_torch.core.bcl import extract_qprime_faces
    from hnumo_tpu_torch.core.coupling import btp_bcl_coeffs

    rng = np.random.default_rng(seed)
    s = m.state0 if state is None else state

    def noise(t, amp, positive=False):
        r = rng.normal(size=tuple(t.shape))
        return torch.as_tensor(amp * (np.abs(r) if positive else r),
                               dtype=t.dtype, device=t.device)

    qb = s.qb_df + noise(s.qb_df, 1e-3, positive=True)
    qp = s.qprime_df + noise(s.qprime_df, 1e-4)
    qpf = extract_qprime_faces(m.bc, qp)
    zq = torch.zeros(qp.shape[1:-2] + m.g.wjac.shape[-2:], dtype=qp.dtype,
                     device=qp.device)
    coup = btp_bcl_coeffs(m.static, m.P, m.g, m.bc, qp, qpf, qp[0], zq)
    return rng, qb, qp, coup


def sheared_inputs(m, seed: int):
    """`perturbed_inputs` with independent random velocities u, v ~ 1 m/s at
    every node (qb's pb*u and pb*v channels), so the velocity gradients are
    O(1) per node spacing and the viscous terms that take them matter."""
    rng, qb, qp, coup = perturbed_inputs(m, seed)
    uv = torch.as_tensor(rng.normal(size=(2,) + tuple(qb.shape[1:])), dtype=qb.dtype,
                         device=qb.device)
    return rng, torch.cat([qb[:2], qb[:1] * uv]), qp, coup


def volume_operands(m, seed: int):
    """The volume stage's flat operands at this model's shapes."""
    from hnumo_tpu_torch.ops.btp_volume import eflat
    from hnumo_tpu_torch.ops.dg import interp_n2q

    rng, qb, qp, coup = perturbed_inputs(m, seed)
    qplq = eflat(interp_n2q(m.g, qp[:, -1]).contiguous())
    coup_flat = torch.stack([eflat(c.contiguous()) for c in
                             (coup.Q_uu_dp, coup.Q_uv_dp, coup.Q_vv_dp, coup.dH_bcl)])
    E, nqq = coup_flat.shape[1], coup_flat.shape[2]
    npts = m.g.wjac_df.shape[-1] ** 2
    opts = dict(dtype=qb.dtype, device=qb.device)
    accv0 = torch.as_tensor(rng.normal(size=(12, E, nqq)), **opts)
    accn0 = torch.as_tensor(rng.normal(size=(3, E, npts)), **opts)
    return eflat(qb.contiguous()), qplq, coup_flat, accv0, accn0


def volume_kwargs(static):
    return dict(grav=static.gravity, botfr=static.botfr, cd=static.cd_mlswe,
                alpha_bot=static.alpha_bot)


def curvilinear_like(ops, seed: int):
    """The volume operators with the metric of every element and quad point
    perturbed (all four derivatives non-zero, positive weights): the general
    path is not checked on bricks alone."""
    rng = np.random.default_rng(seed)
    met = ops.met
    size = float(met[:4].abs().max())

    def r(shape):
        return torch.as_tensor(rng.uniform(-1.0, 1.0, size=tuple(shape)), dtype=met.dtype,
                               device=met.device)

    new = met.clone()
    new[:4] = met[:4] * (1.0 + 0.2 * r(met[:4].shape)) + 0.3 * size * r(met[:4].shape)
    new[4] = met[4] * (1.0 + 0.2 * r(met[4].shape))
    return ops._replace(met=new)


def check_kernel_against_plain(nelx, nely, dtype, botfr, nop=4, curvilinear=False):
    """One comparison; returns (max scaled error, max abs error). The kernel
    must leave its inputs as they were and update each accumulator once (the
    plain version's result says what once is)."""
    from hnumo_tpu_torch.model import Model

    m = Model(small_config(nelx, nely, dtype, botfr, nop=nop))
    ops = curvilinear_like(m.vol_ops, seed=botfr) if curvilinear else m.vol_ops
    return compare_volume_kernel(m, ops, seed=botfr,
                                 what=f"botfr={botfr} E={nelx * nely} p={nop} "
                                      f"curvilinear={curvilinear}")


def compare_volume_kernel(m, ops, seed, what):
    """The volume kernel against its plain version on the operators `ops`
    and a perturbed state of model `m`, at the tolerance of its dtype;
    returns (max scaled error, max abs error)."""
    from hnumo_tpu_torch.ops.btp_volume import btp_volume_cuda, btp_volume_plain

    dtype = m.cfg.dtype
    qbf, qplq, coupf, accv0, accn0 = volume_operands(m, seed=seed)
    kw = volume_kwargs(m.static)
    inputs = (qbf, qplq, coupf, ops.met, ops.ptab, ops.pbp_df)
    keep = [t.clone() for t in inputs]
    av_k, an_k = accv0.clone(), accn0.clone()
    rhs_k, av_k2, an_k2 = btp_volume_cuda(ops, qbf, qplq, coupf, av_k, an_k, **kw)
    torch.cuda.synchronize()
    if av_k2 is not av_k or an_k2 is not an_k:
        raise AssertionError("kernel wrapper must return the accumulators it was given")
    for a, b in zip(keep, inputs):
        if not torch.equal(a, b):
            raise AssertionError("the volume kernel changed one of its inputs")
    av_p, an_p = accv0.clone(), accn0.clone()
    rhs_p, _, _ = btp_volume_plain(ops, qbf, qplq, coupf, av_p, an_p, **kw)
    torch.cuda.synchronize()
    tol = F64_TOL if dtype == "float64" else F32_TOL
    worst_scaled, worst_abs = 0.0, 0.0
    for name, a, b in (("rhs", rhs_k, rhs_p), ("accv", av_k, av_p), ("accn", an_k, an_p)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        worst_scaled = max(worst_scaled, err / scale)
        worst_abs = max(worst_abs, err)
        if not err <= tol * scale:
            raise AssertionError(
                f"kernel != plain: {name} {dtype} {what}: max|diff|={err:.3e} > "
                f"{tol:g}*{scale:.3e}")
    return worst_scaled, worst_abs


def solve_leaves(qb_new, avg):
    """(name, tensor) of a barotropic solve's result: the four channels of qb
    (each on its own scale) and every one of the running averages."""
    for c, name in enumerate(("qb.pb", "qb.pbpert", "qb.pbub", "qb.pbvb")):
        yield name, qb_new[c]
    for f in avg._fields:
        if f != "faces":
            yield f, getattr(avg, f)
    for d, fa in zip("xy", avg.faces):
        for f in fa._fields:
            yield f"faces.{d}.{f}", getattr(fa, f)


def compare_solves(got, want, tol, what):
    """Every leaf of `got` within tol * max|leaf of want|; returns (max
    error/scale, max abs error, number of fields)."""
    worst, worst_abs, n = 0.0, 0.0, 0
    for (name, a), (_, b) in zip(solve_leaves(*got), solve_leaves(*want)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: {name}: non-finite values")
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        n += 1
        if scale == 0.0:      # a field that is identically zero (no viscosity)
            if err != 0.0:
                raise AssertionError(f"{what}: {name}: {err:.3e} where the other is 0")
            continue
        worst = max(worst, err / scale)
        worst_abs = max(worst_abs, err)
        if not err <= tol * scale:
            raise AssertionError(
                f"{what}: {name}: max|diff|={err:.3e} > {tol:g}*{scale:.3e}")
    return worst, worst_abs, n


def check_solve_kernel_vs_plain():
    """f64 barotropic_solve at 12x12, per-stage path: kernel stage vs plain stage."""
    import dataclasses

    from hnumo_tpu_torch.core.btp import barotropic_solve
    from hnumo_tpu_torch.model import Model

    m = Model(small_config(12, 12, "float64", 1))
    if m.static.mega:
        raise AssertionError("mega='off' must keep the per-stage path")
    _, qb, qp, coup = perturbed_inputs(m, seed=7)
    out = {}
    for impl in ("kernel", "plain"):
        st = dataclasses.replace(m.static, volume_impl=impl)
        out[impl] = barotropic_solve(st, m.P, m.g, m.bc, coup, qb, qp,
                                     vol_ops=m.vol_ops)
        torch.cuda.synchronize()
    worst, _, n = compare_solves(out["kernel"], out["plain"], SOLVE_TOL,
                                 "solve with volume kernel != with plain stage")
    return worst, n


def mega_routes():
    """{route: launches so far} of the megakernel's wrapper."""
    from hnumo_tpu_torch.ops.mega import ROUTES, barotropic_solve_mega_cuda

    return {r: getattr(barotropic_solve_mega_cuda, f"launches_{r}") for r in ROUTES}


def check_mega_vs_plain(cfg, tol, seed=3, route=None, inputs=perturbed_inputs):
    """One barotropic solve through the megakernel and through its plain
    version on the same inputs (`inputs(model, seed)`) on the card.
    route=None: through the solver's dispatch, on the route the size
    chooses; else through `mega_launch` on the route named. Returns (max error/scale, max abs error, number of
    fields, the route the launch took)."""
    import dataclasses

    from hnumo_tpu_torch.core.btp import barotropic_solve
    from hnumo_tpu_torch.model import Model
    from hnumo_tpu_torch.ops import mega

    m = Model(cfg)
    if not (m.static.mega and m.static.mega_impl == "kernel" and m.mega_ops is not None):
        raise AssertionError("this configuration must take the megakernel")
    _, qb, qp, coup = inputs(m, seed=seed)
    qb_keep = qb.clone()
    before = mega_routes()
    if route is None:
        st = dataclasses.replace(m.static, mega_impl="kernel")
        got = barotropic_solve(st, m.P, m.g, m.bc, coup, qb, qp, vol_ops=m.vol_ops,
                               mega_ops=m.mega_ops)
    else:
        E, (ngl, nq) = cfg.nelx * cfg.nely, m.g.psiq.shape
        opts = dict(dtype=qb.dtype, device=qb.device)
        op = mega.solve_operands(m.static, m.g, coup, qb, qp, m.mega_ops)
        acc = mega.new_accumulators(E, ngl, nq, **opts)
        qb_new = mega.mega_launch(m.static, m.mega_ops, op, acc,
                                  *mega.new_state_buffers(E, ngl, **opts), route=route)
        got = (qb_new.view(4, cfg.nely, cfg.nelx, ngl, ngl),
               mega.averages_from_accumulators(m.static, m.mega_ops, *acc))
    torch.cuda.synchronize()
    taken = [r for r, n in mega_routes().items() if n != before[r]]
    if len(taken) != 1 or sum(mega_routes().values()) - sum(before.values()) != 1:
        raise AssertionError(f"one solve must be one megakernel launch, got {taken}")
    st = dataclasses.replace(m.static, mega_impl="plain")
    want = barotropic_solve(st, m.P, m.g, m.bc, coup, qb, qp, vol_ops=m.vol_ops,
                            mega_ops=m.mega_ops)
    torch.cuda.synchronize()
    if not torch.equal(qb, qb_keep):
        raise AssertionError("the megakernel changed its caller's qb_df")
    E = cfg.nelx * cfg.nely
    return (*compare_solves(got, want, tol,
                            f"megakernel ({taken[0]} route) != plain ({cfg.dtype}, E={E})"),
            taken[0])


def check_mega_vs_per_stage():
    """f64 at 12x12: the megakernel against the per-stage path with the
    volume kernel — two independent routes to the same numbers — on one
    solve and on two full steps."""
    import dataclasses

    from hnumo_tpu_torch.core.btp import barotropic_solve
    from hnumo_tpu_torch.model import Model

    mm = Model(small_config(12, 12, "float64", 1, mega="on"))
    mp = Model(small_config(12, 12, "float64", 1, mega="off"))
    if not mm.static.mega or mp.static.mega or mp.static.volume_impl != "kernel":
        raise AssertionError("expected one model on each barotropic path")
    _, qb, qp, coup = perturbed_inputs(mm, seed=9)
    a = barotropic_solve(mm.static, mm.P, mm.g, mm.bc, coup, qb, qp,
                         vol_ops=mm.vol_ops, mega_ops=mm.mega_ops)
    b = barotropic_solve(mp.static, mp.P, mp.g, mp.bc, coup, qb, qp, vol_ops=mp.vol_ops)
    torch.cuda.synchronize()
    w_solve, _, n = compare_solves(a, b, SOLVE_TOL, "megakernel != per-stage path")
    sa, sb = mm.run(mm.state0, 2), mp.run(mp.state0, 2)
    torch.cuda.synchronize()
    w_step = compare_states(sa, sb, STEP_TOL, "two steps, megakernel != per-stage path")
    return w_solve, n, max(w_step.values())


def rand_like_shape(rng, shape, like):
    return torch.as_tensor(rng.normal(size=shape), dtype=like.dtype, device=like.device)


def fused_stage_operands(m, seed: int):
    """The operands of one fused stage at this model's shapes, from a state
    off the rest state, with random non-zero accumulators: the volume
    stage's own, and everything the face and update stages take beside what
    the stages before them produce."""
    from hnumo_tpu_torch.ops.btp_tail import build_face_tables
    from hnumo_tpu_torch.ops.btp_volume import eflat

    rng, qb, qp, coup = perturbed_inputs(m, seed)
    visc = m.static.use_visc
    qbf = eflat(qb.contiguous())
    E, npts = qbf.shape[1], qbf.shape[2]
    ngl, nq = m.g.psiq.shape
    tabs = build_face_tables(m.P, coup, m.g.psiq, visc, static_rows=m.tail_ops.face_rows)
    F = tabs.nfx + tabs.nfy
    op = {
        "qb": qbf, "qpln": eflat(qp[:, -1].contiguous()),
        "coup": torch.stack([eflat(c.contiguous()) for c in
                             (coup.Q_uu_dp, coup.Q_uv_dp, coup.Q_vv_dp, coup.dH_bcl)]),
        "accv": rand_like_shape(rng, (12, E, nq * nq), qbf),
        "accn": rand_like_shape(rng, (3, E, npts), qbf),
        "agr": rand_like_shape(rng, (4, E, npts), qbf) if visc else None,
        "tabs": tabs, "af": rand_like_shape(rng, (16, F, nq), qbf),
        "ag": rand_like_shape(rng, (8, F, ngl), qbf) if visc else None,
        # two more SSPRK registers, so that all three weights matter
        "qb0": qbf + 1e-3 * rand_like_shape(rng, tuple(qbf.shape), qbf).abs(),
        "qb2": qbf + 1e-3 * rand_like_shape(rng, tuple(qbf.shape), qbf).abs(),
        "pbpv": eflat(coup.pbprime_visc.contiguous())[None] if visc else None,
        "bdg": eflat(coup.btp_dpp_graduv.contiguous()) if visc else None,
    }
    return op


def update_weights(m):
    """(a0, a1, a2, dt*beta) for the update stage with all three SSPRK
    registers weighted (no stage of SSP(5,3) weights all three), and the
    last stage's RHS weight."""
    return (0.25, 0.5, 0.25, m.static.dt_btp * float(m.P.ssprk_beta[-1]))


def fused_stage(m, op, impl: str, w):
    """One fused stage (volume, exchange, faces, exchange, update) on copies
    of the accumulators in `op`, every kernel fed what the PLAIN stages before
    it produced, so that each comparison is of one kernel alone. Returns
    {kernel name: {output name: tensor}}."""
    from hnumo_tpu_torch.core.btp import fused_edge_pack, fused_traces
    from hnumo_tpu_torch.ops import btp_tail as bt
    from hnumo_tpu_torch.ops import btp_volume_uni as bu

    fo, visc = m.tail_ops, m.static.use_visc
    ney, nex = m.cfg.nely, m.cfg.nelx
    ngl = m.g.psiq.shape[0]
    kw = volume_kwargs(m.static)
    out = {}

    def clone(t):
        return None if t is None else t.clone()

    def run_volume(fn):
        accv, accn, agr = clone(op["accv"]), clone(op["accn"]), clone(op["agr"])
        inputs = (op["qb"], op["qpln"], op["coup"], fo.vol.ptab, fo.vol.pbp_df)
        keep = [t.clone() for t in inputs]
        res = fn(fo.vol, op["qb"], op["qpln"], accv, accn, op["coup"], agr, **kw)
        torch.cuda.synchronize()
        for a, b in zip(keep, inputs):
            if not torch.equal(a, b):
                raise AssertionError("the volume stage changed one of its inputs")
        if res[1] is not accv or res[2] is not accn or (visc and res[4] is not agr):
            raise AssertionError("the volume stage must return the accumulators it was given")
        names = ("rhs", "accv", "accn", "gv", "agr")
        return dict(zip(names, res))

    def run_faces(fn, trL, trR):
        af, ag = clone(op["af"]), clone(op["ag"])
        inputs = [trL, trR, *(t for t in op["tabs"][:4] if t is not None)]
        keep = [t.clone() for t in inputs]
        S, Sv, af2, ag2 = fn(op["tabs"], trL, trR, af, ag, use_visc=visc)
        torch.cuda.synchronize()
        for a, b in zip(keep, inputs):
            if not torch.equal(a, b):
                raise AssertionError("the face stage changed its traces or its tables")
        if af2 is not af or ag2 is not ag:
            raise AssertionError("the face stage must return the accumulators it was given")
        res = {"S": S, "af": af}
        if visc:
            res.update({"Sv": Sv, "ag": ag})
        return res

    plain_a = run_volume(bu.btp_volume_uni_plain)
    out["btp_volume_uni"] = (run_volume(bu.btp_volume_uni_cuda) if impl == "kernel"
                             else plain_a)
    trL, trR = fused_traces(m.bc, ney, nex, ngl, op["qb"], plain_a.get("gv"))
    plain_f = run_faces(bt.btp_faces_plain, trL, trR)
    out["btp_faces"] = (run_faces(bt.btp_faces_cuda, trL, trR) if impl == "kernel"
                        else plain_f)
    edges = fused_edge_pack(m.bc, ney, nex, plain_f["S"])
    vedges = fused_edge_pack(m.bc, ney, nex, plain_f["Sv"], negate=True) if visc else None
    upd = bt.btp_update_cuda if impl == "kernel" else bt.btp_update_plain
    keep = [t.clone() for t in (op["qb0"], op["qb"], op["qb2"])]
    qb_new = upd(fo.upd, w, plain_a["rhs"], edges, vedges, op["qb0"], op["qb"],
                 op["qb2"], plain_a.get("gv"), op["pbpv"], op["bdg"], fo.mask,
                 use_visc=visc)
    torch.cuda.synchronize()
    for a, b in zip(keep, (op["qb0"], op["qb"], op["qb2"])):
        if not torch.equal(a, b):
            raise AssertionError("the update stage changed one of its registers")
    out["btp_update"] = {f"qb_new[{c}]": qb_new[c] for c in range(4)}
    return out


def check_fused_kernels(nelx, nely, dtype, botfr, visc=True, test_case="double_gyre",
                        nop=4):
    """Kernels A, F and U against their plain versions on one stage's
    operands; returns {kernel: (max error/scale, max abs error)}."""
    from hnumo_tpu_torch.model import Model

    m = Model(small_config(nelx, nely, dtype, botfr, visc=visc, fused_tail="on",
                           test_case=test_case, nop=nop))
    if m.static.flat_bottom != (test_case == "double_gyre"):
        raise AssertionError(f"flat_bottom={m.static.flat_bottom} for {test_case}")
    return compare_fused_kernels(m, seed=17 + botfr,
                                 what=f"botfr={botfr} visc={visc} {test_case} "
                                      f"E={nelx * nely} p={nop}")


def compare_fused_kernels(m, seed, what, w=None):
    """Kernels A, F and U of model `m` (on the fused path) against their
    plain versions on one stage's operands of this model, at the tolerance
    of its dtype, the update stage with the weights `w` (default
    `update_weights`); returns {kernel: (max error/scale, max abs error)}."""
    if not m.static.fused_tail or m.static.mega or m.tail_ops is None:
        raise AssertionError("this configuration must take the fused path")
    dtype = m.cfg.dtype
    op = fused_stage_operands(m, seed=seed)
    w = update_weights(m) if w is None else w
    got, want = fused_stage(m, op, "kernel", w), fused_stage(m, op, "plain", w)
    tol = F64_TOL if dtype == "float64" else F32_TOL
    worst = {}
    for kname in got:
        ws, wa = 0.0, 0.0
        for name, a in got[kname].items():
            b = want[kname][name]
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{kname}: {name}: non-finite kernel output")
            scale = float(b.abs().max())
            err = float((a - b).abs().max())
            if not err <= tol * scale:
                raise AssertionError(
                    f"{kname} kernel != plain: {name} {dtype} {what}: "
                    f"max|diff|={err:.3e} > {tol:g}*{scale:.3e}")
            ws, wa = max(ws, err / scale), max(wa, err)
        worst[kname] = (ws, wa)
    return worst


def check_fused_solve():
    """f64 barotropic solves: the fused path with its three kernels against
    the fused path with the three plain versions and against the per-stage
    path with the volume kernel; the per-stage path with the uniform-geometry
    volume kernel against the same path with the general one. Viscous with
    free-slip walls at 12x12; viscous and inviscid with copy/no-slip walls at
    6x5 (a copy boundary amplifies the roundoff between two orders of
    summation: the fused and the per-stage path, both in plain PyTorch on a
    CPU, differ by 8e-12 of pbvb at 12x12 after 100 stages, too near the
    tolerance to test anything, and by 2e-13 at 6x5)."""
    import dataclasses

    from hnumo_tpu_torch.core.btp import barotropic_solve
    from hnumo_tpu_torch.model import Model
    from hnumo_tpu_torch.ops.btp_tail import btp_faces_cuda, btp_update_cuda
    from hnumo_tpu_torch.ops.btp_volume import btp_volume_cuda
    from hnumo_tpu_torch.ops.btp_volume_uni import btp_volume_uni_cuda

    worst = {"fused kernels vs plain": 0.0, "fused vs per-stage": 0.0,
             "uni_volume vs general": 0.0}
    nfields = 0
    for nelx, nely, visc, walls in ((12, 12, True, FREE_SLIP), (6, 5, True, OTHER_WALLS),
                                    (6, 5, False, OTHER_WALLS)):
        mf = Model(small_config(nelx, nely, "float64", 1, visc=visc, walls=walls,
                                fused_tail="on"))
        mu = Model(small_config(nelx, nely, "float64", 1, visc=visc, walls=walls,
                                uni_volume="on"))
        mp = Model(small_config(nelx, nely, "float64", 1, visc=visc, walls=walls))
        if not (mf.static.fused_tail and mf.static.tail_impl == "kernel"
                and mu.static.uni_volume and not mp.static.uni_volume):
            raise AssertionError("expected one model on each path")
        _, qb, qp, coup = perturbed_inputs(mp, seed=21)
        qb_keep = qb.clone()

        def solve(m, **replace):
            st = dataclasses.replace(m.static, **replace)
            out = barotropic_solve(st, m.P, m.g, m.bc, coup, qb, qp, vol_ops=m.vol_ops,
                                   tail_ops=m.tail_ops)
            torch.cuda.synchronize()
            return out

        counters = (btp_volume_uni_cuda, btp_faces_cuda, btp_update_cuda, btp_volume_cuda)
        before = [c.launches for c in counters]
        fk = solve(mf)
        nsub = mf.static.n_btp * mf.static.kstages
        if [c.launches - b for c, b in zip(counters, before)] != [nsub, nsub, nsub, 0]:
            raise AssertionError("one fused solve must launch each of its three "
                                 f"kernels {nsub} times and no other")
        if not torch.equal(qb, qb_keep):
            raise AssertionError("the fused solve changed its caller's qb_df")
        fp = solve(mf, volume_impl="plain", tail_impl="plain")
        ps = solve(mp)
        before = btp_volume_uni_cuda.launches
        pu = solve(mu)
        if btp_volume_uni_cuda.launches - before != nsub:
            raise AssertionError("uni_volume='on' must run the uniform-geometry kernel")
        what = f"visc={visc} walls={walls}"
        for key, a, b in (("fused kernels vs plain", fk, fp),
                          ("fused vs per-stage", fk, ps),
                          ("uni_volume vs general", pu, ps)):
            w, _, nfields = compare_solves(a, b, SOLVE_TOL, f"{key} ({what})")
            worst[key] = max(worst[key], w)
    return worst, nfields


def time_launches(fn, operand_sets, n, device_only=False):
    """Mean ms per call of fn(*operands), rotating over the operand sets.

    As is, the host enqueues while the device runs, so a call whose wrapper
    takes the host longer than its kernel takes the device reads as the
    wrapper's time. `device_only`: the device is first kept busy (a spin
    kernel) until the host has enqueued all n calls, so the reading is the
    device time of n launches back to back; the spin is lengthened until the
    device was still in it when the last call was enqueued."""
    for ops in operand_sets:
        fn(*ops)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    spin_cycles = 50_000_000 if device_only else 0     # >= 25 ms below 2 GHz
    while True:
        if spin_cycles:
            torch.cuda._sleep(spin_cycles)
        t0.record()
        for i in range(n):
            fn(*operand_sets[i % len(operand_sets)])
        queued_ahead = not t0.query()
        t1.record()
        torch.cuda.synchronize()
        if queued_ahead or not device_only:
            return t0.elapsed_time(t1) / n
        if spin_cycles > 3_000_000_000:
            raise AssertionError("the host could not enqueue the launches ahead "
                                 "of the device: no device-only time taken")
        spin_cycles *= 4


def cold_sets(first, most=8):
    """`first` and enough clones of this tuple of operands to exceed the 50 MB
    L2 three times over (at most `most` sets, at least 2): a launch that
    rotates over them reads its data from device memory."""
    nbytes = sum(t.numel() * t.element_size() for t in first if t is not None)
    k = max(2, min(most, int(np.ceil(3 * 50e6 / nbytes)) + 1))
    return [first] + [tuple(None if t is None else t.clone() for t in first)
                      for _ in range(k - 1)]


def time_ablations(kernel, sets, n):
    """{"ms_memory_only", "ms_compute_only"}: the device time of `kernel` (a
    call of the CUDA wrapper of one of ABLATED_SOURCES) under each ablated
    build."""
    from hnumo_tpu_torch.ops._build import variant

    out = {}
    for name, define in ABLATIONS:
        with variant(define):
            out["ms_" + name] = time_launches(kernel, sets, n, device_only=True)
    return out


def time_volume_stage(m, n=60, nsets=None, ablations=True):
    """Kernel and plain version at this model's shapes (on its own
    operators: its metric), and with `ablations` the kernel's ablated builds.

    Times are taken twice: rotating over enough independent operand sets to
    exceed the 50 MB L2 ("cold": every launch reads its data from device
    memory), and on one set again and again ("hot")."""
    from hnumo_tpu_torch.ops.btp_volume import btp_volume_cuda, btp_volume_plain

    kw = volume_kwargs(m.static)
    sets = cold_sets(volume_operands(m, seed=11), most=nsets or 6)

    def kernel(*ops):
        btp_volume_cuda(m.vol_ops, *ops, **kw)

    def plain(*ops):
        btp_volume_plain(m.vol_ops, *ops, **kw)

    before = btp_volume_cuda.launches
    # the kernel twice: with the launches queued ahead of the device, and as
    # the host launches it (at 64x64 the wrapper's host time exceeds the
    # kernel's device time)
    out = {"ms": time_launches(kernel, sets, n, device_only=True),
           "ms_with_wrapper": time_launches(kernel, sets, n),
           "plain_ms": time_launches(plain, sets, n),
           "ms_hot": time_launches(kernel, sets[:1], n, device_only=True),
           "ms_hot_with_wrapper": time_launches(kernel, sets[:1], n),
           "plain_ms_hot": time_launches(plain, sets[:1], n),
           **(time_ablations(kernel, sets, n) if ablations else {})}
    btp_volume_cuda.launches = before   # timing launches are not the path's
    return out


def time_mega(m, n=20, ablations=True):
    """One solve at this model's shapes: the launch alone with the launches
    queued ahead of the device (`ms`), the wrapper as the host calls it
    (operand build, allocations, launch, averages), the plain version, and
    with `ablations` the launch under each of MEGA_ABLATIONS. The working set
    is a few MB (in the L2 at these sizes) and one launch reads it 100 times
    over, so there is no cold-operand variant to take."""
    from hnumo_tpu_torch.ops._build import variant
    from hnumo_tpu_torch.ops.mega import (barotropic_solve_mega_cuda,
                                          barotropic_solve_mega_plain, mega_launch,
                                          new_accumulators, new_state_buffers,
                                          solve_operands)

    _, qb, qp, coup = perturbed_inputs(m, seed=13)
    args = (m.static, m.P, m.g, m.bc, coup, qb, qp, m.mega_ops)
    E = m.cfg.nelx * m.cfg.nely
    ngl, nq = m.g.psiq.shape
    opts = dict(dtype=qb.dtype, device=qb.device)
    op = solve_operands(m.static, m.g, coup, qb, qp, m.mega_ops)
    acc = new_accumulators(E, ngl, nq, **opts)
    bufs = new_state_buffers(E, ngl, **opts)

    def wrapper():
        barotropic_solve_mega_cuda(*args)

    def launch():
        mega_launch(m.static, m.mega_ops, op, acc, *bufs)

    def plain():
        barotropic_solve_mega_plain(*args)

    before = dict(vars(barotropic_solve_mega_cuda))
    out = {"ms": time_launches(launch, [()], n, device_only=True),
           "ms_with_wrapper": time_launches(wrapper, [()], n),
           "plain_ms": time_launches(plain, [()], 2)}
    for name, define in MEGA_ABLATIONS if ablations else ():
        with variant(define):
            out["ms_" + name] = time_launches(launch, [()], n, device_only=True)
    vars(barotropic_solve_mega_cuda).update(before)   # timing launches are not the path's
    return out


def fused_kernel_calls(m):
    """{kernel name: (kernel call, plain call, operand sets)} for kernels A, F
    and U at this model's shapes: each call takes one operand set, and the
    sets are enough independent copies to exceed the 50 MB L2 ("cold": every
    launch reads its data from device memory). F and U are fed what the plain
    stages before them produce."""
    from hnumo_tpu_torch.core.btp import fused_edge_pack, fused_traces
    from hnumo_tpu_torch.ops import btp_tail as bt
    from hnumo_tpu_torch.ops import btp_volume_uni as bu

    fo, visc = m.tail_ops, m.static.use_visc
    ney, nex = m.cfg.nely, m.cfg.nelx
    ngl = m.g.psiq.shape[0]
    kw = volume_kwargs(m.static)
    op = fused_stage_operands(m, seed=23)
    w = update_weights(m)
    st = fused_stage(m, op, "plain", w)
    pa, pf = st["btp_volume_uni"], st["btp_faces"]
    trL, trR = fused_traces(m.bc, ney, nex, ngl, op["qb"], pa.get("gv"))
    edges = fused_edge_pack(m.bc, ney, nex, pf["S"])
    vedges = fused_edge_pack(m.bc, ney, nex, pf["Sv"], negate=True) if visc else None
    tabs = op["tabs"]

    def volume(fn):
        return lambda *o: fn(fo.vol, *o, **kw)

    def faces(fn):
        return lambda *o: fn(tabs, *o, use_visc=visc)

    def update(fn):
        return lambda *o: fn(fo.upd, w, *o, fo.mask, use_visc=visc)

    return {
        "btp_volume_uni": (volume(bu.btp_volume_uni_cuda), volume(bu.btp_volume_uni_plain),
                           cold_sets((op["qb"], op["qpln"], op["accv"], op["accn"],
                                      op["coup"], op["agr"]))),
        "btp_faces": (faces(bt.btp_faces_cuda), faces(bt.btp_faces_plain),
                      cold_sets((trL, trR, op["af"], op["ag"]))),
        "btp_update": (update(bt.btp_update_cuda), update(bt.btp_update_plain),
                       cold_sets((pa["rhs"], edges, vedges, op["qb0"], op["qb"], op["qb2"],
                                  pa.get("gv"), op["pbpv"], op["bdg"]))),
    }


def time_fused_kernels(m, n=60):
    """Kernels A, F and U and their plain versions at this model's shapes,
    each alone, on cold operands (`fused_kernel_calls`), each kernel also
    under its two ablated builds."""
    wrappers = kernel_wrappers()
    out = {}
    for name, (kernel, plain, osets) in fused_kernel_calls(m).items():
        before = wrappers[name].launches
        # the kernel twice: as the host launches it, and with the launches queued
        # ahead of the device (at 64x64 the wrapper's host time exceeds the
        # kernel's device time)
        out[name] = {"ms": time_launches(kernel, osets, n, device_only=True),
                     "ms_with_wrapper": time_launches(kernel, osets, n),
                     "plain_ms": time_launches(plain, osets, n),
                     **time_ablations(kernel, osets, n)}
        wrappers[name].launches = before    # timing launches are not the path's
    return out


def kernel_wrappers():
    """{kernel name: its wrapper, whose `launches` counts the launches made}."""
    from hnumo_tpu_torch.ops.btp_tail import btp_faces_cuda, btp_update_cuda
    from hnumo_tpu_torch.ops.btp_volume import btp_volume_cuda
    from hnumo_tpu_torch.ops.btp_volume_uni import btp_volume_uni_cuda
    from hnumo_tpu_torch.ops.mega import barotropic_solve_mega_cuda

    return {"btp_volume": btp_volume_cuda, "btp_mega": barotropic_solve_mega_cuda,
            "btp_volume_uni": btp_volume_uni_cuda, "btp_faces": btp_faces_cuda,
            "btp_update": btp_update_cuda}


def zero_counts():
    from hnumo_tpu_torch.ops.mega import ROUTES

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    for r in ROUTES:
        setattr(wrappers["btp_mega"], f"launches_{r}", 0)
    return wrappers


def drive(m, warm: int, steps: int):
    """`warm` + `steps` baroclinic steps through Model.run from the initial
    state; `steps` are timed. All five launch counters are zeroed just
    before the first step and read after the last. Eager, every step
    launches `path_launches_per_step`. Graphed (the default on the card,
    `warm` >= 1 so that the capture is not timed), the wrappers run in the
    first step only, twice: in the eager warm-up step before the capture and
    while the capture records; the replays launch the recorded kernels
    without them (`replay_profile` counts those in a trace)."""
    graphed = m.step_impl == "graph"
    if graphed and warm < 1:
        raise ValueError("a graphed model needs a warm step: the first step captures")
    s = m.state0
    mass0 = total_mass(m, s)
    wrappers = zero_counts()
    s = m.run(s, warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = m.run(s, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers.items()}
    per_step = path_launches_per_step(m)
    times = 2 if graphed else warm + steps
    want = {name: times * per_step.get(name, 0) for name in wrappers}
    if counts != want:
        raise AssertionError(f"{warm} + {steps} {m.step_impl} steps launched {counts}, "
                             f"expected {want}")
    if not bool(s.ok):
        raise AssertionError("state.ok is False")
    for name in ("qb_df", "q_df", "qprime_df"):
        if not bool(torch.isfinite(getattr(s, name)).all()):
            raise AssertionError(f"non-finite values in {name}")
    drift = abs(total_mass(m, s) - mass0) / mass0
    if not drift <= MASS_TOL:
        raise AssertionError(f"relative total-mass change {drift:.3e} > {MASS_TOL}")
    nq = m.g.psiq.shape[1]
    gp = m.cfg.nelx * m.cfg.nely * nq * nq * m.cfg.nlayers
    first = next(iter(per_step))
    return {"ms_per_step": wall / steps * 1e3, "gp_steps_per_s": gp * steps / wall,
            "launches": counts[first], "launches_per_step": per_step[first],
            "counts": counts, "mega_routes": mega_routes(), "mass_drift": drift,
            "step_impl": m.step_impl, "t": float(s.t)}, s


def profile_solve(m, out_path, title):
    """torch.profiler over one barotropic solve on this model's path: device
    activities and busy ms per stage, and the share of the wall time the
    device idles, appended to `out_path` under `title`."""
    from torch.profiler import ProfilerActivity, profile

    from hnumo_tpu_torch.core.btp import barotropic_solve

    _, qb, qp, coup = perturbed_inputs(m, seed=29)
    wrappers = kernel_wrappers()
    before = {k: fn.launches for k, fn in wrappers.items()}

    def solve():
        barotropic_solve(m.static, m.P, m.g, m.bc, coup, qb, qp, vol_ops=m.vol_ops,
                         mega_ops=m.mega_ops, tail_ops=m.tail_ops)
        torch.cuda.synchronize()

    solve()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        wall_ms = (time.perf_counter() - t0) * 1e3
    for k, fn in wrappers.items():    # profiled launches are not the path's
        fn.launches = before[k]
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
    with open(out_path, "a") as f:
        f.write(f"==== {title} ====\n{table}\n")
    dev = device_rows(prof)
    nsub = m.static.n_btp * m.static.kstages
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    return {"solve_wall_ms_profiled": wall_ms, "solve_device_busy_ms": busy,
            "activities_per_stage": sum(e.count for e in dev) / nsub,
            "device_busy_ms_per_stage": busy / nsub,
            "solve_device_idle_share": 1.0 - busy / wall_ms}


def profile_step(m, state, out_path, title):
    """torch.profiler over one step: device time by kernel name, appended
    to `out_path` under `title`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        m.step(state)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    with open(out_path, "a") as f:
        f.write(f"==== {title} ====\n{table}\n")
    dev = device_rows(prof)
    out = {"device_busy_ms": sum(e.self_device_time_total for e in dev) / 1e3,
           "device_activities": sum(e.count for e in dev)}
    mega = [e for e in dev if "btp_mega_kernel" in e.key]
    if mega:
        out["mega_kernel_ms"] = sum(e.self_device_time_total for e in mega) / 1e3
    return out




def check_graph_vs_eager(cfg, steps: int):
    """`steps` steps of a graphed and of an eager model of `cfg` from the
    initial state: every field of every state must be bitwise equal. Also
    the contract of Model.step under the graph: the caller's state is not
    mutated and a state a step returned is not overwritten by a later step.
    Returns the two models, their last states and the launches the graphed
    model's first step (warm-up and capture) made."""
    from hnumo_tpu_torch.core.types import State
    from hnumo_tpu_torch.model import Model

    me, mg = Model(cfg, step_impl="eager"), Model(cfg)
    if mg.step_impl != "graph" or me.step_impl != "eager":
        raise AssertionError("Model must step through a CUDA graph by default on the card")
    given = State(*[t.clone() for t in mg.state0])
    wrappers = zero_counts()
    sg = mg.step(mg.state0)
    at_capture = {k: fn.launches for k, fn in wrappers.items()}
    want = {k: 2 * path_launches_per_step(mg).get(k, 0) for k in wrappers}
    if at_capture != want:
        raise AssertionError(f"the first graphed step (warm-up and capture) launched "
                             f"{at_capture}, expected {want}")
    first, first_copy = sg, State(*[t.clone() for t in sg])
    se = me.step(me.state0)
    for i in range(steps):
        if i:
            sg, se = mg.step(sg), me.step(se)
        for name in State._fields:
            a, b = getattr(sg, name), getattr(se, name)
            if not torch.equal(a, b):
                diff = float((a.double() - b.double()).abs().max())
                raise AssertionError(f"step {i + 1}: graphed {name} != eager, max |diff| "
                                     f"{diff:.3e}")
    for what, state, copy in (("the initial state it was given", mg.state0, given),
                              ("the state its first step returned", first, first_copy)):
        if not all(torch.equal(x, y) for x, y in zip(state, copy)):
            raise AssertionError(f"later graphed steps changed {what}")
    torch.cuda.synchronize()
    return me, se, mg, sg, at_capture


def sync_free_step(m, state):
    """One step under torch.cuda.set_sync_debug_mode("error"): any
    synchronising CUDA call in it raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = m.step(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out


def check_goldens():
    """The frozen f64 trajectories (tests/goldens/*.npz) and the 108-step CI
    bump against the reference's FIN values and mass gate, stepped by the
    graphed model (hnumo_tpu_torch/tools/goldens.py: the port's copies of the
    configurations, fingerprint and tolerances)."""
    from hnumo_tpu_torch.model import Model
    from hnumo_tpu_torch.tools import goldens

    out = {}
    for name, cfg, steps, route in (("bump_traj", goldens.bump_config(), None, "resident"),
                                    ("dgyre_traj", goldens.dgyre_config(), 10, "streamed")):
        m = Model(cfg)
        if not (m.step_impl == "graph" and m.static.mega and m.static.mega_impl == "kernel"):
            raise AssertionError(f"{name}: expected the graphed megakernel path")
        zero_counts()
        out[name] = goldens.replay(m, name, max_steps=steps)
        routes = mega_routes()
        if routes[route] == 0 or sum(routes.values()) != routes[route]:
            raise AssertionError(f"{name}: expected the {route} route only, got {routes}")
        if name == "bump_traj":
            out["ci_bump"] = goldens.ci_bump(m)
        del m
    return out


def check_campaign_spin_up(days: float = 2.0):
    """The committed double-gyre campaign's first `days` model days (f32,
    25x25, graphed) against docs/artifacts/dgyre_f64_cpu.json in the band of
    tests/test_campaign.py (hnumo_tpu_torch/tools/dgyre_campaign.band)."""
    from hnumo_tpu_torch.model import Model
    from hnumo_tpu_torch.tools import dgyre_campaign as dc

    m = Model(dc.campaign_config())
    art = dc.run(m, days)
    with open(pathlib.Path(__file__).resolve().parent / "docs" / "artifacts"
              / "dgyre_f64_cpu.json") as f:
        d64 = json.load(f)
    if not (art["complete"] and art["ok"]):
        raise AssertionError("the campaign's spin-up did not complete")
    dev = dc.band(art, d64, min_common=len(art["records"]))
    return {"steps": art["steps"], "ms_per_step": art["ms_per_step"], **dev}


def time_in_turns(cfg, steps: int, out_path=None, title=None):
    """ms/step of an eager and a graphed model of `cfg`, timed in turns
    (eager, graph, graph, eager) after one untimed step each (the graphed
    one captures there), peak device memory of each and the device idle
    share of one replayed step (its busy time over the graphed ms/step)."""
    from hnumo_tpu_torch.model import Model

    out = {}
    models = {}
    for impl in ("eager", "graph"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        m = Model(cfg, step_impl=impl)
        s = m.run(m.state0, 1)
        torch.cuda.synchronize()
        # this model's own: tables, state, one step's intermediates (the
        # graph's private pool keeps them reserved between replays)
        out[f"peak_gib_{impl}"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        models[impl] = (m, s)
    ms = {"eager": [], "graph": []}
    for impl in ("eager", "graph", "graph", "eager"):
        m, s = models[impl]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.run(s, steps)
        torch.cuda.synchronize()
        ms[impl].append((time.perf_counter() - t0) / steps * 1e3)
    m, s = models["graph"]
    prof = replay_profile(m, s, out_path, title)
    out.update({"ms_eager": ms["eager"], "ms_graph": ms["graph"], **prof,
                "replay_device_idle_share":
                    1.0 - prof["replay_device_busy_ms"] / (sum(ms["graph"]) / 2)})
    return out


# ---- the run layer (phase 20) and a curvilinear grid (phase 21) --------------

CLI_STEPS = 20        # steps of the CLI's run: time_final
CLI_EVERY = 5         # a snapshot every CLI_EVERY steps: time_restart
CLI_RESTART_AT = 10   # the snapshot the restarted run starts from
# The restart. A txt snapshot keeps the derived fields and pb, not pb'
# (reference src/diagnostics.F90, src/mod_restart.F90): the restored pb' =
# pb - pbprime carries the rounding of pb, up to one unit in the last place
# (ulp) of max|pb| (f32: 8 Pa at the double gyre's 1e8 Pa, 0.8 mm of free
# surface; f64: 1.5e-8 Pa). Every other channel is rebuilt from f64 derived
# values, to its rounding (a unit: the channel's ulp in its dtype plus the
# f64 ulp of the full variable it is rebuilt from) and to the model's own
# consistency between u', v' and u - ub, which cancel: measured at most 3
# units in f32 and 12 in f64 (8x8 on the CPU, 32x32 on the H100);
# RESTORE_ULPS allows 100 (a wrong reference state or alpha rounded to f32
# is ~2000). The
# gravity waves that the pb' error radiates over the next steps carry
# momenta of up to max|pb| * err / (rho * sqrt(g H)): the final error is
# linear in the restored pb' error and so proportional to the dtype's
# epsilon, while the momenta it is compared with grow with the time
# stepped. Measured after 10 more steps, per channel over its max: 4.3e-2
# (f32) and 5.2e-11 (f64) at 8x8 on the CPU, 1.2e-1 and 2.7e-10 at 32x32 on
# the H100 (1.0e6 and 1.2e6 epsilons), with restored pb' errors of 0.77
# and 0.5 ulp of pb; at a full ulp the f64 reading would be 2.4e6
# epsilons. The final states are held within RESTART_FINAL_EPS epsilons of
# each channel's max, pb' within twice its restored error. A restart that
# must be exact takes the npz checkpoint (io/snapshots.save_checkpoint).
RESTORE_ULPS = 100
RESTART_FINAL_EPS = 4e6
CURV_DEFORM = 0.2     # interior-vertex displacement of the curvilinear grid, of a cell
CURV_STEPS = 5        # graphed f32 steps on it


def write_namelist(path, cfg, **over):
    """A reference-format namelist (numo3d.in) holding every field of
    `cfg` (with `over`) that differs from the default, but its dtype: the
    CLI's --f32 chooses that."""
    import dataclasses

    from hnumo_tpu_torch.config import Config

    cfg = dataclasses.replace(cfg, **over)
    grid = ("nelx", "nely", "nopx", "nopy", "xdims", "ydims", "nlayers",
            "x_boundary", "y_boundary")

    def fmt(v):
        if isinstance(v, bool):
            return ".true." if v else ".false."
        if isinstance(v, str):
            return f"'{v}'"
        if isinstance(v, tuple):
            return ", ".join(fmt(x) for x in v)
        return repr(v)

    lines = {"gridnl": [], "input": []}
    for f in dataclasses.fields(Config):
        v = getattr(cfg, f.name)
        if f.name != "dtype" and v != f.default:
            lines["gridnl" if f.name in grid else "input"].append(f" {f.name} = {fmt(v)}")
    path.write_text("".join(f"&{g}\n" + "\n".join(ls) + "\n/\n" for g, ls in lines.items()))
    return path


def compare_states(got, want, tol, what, per_channel=False, skip=()):
    """Every field (or channel) of `got` but those named in `skip` within
    tol * max|want|; returns {field: max error / scale}."""
    out = {}
    for name in ("qb_df", "q_df", "qprime_df"):
        a, b = getattr(got, name).double(), getattr(want, name).double()
        for c, (x, y) in enumerate(zip(a, b) if per_channel else [(a, b)]):
            key = f"{name}[{c}]" if per_channel else name
            scale = float(y.abs().max())
            err = float((x - y).abs().max())
            out[key] = err / scale
            if key not in skip and not err <= tol * scale:
                raise AssertionError(f"{what}: {key}: max|diff| {err:.3e} > {tol:g} * "
                                     f"{scale:.3e}")
    return out


def cli_run(nml, outdir, *args):
    """driver.main on `nml` with the launch counters zeroed just before it
    and read just after: (runner, final state, summary, counts)."""
    from hnumo_tpu_torch import driver

    wrappers = zero_counts()
    runner, state, summ = driver.main([str(nml), "--outdir", str(outdir), "--quiet", *args])
    torch.cuda.synchronize()
    return runner, state, summ, {k: fn.launches for k, fn in wrappers.items()}


def check_cli(tmp):
    """bench.py's configuration (32x32 f32 double gyre, the megakernel
    path) run through the CLI, `python -m hnumo_tpu_torch numo3d.in --f32`,
    for CLI_STEPS steps with a snapshot every CLI_EVERY; a second run
    restarted from snapshot CLI_RESTART_AT, and the same two in f64;
    NetCDF and binary VTK snapshots of the final state; the Runner's ms/step
    beside Model.run's on the same model, in turns."""
    import dataclasses
    import shutil

    from hnumo_tpu_torch.config import config_from_namelist
    from hnumo_tpu_torch.core.types import State
    from hnumo_tpu_torch.io import snapshots as snap
    from hnumo_tpu_torch.io.vtk import write_vtk

    base = main_path_config(32, "float32")
    cfg = dataclasses.replace(base, time_final=CLI_STEPS * base.dt,
                              time_restart=CLI_EVERY * base.dt)
    nml = write_namelist(tmp / "numo3d.in", cfg)
    if config_from_namelist(nml, dtype="float32") != cfg:
        raise AssertionError("the CLI's namelist does not read back as bench.py's configuration")
    restart = dict(time_initial=CLI_RESTART_AT * cfg.dt, irestart_file_number=CLI_RESTART_AT)
    nml_r = write_namelist(tmp / "restart.in", cfg, **restart)
    rfile = f"mlswe{CLI_RESTART_AT:04d}"
    out = {}
    for tag, args in (("f32", ("--f32",)), ("f64", ())):
        run_dir, rst_dir = tmp / f"run_{tag}", tmp / f"restart_{tag}"
        t0 = time.perf_counter()
        runner, state, summ, counts = cli_run(nml, run_dir, *args)
        wall = time.perf_counter() - t0
        m = runner.model
        if not (m.step_impl == "graph" and m.static.mega and m.static.mega_impl == "kernel"
                and m.cfg.dtype == ("float32" if tag == "f32" else "float64")):
            raise AssertionError(f"CLI {tag}: expected the graphed megakernel path")
        want = {k: 2 * path_launches_per_step(m).get(k, 0) for k in counts}
        if counts != want:        # the first step: eager warm-up and capture
            raise AssertionError(f"CLI {tag}: launched {counts}, expected {want}")
        names = [f"mlswe{i:04d}" for i in range(0, CLI_STEPS + 1, CLI_EVERY)]
        missing = [n for n in names + ["mlswe_FIN.txt", "time.csv", "mass_mlswe.cons"]
                   if not (run_dir / n).exists()]
        if missing:
            raise AssertionError(f"CLI {tag}: missing output files {missing}")
        loss = [layer["mass_loss"] for layer in summ["layers"]]
        if not (bool(state.ok) and max(loss) <= MASS_TOL):
            raise AssertionError(f"CLI {tag}: ok={bool(state.ok)}, mass loss {loss}")
        for name in ("qb_df", "q_df", "qprime_df"):
            if not bool(torch.isfinite(getattr(state, name)).all()):
                raise AssertionError(f"CLI {tag}: non-finite values in {name}")
        # the restart: snapshot CLI_RESTART_AT alone in a directory of its own
        rst_dir.mkdir()
        shutil.copy(run_dir / rfile, rst_dir)
        r2, state2, _, counts2 = cli_run(nml_r, rst_dir, *args)
        if counts2 != want or r2.ntime != CLI_STEPS or float(state2.t) != float(state.t):
            raise AssertionError(f"CLI {tag} restart: launched {counts2}, ntime {r2.ntime}, "
                                 f"t {float(state2.t)} vs {float(state.t)}")
        # exact: the restarted run is the straight model's steps from the
        # restored snapshot, bit for bit (the same graph on the same inputs)
        restored = snap.restore_state(m, snap.read_txt(rst_dir / rfile),
                                      t=restart["time_initial"])
        control = m.run(restored, CLI_STEPS - CLI_RESTART_AT)
        if not all(torch.equal(a, b) for a, b in zip(control, state2)):
            raise AssertionError(f"CLI {tag} restart != the straight model stepped from the "
                                 f"restored snapshot")
        entry = {"wall_s": wall, "mass_loss": loss, "replay": replay_profile(m, state),
                 "launches_at_capture": counts, "restart_launches_at_capture": counts2}
        # the restored state against the straight run's at the same step, in
        # units of the rounding it went through: the channel's in its dtype,
        # and the f64 one of the full variable it was rebuilt from (the full
        # thickness for the thickness channels, the layer velocity for u', v')
        straight = m.run(m.state0, CLI_RESTART_AT)
        dp = m.P.dpp_ref_df.double() + straight.q_df[0].double()
        full = {"q_df[0]": float(dp.abs().max()), "qprime_df[0]": float(dp.abs().max())}
        full["qprime_df[1]"] = full["qprime_df[2]"] = float(
            (straight.q_df[1:].double() / dp).abs().max())
        ulp = {}
        for name in State._fields[:3]:
            for c, (x, y) in enumerate(zip(getattr(restored, name), getattr(straight, name))):
                key = f"{name}[{c}]"
                err = float((x.double() - y.double()).abs().max())
                ymax = float(y.abs().max())
                unit = (float(np.spacing(ymax, dtype=np.dtype(m.cfg.dtype)))
                        + float(np.spacing(full.get(key, ymax))))
                ulp[key] = err / unit
                if key == "qb_df[1]":      # pb - pbprime: one ulp of pb
                    pb_ulp = float(np.spacing(float(straight.qb_df[0].abs().max()),
                                              dtype=np.dtype(m.cfg.dtype)))
                    entry.update(restored_pb_prime_err=err, pb_ulp=pb_ulp)
                    if not err <= pb_ulp:
                        raise AssertionError(f"CLI {tag}: restored pb' off by {err:.3e} > "
                                             f"one ulp of max|pb| {pb_ulp:.3e}")
                elif not ulp[key] <= RESTORE_ULPS:
                    raise AssertionError(f"CLI {tag}: restored {key} off by {ulp[key]:.1f} "
                                         f"units of rounding > {RESTORE_ULPS}")
        tol = RESTART_FINAL_EPS * torch.finfo(m.dtype).eps
        final = compare_states(state2, state, tol, f"{tag} restart vs straight run",
                               per_channel=True, skip=("qb_df[1]",))
        dpb = float((state2.qb_df[1] - state.qb_df[1]).abs().max())
        if not dpb <= 2 * entry["restored_pb_prime_err"]:
            raise AssertionError(f"CLI {tag} restart: final pb' off by {dpb:.3e} > twice "
                                 f"the restored {entry['restored_pb_prime_err']:.3e}")
        entry.update(restored_ulps=ulp, restart_vs_straight=final, restart_tol=tol,
                     final_pb_prime_err=dpb)
        if tag == "f32":
            # the other writers on the final state, and the NetCDF read back
            path = snap.write_nc(m, state, CLI_STEPS, outdir=str(run_dir))
            back, ref = snap.read_nc(path), snap.snapshot_arrays(m, state)
            for k in ("x", "y", "pb", "pbub", "pbvb", "zbot", "h", "u", "v", "eta"):
                if not np.array_equal(back[k], ref[k]):
                    raise AssertionError(f"NetCDF snapshot: {k} does not read back")
            vtks = write_vtk(m, state, CLI_STEPS, outdir=str(run_dir), fmt="binary")
            raw = open(vtks[0], "rb").read()
            i = raw.index(b"POINTS")
            j = raw.index(b"\n", i) + 1
            npts = ref["npoin"]
            pts = np.frombuffer(raw[j:j + 12 * npts], dtype=">f4").reshape(-1, 3)
            if len(vtks) != 2 or b"BINARY" not in raw[:120] or not np.allclose(
                    pts[:, 0], ref["x"], rtol=1e-6):
                raise AssertionError("binary VTK snapshot: wrong header or points")
            entry["turns"] = runner_in_turns(m, tmp / "turns")
        out[tag] = entry
        del runner, r2, m
        torch.cuda.empty_cache()
    return out


def runner_in_turns(m, outdir):
    """ms/step of the Runner (its snapshots, diagnostics and FIN file
    included; and of its steps alone, its rhs_time) and of Model.run on the
    same model from the initial state, in turns Runner, run, run, Runner."""
    from hnumo_tpu_torch import driver

    ms = {"runner": [], "runner_steps": [], "model_run": []}
    for kind in ("runner", "model_run", "model_run", "runner"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "runner":
            r = driver.Runner(m, outdir=str(outdir))
            r.run(quiet=True)
            ms["runner_steps"].append(r.rhs_time / r.ntime * 1e3)
        else:
            m.run(m.state0, CLI_STEPS)
        torch.cuda.synchronize()
        ms[kind].append((time.perf_counter() - t0) / CLI_STEPS * 1e3)
    return ms


def write_msh(path, nel, length, deform, bathy, bc_codes=(4, 4, 4, 4)):
    """An MSH 2.2 ASCII file of an nel x nel quad grid on [0, length]^2 with
    its interior vertices displaced by a smooth deformation of `deform` cells
    (the outer sides stay straight), boundary lines tagged 1-4 (west, east,
    south, north) with `bc_codes` in a $BC section, and a $Bathy section of
    bathy(x, y) at the vertices."""
    n = nel + 1
    X, Y = np.meshgrid(np.linspace(0.0, length, n), np.linspace(0.0, length, n))
    cell = length / nel
    sx, sy = np.sin(np.pi * X / length), np.sin(np.pi * Y / length)
    X = X + deform * cell * sx * sy
    Y = Y + deform * cell * np.sin(2 * np.pi * X / length) * sy
    nid = np.arange(n * n).reshape(n, n) + 1
    lines = []
    for iy in range(nel):
        lines += [(1, nid[iy, 0], nid[iy + 1, 0]), (2, nid[iy, -1], nid[iy + 1, -1])]
    for ix in range(nel):
        lines += [(3, nid[0, ix], nid[0, ix + 1]), (4, nid[-1, ix], nid[-1, ix + 1])]
    quads = [(nid[ey, ex], nid[ey, ex + 1], nid[ey + 1, ex + 1], nid[ey + 1, ex])
             for ey in range(nel) for ex in range(nel)]
    rows = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(n * n)]
    rows += [f"{k} {x:.16e} {y:.16e} 0" for k, x, y in zip(nid.ravel(), X.ravel(), Y.ravel())]
    rows += ["$EndNodes", "$Elements", str(len(lines) + len(quads))]
    rows += [f"{k} 1 2 {t} {t} {a} {b}" for k, (t, a, b) in enumerate(lines, 1)]
    rows += [f"{k} 3 2 99 99 {a} {b} {c} {d}"
             for k, (a, b, c, d) in enumerate(quads, len(lines) + 1)]
    rows += ["$EndElements", "$BC", "4"] + [f"{t} {c}" for t, c in zip((1, 2, 3, 4), bc_codes)]
    rows += ["$EndBC", "$Bathy", "nodal"]
    rows += [f"{k} {z:.16e}" for k, z in zip(nid.ravel(), bathy(X, Y).ravel())]
    rows += ["$EndBathy"]
    path.write_text("\n".join(rows) + "\n")
    return path


def check_curvilinear(tmp):
    """bench.py's basin on a deformed 32x32 grid read from an MSH file with
    a seamount from its $Bathy section, through a namelist: a grid whose
    metric varies from node to node, on which every barotropic stage runs
    the general volume kernel. The kernel against its plain version on this
    model's operands; f64 steps with the kernel against steps with the
    plain version; f32 graphed steps; the kernel's time beside its bound,
    and beside its time on the 32x32 brick."""
    import dataclasses

    from hnumo_tpu_torch.config import config_from_namelist
    from hnumo_tpu_torch.model import Model

    base = main_path_config(32, "float32")
    length = base.xdims[1]
    msh = write_msh(tmp / "basin.msh", 32, length, CURV_DEFORM,
                    lambda x, y: -9928.0 + 1500.0 * np.exp(
                        -((x - 0.5 * length) ** 2 + (y - 0.5 * length) ** 2) / (0.2 * length) ** 2))
    nml = write_namelist(tmp / "curvilinear.in", base, lread_external_grid=True, mesh_file=str(msh),
                         lread_external_bathy=True)
    cfg = config_from_namelist(nml, dtype="float32")
    m = Model(cfg)
    st = m.static
    if (m.cfg.nelx, m.cfg.nely) != (32, 32) or st.uniform_geom or st.mega or \
            st.volume_impl != "kernel" or m.step_impl != "graph":
        raise AssertionError(f"curvilinear 32x32: expected the graphed per-stage path with "
                             f"the volume kernel on a non-uniform grid, got "
                             f"{(m.cfg.nelx, m.cfg.nely)} uniform_geom={st.uniform_geom} "
                             f"mega={st.mega} volume_impl={st.volume_impl}")
    met = m.vol_ops.met
    spread = float((met[:4].amax(dim=(1, 2)) - met[:4].amin(dim=(1, 2))).max()
                   / met[:4].abs().max())
    run, s = drive(m, warm=1, steps=CURV_STEPS)
    replay = replay_profile(m, s)
    m64 = Model(config_from_namelist(nml))
    errs = {"float32": compare_volume_kernel(m, m.vol_ops, 31, "curvilinear 32x32"),
            "float64": compare_volume_kernel(m64, m64.vol_ops, 31, "curvilinear 32x32")}
    mp = Model(config_from_namelist(nml), volume_impl="plain")
    step = compare_states(m64.run(m64.state0, 2), mp.run(mp.state0, 2), STEP_TOL,
                          "curvilinear f64, two steps, volume kernel vs plain version")
    del m64, mp
    timing = time_volume_stage(m, ablations=False)
    bound = volume_bound(m)
    brick = Model(dataclasses.replace(base, mega="off"))
    timing_brick = time_volume_stage(brick, ablations=False)
    del brick
    torch.cuda.empty_cache()
    return {"run": run, "replay": replay, "metric_spread": spread, "errs": errs,
            "step_err": step, "timing": timing, "bound": bound, "timing_brick": timing_brick}

# ---- the options off the main path (phases 22-26) ---------------------------

X_PERIODIC = dict(x_boundary=(3, 3), y_boundary=(4, 4))
Y_PERIODIC = dict(x_boundary=(4, 4), y_boundary=(3, 3))
SHEAR_AD = 1e-3       # ad_mlswe of phase 26


def nonzero(counts: dict) -> str:
    """The entries of `counts` that are not 0, as JSON."""
    return json.dumps({k: v for k, v in counts.items() if v})


def check_path(m, what, mega=False, fused=False, flat=None):
    """Raise unless graphed model `m` takes the barotropic path described
    (`flat`: the per-stage path's face pipeline, when given), with the
    general volume kernel on the per-stage path."""
    st = m.static
    got = dict(mega=st.mega, fused=st.fused_tail, uni=st.uni_volume, graph=m.step_impl)
    want = dict(mega=mega, fused=fused, uni=False, graph="graph")
    if flat is not None:
        got["flat"], want["flat"] = st.batched_faces, flat
    impls = (st.mega_impl, st.volume_impl, st.tail_impl)
    if got != want or impls != ("kernel",) * 3:
        raise AssertionError(f"{what}: expected {want} with the kernels, got {got} {impls}")


def graph_and_replay(cfg, steps, what, timed=3, profile=None, **path):
    """check_graph_vs_eager over `steps` steps on the path described, a step
    of the graphed model under the sync debug mode, `timed` more replayed
    steps timed, the gates of the last state (the mass over all
    steps + 1 + timed) and a replay's trace (its table appended to
    `profile` when given); returns the readings and the graphed model with
    its last state."""
    me, se, mg, sg, at_capture = check_graph_vs_eager(cfg, steps)
    del me, se
    check_path(mg, what, **path)
    sg = sync_free_step(mg, sg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sg = mg.run(sg, timed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    drift = gates(mg, sg)
    replay = replay_profile(mg, sg, profile, f"{what} f32, one replayed step")
    nq = mg.g.psiq.shape[1]
    gp = cfg.nelx * cfg.nely * nq * nq * cfg.nlayers
    return {"steps_bitwise": steps, "steps": steps + 1 + timed,
            "ms_per_step": wall / timed * 1e3, "gp_steps_per_s": gp * timed / wall,
            "launches_at_capture": at_capture, "mass_drift": drift, **replay}, mg, sg


def step_kernel_vs_plain(cfg, steps, tol, what):
    """`steps` f64 steps of `cfg` with every kernel against every plain
    version (eager); returns {field: max error / scale}."""
    from hnumo_tpu_torch.model import Model

    mk = Model(cfg, step_impl="eager")
    mp = Model(cfg, volume_impl="plain", mega_impl="plain", tail_impl="plain",
               step_impl="eager")
    out = compare_states(mk.run(mk.state0, steps, check_ok=False),
                         mp.run(mp.state0, steps, check_ok=False), tol, what)
    torch.cuda.synchronize()
    return out


def eager_steps(cfg, steps):
    """(static, state after `steps` eager steps of `cfg` on the path its
    dispatch takes)."""
    from hnumo_tpu_torch.model import Model

    m = Model(cfg, step_impl="eager")
    return m.static, m.run(m.state0, steps)


def step_paths(cfg_a, cfg_b, steps, tol, what, b=None):
    """`steps` f64 steps of two configurations, each on the path its
    dispatch takes, one against the other (`b`: eager_steps of cfg_b, when
    already taken); returns ({field: max error / scale}, (static a, static
    b))."""
    sa, a = eager_steps(cfg_a, steps)
    sb, b = eager_steps(cfg_b, steps) if b is None else b
    out = compare_states(a, b, tol, what)
    torch.cuda.synchronize()
    return out, (sa, sb)


def check_quad_family(profile=None):
    """Phase 22: the double gyre at 64x64 with the quad-family LDG viscosity
    (method_visc=1): per stage kernel 1 and the per-direction faces, the
    only face pipeline of that family."""
    from hnumo_tpu_torch.model import Model

    cfg = main_path_config(64, "float32", method_visc=1)
    # the mass gate over 6 steps: 2 against eager, 1 sync-free, 3 timed
    rg, m, s = graph_and_replay(cfg, 2, "quad family 64x64", timed=3, profile=profile,
                                flat=False)
    errs = {"float32": compare_volume_kernel(m, m.vol_ops, 41, "quad family 64x64")}
    m64 = Model(main_path_config(64, "float64", method_visc=1))
    errs["float64"] = compare_volume_kernel(m64, m64.vol_ops, 41, "quad family 64x64")
    del m64, m, s
    step = step_kernel_vs_plain(small_config(12, 12, "float64", 1, method_visc=1), 2,
                                SOLVE_TOL, "quad family f64 12x12, kernel vs plain version")
    torch.cuda.empty_cache()
    return {"graph": rg, "errs": errs, "step_err": step}


def check_face_paths(steps=2, profile=None):
    """Phase 23: the 128x128 per-stage path with both face pipelines,
    batched_faces="auto" (above 8192 elements: one per direction) and "on"
    (the flat axis): graphed ms/step in turns auto, on, on, auto; both
    launch kernel 1 200 times a step. And two f64 steps at 6x5 with a copy
    side, one face path against the other."""
    from hnumo_tpu_torch.model import Model

    cfgs = {"auto": main_path_config(128, "float32"),
            "on": main_path_config(128, "float32", batched_faces="on")}
    models, runs, replays = {}, {}, {}
    for k, cfg in cfgs.items():
        m = Model(cfg)
        check_path(m, f"128x128 batched_faces={k!r}", flat=(k == "on"))
        runs[k], s = drive(m, warm=1, steps=steps)
        replays[k] = replay_profile(
            m, s, profile, f"128x128 f32 per-stage, batched_faces={k!r}, one replayed step")
        models[k] = (m, s)
    ms = {k: [] for k in cfgs}
    for k in ("auto", "on", "on", "auto"):
        m, s = models[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.run(s, steps)
        torch.cuda.synchronize()
        ms[k].append((time.perf_counter() - t0) / steps * 1e3)
    del models
    torch.cuda.empty_cache()
    step, statics = step_paths(
        small_config(6, 5, "float64", 1, walls=OTHER_WALLS, batched_faces="off"),
        small_config(6, 5, "float64", 1, walls=OTHER_WALLS, batched_faces="on"), 2,
        SOLVE_TOL, "f64 6x5, per-direction faces vs the flat axis")
    if [st.batched_faces for st in statics] != [False, True]:
        raise AssertionError("6x5: expected one model on each face path")
    return {"runs": runs, "replays": replays, "ms_turns": ms, "step_err": step}


def check_lsrk():
    """Phase 24: the 64x64 per-stage path with lsrk at kstages 5 and 14 (200
    and 560 launches of kernel 1 a step), graphed against eager; lsrk_ref,
    the reference's SSP update on the LSRK tables, at 32x32 through the
    fused path for one step (it diverges by design within a few), its
    warning, and one f64 step at 12x12 with A, F, U against their plain
    versions."""
    import warnings

    from hnumo_tpu_torch.model import Model

    out = {}
    for k, steps in ((5, 2), (14, 1)):
        cfg = main_path_config(64, "float32", ti_method_btp="lsrk", kstages=k)
        out[f"lsrk{k}"], mg, sg = graph_and_replay(cfg, steps, f"lsrk kstages={k} 64x64")
        del mg, sg
    torch.cuda.empty_cache()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        m = Model(main_path_config(32, "float32", mega="off", fused_tail="on",
                                   ti_method_btp="lsrk_ref"))
    if not any("lsrk_ref" in str(w.message) and "DIVERGES" in str(w.message) for w in rec):
        raise AssertionError("lsrk_ref must warn that it diverges")
    check_path(m, "lsrk_ref 32x32", fused=True)
    wrappers = zero_counts()
    s = m.step(m.state0)
    torch.cuda.synchronize()
    at_capture = {k: fn.launches for k, fn in wrappers.items()}
    want = {k: 2 * path_launches_per_step(m).get(k, 0) for k in wrappers}
    if at_capture != want:
        raise AssertionError(f"lsrk_ref: the first step launched {at_capture}, expected {want}")
    replay = replay_profile(m, m.state0)
    a, beta = m.static.ssprk_a, m.static.ssprk_beta
    # kernel U with a stage's LSRK weights (negative A, the other two 0)
    w = (a[2][0], a[2][1], a[2][2], m.static.dt_btp * beta[2])
    errs = {"float32": compare_fused_kernels(m, 43, "lsrk_ref 32x32", w=w)}
    out["lsrk_ref"] = {"launches_at_capture": at_capture, **replay, "ok": bool(s.ok),
                       "finite": bool(torch.isfinite(s.qb_df).all()), "errs": errs,
                       "update_weights": w}
    del m, s
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m64 = Model(main_path_config(32, "float64", mega="off", fused_tail="on",
                                     ti_method_btp="lsrk_ref"))
        errs["float64"] = compare_fused_kernels(m64, 43, "lsrk_ref 32x32", w=w)
        del m64
        out["lsrk_ref"]["step_err"] = step_kernel_vs_plain(
            small_config(12, 12, "float64", 1, fused_tail="on", ti_method_btp="lsrk_ref"),
            1, SOLVE_TOL, "lsrk_ref f64 12x12 fused, kernels vs plain versions")
    torch.cuda.empty_cache()
    return out


def check_periodic():
    """Phase 25: the double gyre at 64x64, periodic in x with free-slip
    walls in y, through the fused and the per-stage path, and periodic in y
    with walls in x through the fused path: each graphed with its gates and
    a replay's trace; kernels A, F, U (fused) and 1 (per stage) against
    their plain versions on the model's own wrapped operands, f32 and f64.
    A 32x32 periodic grid under mega="auto" stays off the megakernel."""
    from hnumo_tpu_torch.model import Model

    cases = {"x_fused": (dict(mega="off", fused_tail="on", **X_PERIODIC), True),
             "x_per_stage": (X_PERIODIC, False),
             "y_fused": (dict(mega="off", fused_tail="on", **Y_PERIODIC), True)}
    out = {}
    for name, (over, fused) in cases.items():
        m = Model(main_path_config(64, "float32", **over))
        check_path(m, f"periodic {name} 64x64", fused=fused)
        run, s = drive(m, warm=1, steps=3)
        entry = {"run": run, "replay": replay_profile(m, s), "errs": {}}
        m64 = Model(main_path_config(64, "float64", **over))
        for mm in (m, m64):
            what = f"periodic {name} 64x64"
            entry["errs"][mm.cfg.dtype] = (compare_fused_kernels(mm, 47, what) if fused else
                                           {"btp_volume": compare_volume_kernel(
                                               mm, mm.vol_ops, 47, what)})
        out[name] = entry
        del m, m64, s
        torch.cuda.empty_cache()
    m = Model(main_path_config(32, "float32", **X_PERIODIC))
    check_path(m, "periodic 32x32 mega='auto'")
    run, s = drive(m, warm=1, steps=2)
    out["x_32_auto"] = {"run": run, "replay": replay_profile(m, s)}
    return out


def stepped_inputs(m, seed):
    """`perturbed_inputs` around the model's state after two steps (its
    primes and coupling carry what the model's own options did to them)."""
    return perturbed_inputs(m, seed, state=m.run(m.state0, 2))


def check_shear_and_botfr2():
    """Phase 26: the vertical shear stress (ad_mlswe) at 32x32 through the
    megakernel, graphed against eager, the megakernel against its plain
    version on a solve from that model's stepped state, and the term's
    effect against the same model without it; quadratic bottom drag
    (botfr=2) at 32x32 (megakernel) and 64x64 (fused), graphed, and two f64
    steps at 12x12 of both paths against the per-stage path."""
    from hnumo_tpu_torch.model import Model

    out = {}
    cfg = main_path_config(32, "float32", ad_mlswe=SHEAR_AD)
    out["shear"], mg, sg = graph_and_replay(cfg, 2, "shear 32x32", mega=True)
    del mg
    # the term's effect: the layer momenta against the same model without
    # it, in f32 after the graphed run's steps and in f64 after 2 (in f64 the
    # difference is the term's own, not the rounding it sets off; it must
    # not be 0)
    for dtype, n in (("float32", out["shear"]["steps"]), ("float64", 2)):
        s1 = sg
        if dtype == "float64":
            m1 = Model(main_path_config(32, dtype, ad_mlswe=SHEAR_AD))
            s1 = m1.run(m1.state0, n)
        m0 = Model(main_path_config(32, dtype))
        s0 = m0.run(m0.state0, n)
        du = float((s1.q_df[1:] - s0.q_df[1:]).abs().max())
        out["shear"][f"du_max_{dtype}"] = du
        out["shear"][f"du_over_scale_{dtype}"] = du / float(s0.q_df[1:].abs().max())
    if not out["shear"]["du_max_float64"] > 0.0:
        raise AssertionError("the shear stress did not change the layer momenta")
    del sg, s0, s1, m0, m1
    w, wa, _, route = check_mega_vs_plain(cfg, F32_MEGA_TOL, seed=53, inputs=stepped_inputs)
    out["shear"]["mega_vs_plain"] = {"max_err_over_scale": w, "max_abs_err": wa, "route": route}
    for name, over, path in (("botfr2_mega_32", dict(botfr=2), dict(mega=True)),
                             ("botfr2_fused_64", dict(botfr=2, mega="off", fused_tail="on"),
                              dict(fused=True))):
        nel = 32 if path.get("mega") else 64
        m = Model(main_path_config(nel, "float32", **over))
        check_path(m, name, **path)
        run, s = drive(m, warm=1, steps=3)
        out[name] = {"run": run, "replay": replay_profile(m, s)}
        del m, s
    torch.cuda.empty_cache()
    per_stage = small_config(12, 12, "float64", 2)
    ref = eager_steps(per_stage, 2)
    out["botfr2_vs_per_stage_f64"] = {}
    for name, other in (("mega", small_config(12, 12, "float64", 2, mega="on")),
                        ("fused", small_config(12, 12, "float64", 2, fused_tail="on"))):
        err, statics = step_paths(other, per_stage, 2, STEP_TOL,
                                  f"botfr=2 f64 12x12, {name} vs per-stage path", b=ref)
        if (statics[0].mega, statics[0].fused_tail) != (name == "mega", name == "fused"):
            raise AssertionError(f"botfr=2 12x12: expected the {name} path")
        out["botfr2_vs_per_stage_f64"][name] = err
    return out



# ---- domain decomposition (phases 27, 27b) and the native front end (28) -----

DECOMP_SHAPE = (2, 2)
DECOMP_STEPS = 2      # eager steps of each decomposed case (the second is timed)
# split vs serial on the card, each field over its max (a channel that holds a
# perturbation, pb' or δdp, carries the rounding of the full variable it was
# formed from, as in the option tests' f32 gate); the per-channel errors are
# printed beside. f32: the option tests' f32 gate; f64: the CPU tests'
# per-channel gate of a split run (they measure 0: bitwise). On the card a
# split run is bitwise only where the matrix library rounds a block's
# products as it rounds the whole grid's: the plain PyTorch contractions
# (torch.einsum, elements in the batch) take other library kernels at other
# batch sizes (library_slice_check, --split-probe); the port's own kernels
# give a block bitwise what they give the whole grid.
DECOMP_F32_TOL = 1e-4
DECOMP_F64_TOL = 1e-12
DECOMP_TIMEOUT = 600.0
DECOMP_TURN_STEPS = 3  # steps of each timed turn over NCCL (eager, graph, graph, eager)
CLI_MESH_STEPS = 3    # steps of phase 28's decomposed CLI run


def decomposed_cases():
    """(name, config, tolerance): the bench configuration at full width,
    128x128 f32 (64x64 a block at 2x2: each block takes the flat face axis,
    the whole grid the per-direction faces), on the per-stage and on the
    fused path; and 32x32 f64 with a no-slip west and a copy east side (the
    wall masks of kernel U are per block; walls hide signs)."""
    import dataclasses

    big = main_path_config(128, "float32", mega="off")
    small = main_path_config(32, "float64", mega="off", x_boundary=(2, 0))
    return [("128_f32_per_stage", big, DECOMP_F32_TOL),
            ("128_f32_fused", dataclasses.replace(big, fused_tail="on"), DECOMP_F32_TOL),
            ("32_f64_walls20_per_stage", small, DECOMP_F64_TOL),
            ("32_f64_walls20_fused", dataclasses.replace(small, fused_tail="on"),
             DECOMP_F64_TOL)]


def on_self_axes(m, dec):
    """Close model `m`'s faces through `self_axes` (phase 27c)."""
    from hnumo_tpu_torch.core.faces import BCs

    ax = self_axes(dec)
    m.bc = BCs(*m.bc[:4], ax["x"], ax["y"])
    m._build_operators()


def graphed_block(dec, cfg, m, s, steps, self_exchange=False):
    """Over NCCL, beside the eager model `m` of a rank whose state after
    `steps` steps from its initial state is `s`: a graphed model of `cfg`
    (the default under NCCL) stepped as far, its captured graph's nodes kept
    (Model.keep_graph). Returns its readings and, under `failures`, the
    gates it failed (the caller raises once the readings are printed):
    - its first step's launches (warm-up and capture) twice the path's;
    - its state bitwise `s`;
    - the captured graph's kernel nodes (`graph_kernels`, what every replay
      launches): the path's kernels, no megakernel, and one NCCL
      point-to-point kernel per posting call of the eager step's plan
      (Decomposition.plan);
    - one replay traced, its output bitwise that of an eager step of `m`
      from the same state, and the path's kernels counted in its trace.
      NCCL's kernels in the trace are recorded beside the graph's, not
      gated: on four GPUs traces have held one to three SendRecv launches
      fewer than the posting calls (PERF.md, section 7).
    Then both models' ms/step timed in turns (eager, graph, graph, eager;
    DECOMP_TURN_STEPS steps each, the ranks meeting before each turn).
    Every rank makes the same calls in the same order. `self_exchange`: the
    graphed model's faces are closed through `self_axes`, as `m`'s are
    (phase 27c)."""
    from torch.profiler import ProfilerActivity, profile

    from hnumo_tpu_torch.model import Model

    mg = Model(cfg, decomp=dec)
    if self_exchange:
        on_self_axes(mg, dec)
    if mg.step_impl != "graph":
        raise AssertionError(f"a model over NCCL took step_impl {mg.step_impl!r}")
    mg.keep_graph = True
    fails = []
    wrappers = zero_counts()
    sg = mg.run(mg.state0, steps)
    at_capture = {k: fn.launches for k, fn in wrappers.items()}
    per_step = path_launches_per_step(mg)
    want = {k: per_step.get(k, 0) for k in KERNEL_SYMBOLS}
    if at_capture != {k: 2 * v for k, v in want.items()}:
        fails.append(f"rank {dec.rank}: the first graphed step launched {at_capture}, "
                     f"expected twice {per_step}")

    def differ(a, b, what):
        for f in ("qb_df", "q_df", "qprime_df"):
            x, y = getattr(a, f), getattr(b, f)
            if not torch.equal(x, y):
                diff = float((x.double() - y.double()).abs().max())
                fails.append(f"rank {dec.rank}: {what}: {f} differs, max |diff| {diff:.3e}")
                return True
        return False

    bitwise = not differ(sg, s, f"graphed vs eager after {steps} steps")
    nodes = graph_kernels(mg._graph[0])
    graph_counts = graph_path_counts(nodes)
    graph_nccl = {k: n for k, n in nodes.items() if "nccl" in k.lower()}
    dec.plan = []
    se = m.step(s)
    plan, dec.plan = dec.plan, None
    posting = sum(e.posts for e in plan)
    if graph_counts != want or sendrecv_launches(graph_nccl) != posting:
        fails.append(f"rank {dec.rank}: the captured graph holds {graph_counts} and NCCL "
                     f"{graph_nccl}; expected {want} and {posting} point-to-point kernels")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sg = mg.step(sg)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    traced = {name: sum(e.count for e in rows if sym in e.key)
              for name, sym in KERNEL_SYMBOLS.items()}
    kernels = nccl_kernels(prof)
    replay_bitwise = not differ(sg, se, "the traced replay vs an eager step from its state")
    if traced != want:
        fails.append(f"rank {dec.rank}: the traced replay ran {traced}, expected {want}")
    models, states = {"eager": m, "graph": mg}, {"eager": se, "graph": sg}
    ms = {"eager": [], "graph": []}
    for impl in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        dec.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states[impl] = models[impl].run(states[impl], DECOMP_TURN_STEPS)
        torch.cuda.synchronize()
        ms[impl].append((time.perf_counter() - t0) / DECOMP_TURN_STEPS * 1e3)
    return {"launches_at_capture": at_capture, "bitwise": bitwise,
            "replay_bitwise": replay_bitwise, "graph_kernels": graph_counts,
            "graph_nccl": graph_nccl, "nccl_sendrecv_nodes": sendrecv_launches(graph_nccl),
            "replay_kernels": traced, "nccl_kernels": kernels,
            "nccl_sendrecv_traced": sendrecv_launches(kernels),
            "posting_calls_per_step": posting, "exchange_calls_per_step": len(plan),
            "ms_eager": ms["eager"], "ms_graph": ms["graph"], "failures": fails}


def decomposed_ranks(dec, cases, steps, graphed=False):
    """A rank of phases 27, 27b and 27d: each case's model on this rank's
    block, eager (named: over NCCL the default is the graph); the launch
    counters zeroed just before its first step and read after its last; the
    exchange plan of its first step recorded (Decomposition.plan); the last
    step timed (all ranks start it together). With `graphed` (NCCL), the
    graphed model of the case beside it (`graphed_block`). Returns per case
    this rank's counts, its expected counts, its ms/step, its share of the
    mass before and after, its exchange and posting calls per step, and on
    rank 0 the plan and the gathered final state (CPU tensors)."""
    from hnumo_tpu_torch.model import Model

    out = {}
    for name, cfg, _ in cases:
        m = Model(cfg, decomp=dec, step_impl="eager")
        if m.static.mega or m.static.volume_impl != "kernel":
            raise AssertionError(f"{name}: rank {dec.rank} is not on the eager kernel path")
        s = m.state0
        mass0 = total_mass(m, s)      # this block's share: the shares add up
        calls0 = dec.exchange_calls
        wrappers = zero_counts()
        dec.plan = []
        s = m.run(s, 1)
        plan, dec.plan = dec.plan, None
        s = m.run(s, steps - 2)
        torch.cuda.synchronize()
        dec.barrier()
        t0 = time.perf_counter()
        s = m.run(s, 1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: fn.launches for k, fn in wrappers.items()}
        want = {k: steps * v for k, v in path_launches_per_step(m).items()}
        finite = all(bool(torch.isfinite(getattr(s, f)).all())
                     for f in ("qb_df", "q_df", "qprime_df"))
        res = dict(
            counts=counts, want=want, ms_per_step=ms, mass0=mass0,
            mass=total_mass(m, s), finite=finite, ok=bool(s.ok),
            exchange_calls_per_step=(dec.exchange_calls - calls0) / steps,
            posting_calls_per_step=sum(e.posts for e in plan),
            plan=plan if dec.rank == 0 else None,
            block=tuple(m.g.wjac.shape[:2]), transport=dec.transport,
            batched_faces=m.static.batched_faces, fused=m.static.fused_tail)
        whole = m.gather(s)
        res["state"] = None if whole is None else {f: getattr(whole, f) for f in
                                                   ("qb_df", "q_df", "qprime_df")}
        if graphed:
            res["graph"] = graphed_block(dec, cfg, m, s, steps)
        out[name] = res
        del m, s, whole
        torch.cuda.empty_cache()
    return out


def serial_references(cases, steps):
    """The same cases on one model over the whole grid, eager on the card:
    (final states, ms of the last step, path facts)."""
    from hnumo_tpu_torch.model import Model

    refs = {}
    for name, cfg, _ in cases:
        m = Model(cfg, step_impl="eager")
        run, s = drive(m, warm=steps - 1, steps=1)
        refs[name] = dict(state=s, ms_per_step=run["ms_per_step"],
                          batched_faces=m.static.batched_faces, counts=run["counts"])
        del m
        torch.cuda.empty_cache()
    return refs


def check_decomposed(cases, refs, shape, backend, nranks_gpu, graphed=False):
    """Phase 27 (27b, 27d): run the cases split `shape` over `backend` ranks
    and hold each against its serial reference: per channel within the
    case's tolerance of its max, mass change within MASS_TOL, finite, `ok`,
    and on every rank the launches of its path (kernel 1, or A, F and U, 200
    a step each; never the megakernel). `graphed` (NCCL): every rank's
    graphed model too (`graphed_block`: bitwise the eager one, its captured
    graph's and a traced replay's kernels, ms/step in turns). The gates a
    run fails are listed under `failures`: the caller prints the readings,
    then raises."""
    from hnumo_tpu_torch.parallel.launch import start_function

    t0 = time.perf_counter()
    run = start_function("chip_smoke:decomposed_ranks", shape, backend, device="cuda",
                         kwargs=dict(cases=cases, steps=DECOMP_STEPS, graphed=graphed),
                         pythonpath=[pathlib.Path(__file__).resolve().parent])
    ranks = run.result(DECOMP_TIMEOUT)
    wall = time.perf_counter() - t0
    out, fails = {}, []
    for name, cfg, tol in cases:
        per_rank = [r[name] for r in ranks]
        for k, r in enumerate(per_rank):
            if r["counts"] != {n: r["want"].get(n, 0) for n in r["counts"]}:
                fails.append(f"{name}: rank {k} launched {r['counts']}, expected {r['want']}")
            if r["counts"]["btp_mega"] or not (r["finite"] and r["ok"]):
                fails.append(f"{name}: rank {k}: megakernel, non-finite or not ok")
        mass0 = sum(r["mass0"] for r in per_rank)
        drift = abs(sum(r["mass"] for r in per_rank) - mass0) / mass0
        if not drift <= MASS_TOL:
            fails.append(f"{name}: mass change {drift:.3e} > {MASS_TOL}")
        got = per_rank[0]["state"]
        want = refs[name]["state"]
        got = type(want)(**got, t=want.t, ok=want.ok)
        want = type(want)(*[t.cpu() for t in want])
        errs = compare_states(got, want, float("inf"), "")
        fails += [f"{name} split {shape} vs serial: {f}: {e:.3e} of the max > {tol:g}"
                  for f, e in errs.items() if not e <= tol]
        per_channel = compare_states(got, want, float("inf"), "", per_channel=True)
        steps = DECOMP_STEPS
        out[name] = dict(
            errs=errs, max_err=max(errs.values()), tol=tol, mass_drift=drift,
            max_err_per_channel=max(per_channel.values()),
            launches_per_rank_per_step={k: v // steps for k, v in
                                        per_rank[0]["counts"].items() if v},
            ms_per_step_ranks=[r["ms_per_step"] for r in per_rank],
            ms_per_step_serial=refs[name]["ms_per_step"],
            exchange_calls_per_step=per_rank[0]["exchange_calls_per_step"],
            posting_calls_per_step_ranks=[r["posting_calls_per_step"] for r in per_rank],
            plan=per_rank[0]["plan"],
            block=per_rank[0]["block"], transport=per_rank[0]["transport"],
            fused=per_rank[0]["fused"],
            batched_faces_block=per_rank[0]["batched_faces"],
            batched_faces_serial=refs[name]["batched_faces"])
        if graphed:
            g = [r["graph"] for r in per_rank]
            fails += [f"{name}: {f}" for x in g for f in x["failures"]]
            out[name]["graph"] = dict(
                steps_bitwise=DECOMP_STEPS, bitwise_ranks=[x["bitwise"] for x in g],
                replay_bitwise_ranks=[x["replay_bitwise"] for x in g],
                graph_kernels=g[0]["graph_kernels"], replay_kernels=g[0]["replay_kernels"],
                nccl_sendrecv_nodes_ranks=[x["nccl_sendrecv_nodes"] for x in g],
                nccl_sendrecv_traced_ranks=[x["nccl_sendrecv_traced"] for x in g],
                graph_nccl_rank0=g[0]["graph_nccl"], nccl_kernels_rank0=g[0]["nccl_kernels"],
                ms_eager_ranks=[x["ms_eager"] for x in g],
                ms_graph_ranks=[x["ms_graph"] for x in g])
    return {"cases": out, "wall_s": wall, "ranks": shape[0] * shape[1],
            "gpus": nranks_gpu, "backend": backend, "failures": fails}


def decomposition_text(d):
    def faces(v):
        if v["fused"]:
            return "faces in kernel F"
        return (f"faces {'flat' if v['batched_faces_block'] else 'per direction'}; whole "
                f"grid {'flat' if v['batched_faces_serial'] else 'per direction'}")

    def graph(v):
        g = v.get("graph")
        if g is None:
            return ""
        return (f"; graphed == eager bitwise per rank over {g['steps_bitwise']} steps "
                f"{g['bitwise_ranks']} and in a traced replay {g['replay_bitwise_ranks']}; "
                f"captured graph {nonzero(g['graph_kernels'])} and NCCL SendRecv nodes per "
                f"rank {g['nccl_sendrecv_nodes_ranks']} for posting calls "
                f"{v['posting_calls_per_step_ranks']}; traced replay "
                f"{nonzero(g['replay_kernels'])}, SendRecv launches traced per rank "
                f"{g['nccl_sendrecv_traced_ranks']}; ms/step in turns (eager, graph, "
                f"graph, eager) per rank " + ", ".join(
                    f"[{e[0]:.1f}, {gr[0]:.1f}, {gr[1]:.1f}, {e[1]:.1f}]"
                    for e, gr in zip(g["ms_eager_ranks"], g["ms_graph_ranks"])))

    return "; ".join(
        f"{k}: block {v['block'][0]}x{v['block'][1]} ({faces(v)}), launches per rank "
        f"per step {json.dumps(v['launches_per_rank_per_step'])}, exchange calls per "
        f"step {v['exchange_calls_per_step']:.0f}, vs serial max per field "
        f"{v['max_err']:.2e} (tol {v['tol']:g}; per channel "
        f"{v['max_err_per_channel']:.2e}), mass change {v['mass_drift']:.2e}, "
        f"ms/step ranks {', '.join(f'{t:.0f}' for t in v['ms_per_step_ranks'])} "
        f"against serial eager {v['ms_per_step_serial']:.1f}" + graph(v)
        for k, v in d["cases"].items())


# ---- phase 27c: the capture of the exchange, on one GPU ----------------------

SELF_REPLAYS = 4      # replays of each plan, `ok` true and false in turns
SELF_TIMED = 5        # eager runs and replays of each plan timed, in turns
SELF_MODEL_STEPS = 2  # steps of the self-exchanging periodic model, graphed and eager
SELF_MODEL_NEL = 64
SELF_TIMEOUT = 600.0


def self_axes(dec):
    """An Axis per direction that exchanges with this rank itself (one block,
    periodic): every call posts a send and a receive to itself, which NCCL
    allows. A 1x1 decomposition's own axes are None and post nothing."""
    from hnumo_tpu_torch.parallel.sharding import Axis

    return {name: Axis(name, 1, 0, dec.rank, dec.rank, True, dec) for name in ("x", "y")}


def nccl_kernels(prof) -> dict:
    """{kernel name: launches} of the NCCL kernels in a trace."""
    return {e.key: e.count for e in device_rows(prof) if "nccl" in e.key.lower()}


def sendrecv_launches(kernels: dict) -> int:
    """Launches of NCCL's point-to-point kernel among `nccl_kernels`."""
    return sum(n for k, n in kernels.items() if "sendrecv" in k.lower())


def replay_plan(dec, axes, plan, seed):
    """One rank's exchange plan of a step (Exchange records, in order) posted
    against the self axes, with the `ok` all-reduce last, captured into one
    CUDA graph as Model captures its step (model.capture_graph). Every slab
    is a slice of a source buffer per dtype, and each received slab is
    copied at once into the same slice of a destination buffer; before
    every replay the sources take new random numbers, the destinations NaN,
    and `ok` true or false in turns. Gates: every replay
    receives bitwise what it sent, the all-reduce returns `ok`, and the
    captured graph holds one NCCL point-to-point kernel per call
    (`graph_kernels`; a replay's trace is counted beside it). Times the plan
    posted eagerly and replayed, in turns."""
    from torch.profiler import ProfilerActivity, profile

    from hnumo_tpu_torch.model import capture_graph

    dev = dec.device
    sizes = [int(np.prod(e.shape)) for e in plan]
    offsets, total = [], {}
    for e, n in zip(plan, sizes):
        offsets.append(total.get(e.dtype, 0))
        total[e.dtype] = offsets[-1] + n
    src = {dt: torch.empty(n, dtype=dt, device=dev) for dt, n in total.items()}
    dst = {dt: torch.empty_like(t) for dt, t in src.items()}
    ok_in = torch.ones((), dtype=torch.bool, device=dev)

    def post():
        for e, off, n in zip(plan, offsets, sizes):
            got = axes[e.axis].exchange(src[e.dtype][off:off + n].view(e.shape),
                                        e.from_prev)
            dst[e.dtype][off:off + n].view(e.shape).copy_(got)
        return dec.all_and(ok_in)

    gen = torch.Generator(device=dev).manual_seed(seed)

    def refill(ok: bool):
        for dt in src:
            src[dt].normal_(generator=gen)
            dst[dt].fill_(float("nan"))
        ok_in.fill_(ok)

    def check(ok_out, ok: bool, what):
        torch.cuda.synchronize(dev)
        if not all(torch.equal(dst[dt], src[dt]) for dt in src):
            raise AssertionError(f"{what}: a received slab is not the slab sent")
        if bool(ok_out) != ok:
            raise AssertionError(f"{what}: all_and gave {bool(ok_out)} for ok={ok}")

    refill(False)
    check(post(), False, "eager")
    graph, ok_out = capture_graph(post, dev, dec, keep_graph=True)
    nodes = {k: n for k, n in graph_kernels(graph).items() if "nccl" in k.lower()}
    if sendrecv_launches(nodes) != len(plan):
        raise AssertionError(f"the capture of {len(plan)} exchange calls holds the NCCL "
                             f"kernels {nodes}")
    for k in range(SELF_REPLAYS):
        ok = k % 2 == 0
        refill(ok)
        graph.replay()
        check(ok_out, ok, f"replay {k}")
    ms = {"eager": [], "graph": []}
    for impl in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(SELF_TIMED):
            if impl == "eager":
                post()
            else:
                graph.replay()
        torch.cuda.synchronize(dev)
        ms[impl].append((time.perf_counter() - t0) / SELF_TIMED * 1e3)
    refill(True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize(dev)
    check(ok_out, True, "the traced replay")
    kernels = nccl_kernels(prof)
    del graph
    return {"calls": len(plan),
            "bytes": sum(n * src[e.dtype].element_size() for e, n in zip(plan, sizes)),
            "replays_bitwise": SELF_REPLAYS, "ms_eager": ms["eager"],
            "ms_graph": ms["graph"], "graph_nccl": nodes,
            "nccl_sendrecv_traced": sendrecv_launches(kernels)}


def self_exchange_model(dec, cfg, steps):
    """A periodic model of the whole grid on a one-rank NCCL group whose faces
    are closed through `self_axes`, so that its step posts every halo
    exchange of a split step (to itself) and the `ok` all-reduce: `steps`
    eager steps against the serial model (whose periodic wrap posts
    nothing), then `graphed_block` beside it (graphed bitwise eager, one
    replay's kernels and NCCL launches, ms/step in turns)."""
    from hnumo_tpu_torch.model import Model

    m = Model(cfg, decomp=dec, step_impl="eager")
    on_self_axes(m, dec)
    serial = Model(cfg, step_impl="eager")
    s = m.run(m.state0, steps)
    vs_serial = compare_states(s, serial.run(serial.state0, steps), DECOMP_F32_TOL,
                               "self axes vs serial")
    del serial
    return {"steps_bitwise": steps, "vs_serial": vs_serial, "fused": m.static.fused_tail,
            **graphed_block(dec, cfg, m, s, steps, self_exchange=True)}


def self_exchange_rank(dec, plans, model_cases):
    """Phase 27c's rank (a one-rank NCCL group): each plan of `plans` (name
    -> Exchange records) replayed by `replay_plan`, then each of
    `model_cases` ((name, config)) by `self_exchange_model`."""
    out = {"plans": {}, "models": {}}
    for k, (name, plan) in enumerate(plans.items()):
        out["plans"][name] = replay_plan(dec, self_axes(dec), plan, seed=100 + k)
    for name, cfg in model_cases:
        out["models"][name] = self_exchange_model(dec, cfg, SELF_MODEL_STEPS)
        torch.cuda.empty_cache()
    return out


def self_exchange_cases():
    """Phase 27c's models: the bench configuration doubly periodic at
    SELF_MODEL_NEL, fused and per stage, f32."""
    import dataclasses

    cfg = main_path_config(SELF_MODEL_NEL, "float32", mega="off", x_boundary=(3, 3),
                           y_boundary=(3, 3))
    return [(f"{SELF_MODEL_NEL}_f32_periodic_fused", dataclasses.replace(cfg, fused_tail="on")),
            (f"{SELF_MODEL_NEL}_f32_periodic_per_stage", cfg)]


def check_self_exchange(plans, model_cases):
    """Phase 27c: `self_exchange_rank` on a one-rank NCCL group."""
    from hnumo_tpu_torch.parallel.launch import start_function

    run = start_function("chip_smoke:self_exchange_rank", (1, 1), "nccl", device="cuda",
                         kwargs=dict(plans=plans, model_cases=model_cases),
                         pythonpath=[pathlib.Path(__file__).resolve().parent])
    return run.result(SELF_TIMEOUT)[0]


def self_exchange_text(d):
    return "; ".join(
        [f"{k} plan ({v['calls']} calls, {v['bytes'] / 1e6:.2f} MB a replay): "
         f"{v['replays_bitwise']} replays and a traced one received bitwise what they "
         f"sent, all_and right for ok true and false, captured graph's NCCL kernel nodes "
         f"{json.dumps(v['graph_nccl'])}, SendRecv launches traced in a replay "
         f"{v['nccl_sendrecv_traced']}, "
         f"ms eager {', '.join(f'{t:.2f}' for t in v['ms_eager'])} / graphed "
         f"{', '.join(f'{t:.2f}' for t in v['ms_graph'])}"
         for k, v in d["plans"].items()]
        + [f"{k} on self axes: graphed == eager bitwise over {v['steps_bitwise']} steps "
           f"{v['bitwise']} and in a traced replay {v['replay_bitwise']}; captured graph "
           f"{nonzero(v['graph_kernels'])} and NCCL {json.dumps(v['graph_nccl'])} for "
           f"{v['posting_calls_per_step']} posting calls; traced replay "
           f"{nonzero(v['replay_kernels'])}, SendRecv launches traced "
           f"{v['nccl_sendrecv_traced']}; vs serial max per field "
           f"{max(v['vs_serial'].values()):.2e}, ms/step in "
           f"turns (eager, graph, graph, eager) [{v['ms_eager'][0]:.1f}, "
           f"{v['ms_graph'][0]:.1f}, {v['ms_graph'][1]:.1f}, {v['ms_eager'][1]:.1f}]"
           for k, v in d["models"].items()])


def decomposed_cases_256():
    """Phase 27d: the double gyre at full width, 256x256 f32, fused and per
    stage (128x128 a block at 2x2, above 8192 elements: per-direction faces
    on both sides)."""
    import dataclasses

    cfg = main_path_config(256, "float32", mega="off")
    return [("256_f32_fused", dataclasses.replace(cfg, fused_tail="on"), DECOMP_F32_TOL),
            ("256_f32_per_stage", cfg, DECOMP_F32_TOL)]


DECOMP_PHASES = ("27", "27b", "27c", "27d")


def decomposition_phases(smi, phases=DECOMP_PHASES):
    """Phases 27, 27b, 27c and 27d (those of `phases`; 27c replays 27's
    exchange plans and takes 27 with it), each printing its line; returns
    their readings (None where a phase was not asked for or needs more GPUs
    than the machine shows). The gates a phase fails are printed after its
    line, and raised once every phase has run."""
    if "27c" in phases and "27" not in phases:
        raise ValueError("phase 27c replays phase 27's exchange plans: ask for 27 too")
    fails = []

    def report(phase, failures):
        for f in failures:
            print(f"phase {phase} FAILED: {f}")
        fails.extend(f"phase {phase}: {f}" for f in failures)

    # ---- phase 27: domain decomposition on the card, ranks sharing it -------
    t_phase = time.perf_counter()
    ngpu = torch.cuda.device_count()
    dcases = decomposed_cases()
    dec27 = drefs = None
    if "27" in phases or "27b" in phases:
        drefs = serial_references(dcases, DECOMP_STEPS)
    if "27" not in phases:
        print("phase 27 gloo, ranks sharing the GPUs: not asked for")
    else:
        dec27 = check_decomposed(dcases, drefs, DECOMP_SHAPE, "gloo", min(ngpu, 4))
        print(f"phase 27 ({time.perf_counter() - t_phase:.1f} s) domain decomposition "
              f"{DECOMP_SHAPE[0]}x{DECOMP_SHAPE[1]}, {dec27['ranks']} ranks sharing "
              f"{'cuda:0' if ngpu == 1 else f'{min(ngpu, 4)} GPUs'} over gloo with host-staged "
              f"halos ({dec27['cases']['128_f32_per_stage']['transport']}), {DECOMP_STEPS} eager "
              f"steps a case, the last timed: a correctness run, not a scaling number; "
              + decomposition_text(dec27))
        report("27", dec27["failures"])

    # ---- phase 27b: the NCCL transport (one GPU per rank), eager and graphed --
    dec27b = None
    if "27b" not in phases:
        print("phase 27b NCCL transport: not asked for")
    elif ngpu >= 2:
        shape_b = (2, 2) if ngpu >= 4 else (1, 2)
        t_phase = time.perf_counter()
        dec27b = check_decomposed(dcases, drefs, shape_b, "nccl", shape_b[0] * shape_b[1],
                                  graphed=True)
        print(f"phase 27b ({time.perf_counter() - t_phase:.1f} s) NCCL {shape_b[0]}x"
              f"{shape_b[1]}, one GPU per rank, eager and graphed: "
              + decomposition_text(dec27b) + f" | {smi}")
        report("27b", dec27b["failures"])
    else:
        print(f"phase 27b NCCL transport: not run: this machine shows {ngpu} CUDA device "
              f"and NCCL takes one GPU per rank (two ranks on one device are refused); "
              f"not counted as passed")
    del drefs
    torch.cuda.empty_cache()

    # ---- phase 27c: the capture of the exchange on one GPU --------------------
    self27c = None
    if "27c" not in phases:
        print("phase 27c the capture on one GPU: not asked for")
    else:
        t_phase = time.perf_counter()
        plans = {f"{k}_rank0": v["plan"] for k, v in dec27["cases"].items()
                 if k.startswith("128_")}
        self27c = check_self_exchange(plans, self_exchange_cases())
        print(f"phase 27c ({time.perf_counter() - t_phase:.1f} s) the split step's capture on "
              f"one GPU: a one-rank NCCL group whose axes exchange with the rank itself (every "
              f"call posts a send and a receive), phase 27's {DECOMP_SHAPE[0]}x{DECOMP_SHAPE[1]} "
              f"exchange plans of rank 0 and the all-reduce captured into one CUDA graph and "
              f"replayed: " + self_exchange_text(self27c) + f" | {smi}")
        report("27c", [f"{k}: {f}" for k, v in self27c["models"].items() for f in v["failures"]])

    # ---- phase 27d: the double gyre at 256x256 split 2x2 over NCCL -----------
    dec27d = None
    if "27d" not in phases:
        print("phase 27d 256x256 split 2x2 over NCCL: not asked for")
    elif ngpu >= 4:
        t_phase = time.perf_counter()
        cases256 = decomposed_cases_256()
        refs256 = serial_references(cases256, DECOMP_STEPS)
        serial_turns = {name: time_in_turns(cfg, DECOMP_TURN_STEPS)
                        for name, cfg, _ in cases256}
        dec27d = check_decomposed(cases256, refs256, DECOMP_SHAPE, "nccl", 4, graphed=True)
        dec27d["serial_turns"] = {k: {"ms_eager": v["ms_eager"], "ms_graph": v["ms_graph"]}
                                  for k, v in serial_turns.items()}
        del refs256
        torch.cuda.empty_cache()
        print(f"phase 27d ({time.perf_counter() - t_phase:.1f} s) the double gyre 256x256 "
              f"f32 split 2x2 over NCCL, one GPU per rank: " + decomposition_text(dec27d)
              + "; serial on cuda:0, ms/step in turns (eager, graph, graph, eager): "
              + "; ".join(f"{k} [{v['ms_eager'][0]:.1f}, {v['ms_graph'][0]:.1f}, "
                          f"{v['ms_graph'][1]:.1f}, {v['ms_eager'][1]:.1f}]"
                          for k, v in dec27d["serial_turns"].items()) + f" | {smi}")
        report("27d", dec27d["failures"])
    else:
        print(f"phase 27d 256x256 split 2x2 over NCCL: not run: this machine shows {ngpu} "
              f"CUDA device(s), it takes 4; not counted as passed")
    if fails:
        raise AssertionError(f"{len(fails)} decomposition gate(s) failed: " + "; ".join(fails))
    return dec27, dec27b, self27c, dec27d


def _fin_numbers(path) -> list[float]:
    import re

    nums = []
    for line in pathlib.Path(path).read_text().splitlines():
        if "Max/Min" in line:
            nums += [float(x) for x in re.findall(r"-?0\.\d+E[+-]\d+", line)]
    return nums


def check_native_and_cli_mesh(tmp, native_calls):
    """Phase 28: the native C++ front end (mesh/_native.py) took phase 21's
    MSH file (`native_calls`: its calls during phases 20-21), and its
    geometry is bitwise the pure-Python path's on the same file; then the
    CLI decomposed 2x2 at 32x32 f64 (four ranks over gloo on the card's
    GPUs, halos staged through host memory where they share one) against
    the serial CLI on the same namelist: the FIN file's values, and the
    final snapshot's, to 1e-9 of their scale."""
    from hnumo_tpu_torch.mesh import _native, gmsh
    from hnumo_tpu_torch.mesh.grid import Geometry

    import dataclasses

    if not _native.available():
        raise AssertionError("the native mesh front end is off (HNUMO_NATIVE=0 or no g++)")
    if native_calls["read_msh"] < 1 or native_calls["infer_structured_layout"] < 1:
        raise AssertionError(f"phase 21 read its mesh without the native path: {native_calls}")
    length = main_path_config(32, "float32").xdims[1]
    msh = write_msh(tmp / "basin.msh", 32, length, CURV_DEFORM, lambda x, y: -9928.0 + 0 * x)
    gn, zn = gmsh.geometry_from_msh(msh, 4, native=True)
    gp, zp = gmsh.geometry_from_msh(msh, 4, native=False)
    for f in dataclasses.fields(Geometry):
        a, b = getattr(gn, f.name), getattr(gp, f.name)
        if isinstance(a, np.ndarray) and not np.array_equal(a, b):
            raise AssertionError(f"native and Python geometry differ in {f.name}")
    if not np.array_equal(zn, zp):
        raise AssertionError("native and Python bathymetry differ")

    cfg = main_path_config(32, "float64", mega="off")
    nml = write_namelist(tmp / "mesh.in", cfg, time_final=CLI_MESH_STEPS * cfg.dt,
                         time_restart=CLI_MESH_STEPS * cfg.dt)
    walls = {}
    for name, extra in (("serial", []), ("mesh", ["--mesh", "2x2", "--backend", "gloo"])):
        out = tmp / name
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "hnumo_tpu_torch", str(nml), "--outdir",
                            str(out), "--quiet", *extra], capture_output=True, text=True,
                           timeout=600)
        walls[name] = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"CLI {name} exited {r.returncode}:\n{r.stdout[-3000:]}"
                                 f"{r.stderr[-3000:]}")
    fin = {k: np.array(_fin_numbers(tmp / k / "mlswe_FIN.txt")) for k in walls}
    if fin["serial"].shape != fin["mesh"].shape or fin["serial"].size == 0:
        raise AssertionError("the two FIN files hold different fields")
    fin_err = float(np.abs(fin["mesh"] - fin["serial"]).max() / np.abs(fin["serial"]).max())
    last = f"mlswe{CLI_MESH_STEPS:04d}"
    snaps = {k: np.loadtxt(tmp / k / last, skiprows=2) for k in walls}
    snap_err = float(np.abs(snaps["mesh"] - snaps["serial"]).max()
                     / np.abs(snaps["serial"]).max())
    if not (fin_err <= 1e-9 and snap_err <= 1e-9):
        raise AssertionError(f"CLI --mesh 2x2 vs serial: FIN {fin_err:.3e}, snapshot "
                             f"{snap_err:.3e} (limit 1e-9)")
    return dict(native_calls=native_calls, geometry_bitwise=True, fin_err=fin_err,
                snapshot_err=snap_err, wall_s=walls, library=str(_native.library_path().name))


# ---- where a split f32 run leaves the serial one (--split-probe) -----------------

# the port's modules whose functions one step runs: the probe wraps each
PROBE_MODULES = ("hnumo_tpu_torch.core.stepper", "hnumo_tpu_torch.core.bcl",
                 "hnumo_tpu_torch.core.btp", "hnumo_tpu_torch.core.coupling",
                 "hnumo_tpu_torch.core.viscosity", "hnumo_tpu_torch.core.faces",
                 "hnumo_tpu_torch.ops.dg", "hnumo_tpu_torch.ops.btp_volume",
                 "hnumo_tpu_torch.ops.btp_volume_uni", "hnumo_tpu_torch.ops.btp_tail")


def _tensors(x):
    """The tensors in a function's result, in order (tuples, NamedTuples,
    lists and dicts walked)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for k in sorted(x, key=str) for t in _tensors(x[k])]
    return []


class FunctionRecorder:
    """Wraps every function of PROBE_MODULES (wherever a module of that set
    holds it) while active. For each function it counts the calls (`calls`)
    and notes the order of their first returns (`order`). What the first
    call returned (for a function that returns nothing: its tensor
    arguments after the call, which it updated in place) is kept in `first`,
    cloned on the device; or, given `compare`, handed at once to
    `compare(key, tensors)`, whose answer is kept in `results`."""

    def __init__(self, compare=None):
        self.calls, self.order, self.compare = {}, [], compare
        self.first, self.results = {}, {}

    def __enter__(self):
        import functools
        import importlib

        mods = [importlib.import_module(n) for n in PROBE_MODULES]
        wrapped, self._saved = {}, []
        for mod in mods:
            for attr, fn in list(vars(mod).items()):
                if not (callable(fn) and getattr(fn, "__module__", None) in PROBE_MODULES
                        and type(fn).__name__ == "function"):
                    continue
                key = f"{fn.__module__.split('.', 1)[1]}.{fn.__qualname__}"
                if key not in wrapped:
                    def make(fn=fn, key=key):
                        @functools.wraps(fn)
                        def wrapper(*a, **k):
                            out = fn(*a, **k)
                            n = self.calls.get(key, 0)
                            self.calls[key] = n + 1
                            if n == 0:
                                got = _tensors(out) or _tensors(list(a) + list(k.values()))
                                self.order.append(key)
                                if self.compare is None:
                                    self.first[key] = [t.detach().clone() for t in got]
                                else:
                                    self.results[key] = self.compare(key, got)
                            return out
                        return wrapper
                    wrapped[key] = make()
                self._saved.append((mod, attr, fn))
                setattr(mod, attr, wrapped[key])
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


def serial_slice(S, B, grid, bounds):
    """The part of the serial grid's tensor `S` that is the block tensor
    `B`: the element rows/columns (or x-/y-faces, one more) of this block,
    found by shape, or a flat element axis (ney*nex) cut likewise. None
    where no axis matches."""
    (ny, nx), ((y0, y1), (x0, x1)) = grid, bounds
    by, bx = y1 - y0, x1 - x0
    if S.shape == B.shape:
        return S
    if S.ndim != B.ndim:
        return None
    for k in range(S.ndim - 1):
        a, b = S.shape[k], S.shape[k + 1]
        if (a - B.shape[k], b - B.shape[k + 1]) == (ny - by, nx - bx) and \
                a in (ny, ny + 1) and b in (nx, nx + 1) and \
                S.shape[:k] == B.shape[:k] and S.shape[k + 2:] == B.shape[k + 2:]:
            return S[(slice(None),) * k + (slice(y0, y0 + B.shape[k]),
                                           slice(x0, x0 + B.shape[k + 1]))]
    # a flat element axis (ney*nex), or the flat face axis: the x-faces
    # (ney, nex+1) then the y-faces (ney+1, nex), each flattened (core/btp._catf)
    fx, bfx = ny * (nx + 1), by * (bx + 1)
    for k in range(S.ndim):
        if S.shape[:k] != B.shape[:k] or S.shape[k + 1:] != B.shape[k + 1:]:
            continue
        lead, rest = S.shape[:k], S.shape[k + 1:]

        def cut(T, rows, cols, r0, c0, nr, nc):
            view = T.reshape(lead + (rows, cols) + rest)
            return view[(slice(None),) * k + (slice(r0, r0 + nr), slice(c0, c0 + nc))]

        if S.shape[k] == ny * nx and B.shape[k] == by * bx:
            return cut(S, ny, nx, y0, x0, by, bx).reshape(B.shape)
        if S.shape[k] == fx + (ny + 1) * nx and B.shape[k] == bfx + (by + 1) * bx:
            xs, ys = S.split([fx, S.shape[k] - fx], dim=k)
            return torch.cat([cut(xs, ny, nx + 1, y0, x0, by, bx + 1).reshape(
                                  lead + (bfx,) + rest),
                              cut(ys, ny + 1, nx, y0, x0, by + 1, bx).reshape(
                                  lead + (B.shape[k] - bfx,) + rest)], dim=k)
    return None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def split_stage_ranks(dec, cases):
    """A rank of the function-by-function probe: per case, this rank's
    block model takes one eager step with every function recorded (rank 0
    keeps the first call's results); then rank 0 steps the serial model
    over the whole grid and holds each function's first result, cut to
    block 0, against the block's. Returns (rank 0) per case the functions
    in call order with: calls (serial, block), shapes, bitwise, the largest
    difference over the cut serial tensor's max."""
    from hnumo_tpu_torch.model import Model

    out = {}
    for name, cfg in cases:
        with FunctionRecorder() as blk:
            m = Model(cfg, decomp=dec)
            s = m.step(m.state0)
            _sync(dec.device)
        del m, s
        dec.barrier()
        if dec.rank != 0:
            continue
        grid = (cfg.nely, cfg.nelx)
        bounds = dec.bounds(*grid)

        def compare(key, serial, blk=blk, grid=grid, bounds=bounds):
            block = blk.first.get(key)
            if block is None or len(block) != len(serial):
                return {"compared": False, "why": "block has no such call" if block is None
                        else f"{len(serial)} tensors in the serial result, {len(block)} "
                             "in the block's"}
            res = []
            for S, B in zip(serial, block):
                cut = serial_slice(S, B, grid, bounds)
                if cut is None or cut.dtype != B.dtype:
                    res.append({"serial": list(S.shape), "block": list(B.shape),
                                "compared": False})
                    continue
                equal = bool(torch.equal(cut, B))
                err = 0.0
                if not equal and cut.is_floating_point():
                    scale = float(cut.abs().max()) or 1.0
                    err = float((cut - B).abs().max()) / scale
                res.append({"serial": list(S.shape), "block": list(B.shape),
                            "compared": True, "bitwise": equal, "err": err})
            return {"compared": True, "tensors": res}

        with FunctionRecorder(compare) as ser:
            m = Model(cfg, device=dec.device, step_impl="eager")
            s = m.step(m.state0)
            _sync(dec.device)
        del m, s
        rows = []
        for key in ser.order:
            r = ser.results[key]
            tens = r.get("tensors", [])
            done = [t for t in tens if t["compared"]]
            rows.append({"function": key, "calls_serial": ser.calls[key],
                         "calls_block": blk.calls.get(key, 0),
                         "compared": len(done), "of": len(tens),
                         "bitwise": all(t["bitwise"] for t in done),
                         "err": max((t["err"] for t in done), default=0.0),
                         "shapes": [(t["serial"], t["block"]) for t in tens][:4],
                         "why": r.get("why")})
        out[name] = rows
        del blk, ser
        if dec.device.type == "cuda":
            torch.cuda.empty_cache()
    return out if dec.rank == 0 else None


def library_slice_check(device="cuda", seed=11):
    """The products of the plain PyTorch code on one block against the same
    products over the whole grid, cut to that block: the contraction of
    `ops/dg.scatter_volume` (a three-operand `torch.einsum`, elements in
    the batch) and a plain matrix product, on the same random numbers, at
    the grids of --split-probe (128x128 cut to 64x64, 32x32 to 16x16), in
    f32 and f64. Returns {case: largest difference over the max}: 0 where
    the library computes each element alike whatever the batch."""
    out = {}
    rng = np.random.default_rng(seed)
    for dtype in (torch.float32, torch.float64):
        ops = {k: torch.tensor(rng.normal(size=(5, 9)), dtype=dtype, device=device)
               for k in ("psiq", "dpsiq")}
        mat = torch.tensor(rng.normal(size=(9, 9)), dtype=dtype, device=device)
        for nel in (128, 32):
            a = torch.tensor(rng.normal(size=(2, nel, nel, 9, 9)), dtype=dtype, device=device)
            blk = a[:, :nel // 2, :nel // 2].contiguous()
            for name, fn in (
                    ("einsum ...JI,jJ,iI->...ji", lambda x: torch.einsum(
                        "...JI,jJ,iI->...ji", x, ops["psiq"], ops["dpsiq"])),
                    ("matmul (...,9,9)@(9,9)", lambda x: x @ mat)):
                whole = fn(a)[:, :nel // 2, :nel // 2]
                part = fn(blk)
                err = float((whole - part).abs().max() / whole.abs().max())
                out[f"{name} {nel}x{nel}->{nel // 2}x{nel // 2} "
                    f"{str(dtype).split('.')[1]}"] = err
    return out


def split_probe_cases():
    """(whole-run cases, function-by-function cases) of --split-probe: the
    bench configuration split 2x2 against the serial model, in both
    precisions at both sizes, and per stage with the flat face axis on both
    sides (at 128x128 "auto" gives the blocks the flat axis and the whole
    grid the per-direction one); then one step function by function, with
    one face pipeline on both sides."""
    def case(nel, dtype, **over):
        return main_path_config(nel, dtype, mega="off", **over)

    whole = [("128_f32_per_stage", case(128, "float32"), DECOMP_F32_TOL),
             ("128_f32_fused", case(128, "float32", fused_tail="on"), DECOMP_F32_TOL),
             ("128_f32_per_stage_flat_both", case(128, "float32", batched_faces="on"),
              DECOMP_F32_TOL),
             ("128_f64_per_stage", case(128, "float64"), DECOMP_F32_TOL),
             ("128_f64_fused", case(128, "float64", fused_tail="on"), DECOMP_F32_TOL),
             ("32_f32_per_stage", case(32, "float32"), DECOMP_F32_TOL),
             ("32_f32_fused", case(32, "float32", fused_tail="on"), DECOMP_F32_TOL)]
    by_function = [("128_f32_per_stage_per_direction_both",
                    case(128, "float32", batched_faces="off")),
                   ("128_f32_fused", case(128, "float32", fused_tail="on")),
                   ("128_f64_per_stage_per_direction_both",
                    case(128, "float64", batched_faces="off"))]
    return whole, by_function


def split_probe():
    """--split-probe: where a split f32 run leaves the serial one. Prints one
    line per whole-run case (2 eager steps, each field over its max, the
    face pipelines each side took) and per function-by-function case the
    functions whose first result differs (in call order), then returns
    {"whole": ..., "by_function": ...}."""
    from hnumo_tpu_torch.parallel.launch import start_function

    lib = library_slice_check()
    for k, v in lib.items():
        print(f"split-probe library {k}: block vs whole grid cut to it {v:.3e} of the max")
    whole, by_function = split_probe_cases()
    refs = serial_references(whole, DECOMP_STEPS)
    res = check_decomposed(whole, refs, DECOMP_SHAPE, "gloo", 1)
    del refs
    torch.cuda.empty_cache()
    for k, v in res["cases"].items():
        print(f"split-probe whole {k}: vs serial max per field {v['max_err']:.3e} "
              f"({json.dumps({f: float(f'{e:.3e}') for f, e in v['errs'].items()})}); "
              f"faces block {'flat' if v['batched_faces_block'] else 'per direction'}, "
              f"serial {'flat' if v['batched_faces_serial'] else 'per direction'}"
              f"{' (fused: faces in kernel F)' if v['fused'] else ''}")
    run = start_function("chip_smoke:split_stage_ranks", DECOMP_SHAPE, "gloo", device="cuda",
                         kwargs=dict(cases=by_function),
                         pythonpath=[pathlib.Path(__file__).resolve().parent])
    rows = run.result(DECOMP_TIMEOUT)[0]
    for name, fns in rows.items():
        differ = [r for r in fns if r["compared"] and not r["bitwise"]]
        unmatched = [r["function"] for r in fns if not r["compared"]]
        print(f"split-probe by function {name}: {len(fns)} functions in the first step, "
              f"{sum(1 for r in fns if r['compared'])} compared, {len(differ)} differ; "
              f"not compared: {', '.join(unmatched) or 'none'}")
        for r in differ[:12]:
            print(f"split-probe   {r['function']} (calls serial {r['calls_serial']}, block "
                  f"{r['calls_block']}): {r['err']:.3e} of the max; shapes "
                  f"{r['shapes']}")
    return {"library": lib, "whole": res, "by_function": rows}


# ---- the bench tool (phase 30) -------------------------------------------------
# (elements a side, nop), variants: hnumo_tpu_torch/tools/bench.py's runs at
# the megakernel's size (every path of p=4) and at p=8 (no megakernel there)
BENCH_RUNS = (((32, 4), ("default", "mega", "stage", "uni", "fused")),
              ((16, 8), ("stage", "uni", "fused")))
BENCH_STEPS = 3
BENCH_REPEATS = 2

# ---- the flat unstructured faces (phase 29) ------------------------------------

FLAT_NEL = 256         # the bench brick of phases 6 and 13: 65,536 elements
FLAT_SCATTER_TOL = {torch.float64: 1e-13, torch.float32: 1e-6}  # card vs CPU, of the max
FLAT_ADJOINT_TOL = {torch.float64: 1e-13, torch.float32: 1e-6}  # of the sum of |terms|
FLAT_COORD_TOL = 1e-14   # coordinate continuity, of the coordinates' max
FLAT_DEFORM = 0.3        # of a cell: the deformed brick's interior vertices
# the structured traces (core/faces) run a side's nodes in ascending i
# (y-faces) or j (x-faces); the flat tables run them counter-clockwise:
# the same order on sides 0 (south) and 1 (east), reversed on 2 (north)
# and 3 (west)
SIDE_REVERSED = (False, False, True, True)


def brick_mesh(nel: int, deform: float = 0.0, seed: int = 0):
    """An nel x nel brick in cells: vertices (V, 2) and CCW quads (E, 4) in
    the structured element order e = ey*nel + ex (corners SW, SE, NE, NW);
    `deform` moves the interior vertices at random by up to that fraction of
    a cell, from `seed`."""
    jj, ii = np.meshgrid(np.arange(nel + 1), np.arange(nel + 1), indexing="ij")
    verts = np.stack([ii, jj], -1).reshape(-1, 2).astype(float)
    if deform:
        inner = ((ii > 0) & (ii < nel) & (jj > 0) & (jj < nel)).reshape(-1)
        verts[inner] += deform * np.random.default_rng(seed).uniform(
            -1, 1, size=(int(inner.sum()), 2))
    v = (jj * (nel + 1) + ii)[:-1, :-1].reshape(-1)
    quads = np.stack([v, v + 1, v + nel + 2, v + nel + 1], -1)
    return verts, quads


def structured_in_flat_order(traces, faces, nelx: int):
    """The structured traces (xl, xr, yl, yr) of `extract_faces_stacked`
    gathered into the flat tables' order: (own, other), each (C, F, ngl),
    own = the trace of (elem_L, side_L), other = the one across that face,
    in the node order of `SIDE_REVERSED`."""
    xl, xr, yl, yr = traces
    dev = xl.device
    ey = torch.tensor(faces.elem_L // nelx, device=dev, dtype=torch.long)
    ex = torch.tensor(faces.elem_L % nelx, device=dev, dtype=torch.long)
    side = torch.tensor(faces.side_L, device=dev, dtype=torch.long)
    C, m = xl.shape[0], xl.shape[-1]
    own = torch.empty((C, len(side), m), dtype=xl.dtype, device=dev)
    other = torch.empty_like(own)
    # side: (own trace, other trace, y offset, x offset of the face)
    for s, (a, b, dy, dx) in enumerate(((yr, yl, 0, 0), (xl, xr, 0, 1),
                                        (yl, yr, 1, 0), (xr, xl, 0, 0))):
        sel = side == s
        ia, ib = ey[sel] + dy, ex[sel] + dx
        ta, tb = a[:, ia, ib], b[:, ia, ib]
        if SIDE_REVERSED[s]:
            ta, tb = ta.flip(-1), tb.flip(-1)
        own[:, sel], other[:, sel] = ta, tb
    return own, other


def check_flat_faces(nel: int = FLAT_NEL, device: str = "cuda"):
    """Phase 29: hnumo_tpu_torch/mesh/flatfaces.py on the card at the main
    path's width: the tables of an nel x nel brick built on the host, the
    fields on the card in f32 and f64 (the main-path model's state0 channels
    and random channels from a seed). Holds traces bitwise the CPU's,
    scatter_faces within FLAT_SCATTER_TOL of the CPU's (index_add_ may add
    into a corner node in another order), the adjoint identity, the flat
    traces bitwise the structured path's, and on the pinwheel and a deformed
    brick coordinate continuity (card) and unit normals (host, float64);
    times one extract_traces and one scatter_faces on the device.
    `device="cpu"` rehearses the checks on the CPU at a small `nel`, untimed
    (the "card" side then runs on the CPU as well)."""
    from hnumo_tpu_torch.basis.lgl import Basis1D
    from hnumo_tpu_torch.core.faces import BCs, extract_faces_stacked
    from hnumo_tpu_torch.mesh import flatfaces as ff
    from hnumo_tpu_torch.model import Model

    t0 = time.perf_counter()
    _, quads = brick_mesh(nel)
    b = Basis1D(4)
    ngl = b.ngl
    faces = ff.build_flat_faces(quads, ngl)
    build_s = time.perf_counter() - t0
    dev, host = faces.to(device), faces.to("cpu")
    E, F = len(quads), faces.idx_L.shape[0]
    if faces.n_interior != 2 * nel * (nel - 1) or F - faces.n_interior != 4 * nel:
        raise AssertionError(f"{nel}x{nel} brick: {faces.n_interior} interior and "
                             f"{F - faces.n_interior} boundary faces")
    out = {"elements": E, "faces": F, "interior_faces": faces.n_interior,
           "tables_build_s": build_s}
    for dtype in (torch.float32, torch.float64):
        m = Model(main_path_config(nel, str(dtype).split(".")[1]), device=device)
        st = m.state0
        fields = torch.cat([st.qb_df, st.q_df.flatten(0, 1), st.qprime_df.flatten(0, 1)])
        del m, st
        rng = np.random.default_rng(29)
        noise = torch.tensor(rng.normal(size=(4,) + fields.shape[1:]), dtype=dtype,
                             device=device)
        q = torch.cat([fields, noise])                   # (C, nel, nel, m, m)
        C = q.shape[0]
        u = q.reshape(C, E, ngl, ngl)
        uL, uR = ff.extract_traces(u, dev)
        cL, cR = ff.extract_traces(u.cpu(), host)
        if not (torch.equal(uL.cpu(), cL) and torch.equal(uR.cpu(), cR)):
            raise AssertionError(f"{dtype}: traces on the card differ from the CPU's")
        S = torch.tensor(rng.normal(size=(2, C, F, ngl)), dtype=dtype, device=device)
        SL, SR = S[0], S[1].clone()
        SR[:, torch.tensor(faces.is_boundary, device=device)] = 0.0
        rhs = torch.tensor(rng.normal(size=u.shape), dtype=dtype, device=device)
        rhs0 = rhs.clone()
        got = ff.scatter_faces(rhs, SL, SR, dev)
        want = ff.scatter_faces(rhs.cpu(), SL.cpu(), SR.cpu(), host)
        scatter_err = float((got.cpu() - want).abs().max() / want.abs().max())
        if not torch.equal(rhs, rhs0):
            raise AssertionError(f"{dtype}: scatter_faces changed the caller's rhs")
        if not scatter_err <= FLAT_SCATTER_TOL[dtype]:
            raise AssertionError(f"{dtype}: scatter_faces card vs CPU {scatter_err:.3e} > "
                                 f"{FLAT_SCATTER_TOL[dtype]:g} of the max")
        # <extract(u), S> == <u, scatter(S)>, the terms summed in float64
        lhs_terms = torch.cat([(uL * SL).reshape(-1), (uR * SR).reshape(-1)]).double()
        rhs_terms = (u * ff.scatter_faces(torch.zeros_like(u), SL, SR, dev)).reshape(-1).double()
        adj_err = float((lhs_terms.sum() - rhs_terms.sum()).abs()
                        / lhs_terms.abs().sum())
        if not adj_err <= FLAT_ADJOINT_TOL[dtype]:
            raise AssertionError(f"{dtype}: adjoint identity {adj_err:.3e} > "
                                 f"{FLAT_ADJOINT_TOL[dtype]:g}")
        # the structured path's traces, matched face by face
        own, other = structured_in_flat_order(extract_faces_stacked(q, BCs(4, 4, 4, 4)),
                                              faces, nel)
        interior = slice(0, faces.n_interior)
        if not (torch.equal(uL, own) and torch.equal(uR[:, interior], other[:, interior])
                and torch.equal(uR[:, faces.n_interior:], uL[:, faces.n_interior:])):
            raise AssertionError(f"{dtype}: flat traces differ from the structured path's")
        # device-only times of one call, operands cold (sets beyond the L2)
        ms_extract = ms_scatter = None
        if device != "cpu":
            ms_extract = time_launches(lambda x: ff.extract_traces(x, dev), cold_sets((u,)),
                                       20, device_only=True)
            ms_scatter = time_launches(lambda r, a, c: ff.scatter_faces(r, a, c, dev),
                                       cold_sets((rhs, SL, SR)), 20, device_only=True)
        es = u.element_size()
        idx_bytes = 2 * F * ngl * 4
        # extract: the field read once, both traces written, the tables read;
        # scatter: rhs and both contributions read, the result written
        b_extract = (u.numel() * es + 2 * C * F * ngl * es + idx_bytes) / HBM_BYTES_PER_S
        b_scatter = (2 * u.numel() * es + 2 * C * F * ngl * es + idx_bytes) / HBM_BYTES_PER_S
        out[str(dtype).split(".")[1]] = dict(
            channels=C, traces_bitwise_cpu=True, structured_bitwise=True,
            scatter_err_vs_cpu=scatter_err, scatter_tol=FLAT_SCATTER_TOL[dtype],
            adjoint_err=adj_err, ms_extract=ms_extract, ms_scatter=ms_scatter,
            bound_ms_extract=b_extract * 1e3, bound_ms_scatter=b_scatter * 1e3)
        del q, u, uL, uR, cL, cR, S, SL, SR, rhs, rhs0, got, want, own, other
        if device != "cpu":
            torch.cuda.empty_cache()
    # geometry: coordinates continuous across interior faces (card), unit
    # normals (host float64, the module's host code); each pinwheel spoke 1 long
    for name, (verts, quads) in (("pinwheel", ff.pinwheel_mesh()),
                                 (f"deformed_{nel}", brick_mesh(nel, FLAT_DEFORM, seed=29))):
        gfaces = ff.build_flat_faces(quads, ngl)
        coords = ff.bilinear_coords(verts, quads, b.xgl)
        xy = torch.tensor(np.moveaxis(coords, -1, 0), device=device)
        cL, cR = ff.extract_traces(xy, gfaces.to(device))
        n_int = gfaces.n_interior
        cont = float((cL - cR)[:, :n_int].abs().max() / xy.abs().max())
        nx, ny, jac = ff.face_geometry(coords, gfaces, b.wgl, b.dpsi.T)
        unit = float(np.abs(nx * nx + ny * ny - 1.0).max())
        if not (cont <= FLAT_COORD_TOL and unit <= 1e-12):
            raise AssertionError(f"{name}: coordinate continuity {cont:.3e}, unit normals "
                                 f"{unit:.3e}")
        out[name] = {"coord_continuity": cont, "unit_normal_err": unit}
        if name == "pinwheel":
            spoke = float(np.abs(jac[:n_int].sum(-1) - 1.0).max())
            if not spoke <= 1e-12:
                raise AssertionError(f"pinwheel spoke length off 1 by {spoke:.3e}")
            out[name]["spoke_length_err"] = spoke
    return out


OUT_DIR = pathlib.Path(__file__).resolve().parent / "chiprun_out"


class _Tee:
    """A text stream that writes to several, and flushes each of them at
    every line's end: a run that fails leaves every line before the failure
    in the log."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        if "\n" in text:
            self.flush()
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="FILE", nargs="?", default=None,
                    const=str(OUT_DIR / "chip_smoke_profile.txt"),
                    help="also write torch.profiler tables of one 64x64 step and one "
                         "barotropic solve on the per-stage and on the fused path, of "
                         "one 32x32 step, and of replayed steps of the quad family "
                         "(64x64) and of both face paths (128x128), to FILE (default "
                         "chiprun_out/chip_smoke_profile.txt)")
    ap.add_argument("--log", metavar="FILE", default=str(OUT_DIR / "chip_smoke.log"),
                    help="the whole output, standard output and errors, line by line "
                         "(default chiprun_out/chip_smoke.log beside this script)")
    ap.add_argument("--split-probe", action="store_true",
                    help="only phases 1-2 and the probe of where a split f32 run leaves "
                         "the serial one (split_probe); its readings to "
                         "chiprun_out/split_probe.json")
    ap.add_argument("--decomposition-only", nargs="*", metavar="PHASE",
                    choices=DECOMP_PHASES, default=None,
                    help="only phases 1-2 (the five kernels) and the decomposition's "
                         "phases 27-27d, or those named (27c takes 27 with it; 27b "
                         "needs 2 GPUs, 27d 4); their readings to "
                         "chiprun_out/decomposition.json")
    args = ap.parse_args()
    pathlib.Path(args.log).parent.mkdir(parents=True, exist_ok=True)
    OUT_DIR.mkdir(exist_ok=True)   # the readings' files, wherever the log goes
    log = open(args.log, "w")
    sys.stdout = _Tee(sys.__stdout__, log)
    sys.stderr = _Tee(sys.__stderr__, log)

    # ---- phase 1: device ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    smi = card()
    print(f"phase 1 device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    from hnumo_tpu_torch.model import Model
    from hnumo_tpu_torch.ops._build import (build_libraries, build_variants, load_library,
                                            resource_usage, variant)

    if args.profile:
        open(args.profile, "w").close()

    # ---- phase 2: build (one nvcc per source, side by side) -----------------
    t0 = time.perf_counter()
    sources = ["btp_volume", "btp_mega", "btp_volume_uni", "btp_faces", "btp_update"]
    build_libraries(sources)
    for name in sources:
        load_library(name)
    print(f"phase 2 build: {', '.join(n + '.cu' for n in sources)} compiled side by "
          f"side and loaded in {time.perf_counter() - t0:.1f} s")
    for name in sources:
        print(f"phase 2 ptxas {name}: " + "; ".join(resource_usage(name)))
    # the megakernel's routes (<..., 1> resident, <..., 0> streamed) spill
    # nothing in the order the model runs at
    mega_main = [u for u in resource_usage("btp_mega") if u.startswith("f<5,9,")]
    if len(mega_main) != 2 or not all(u.endswith(" 0 B spill stores, 0 B spill loads")
                                      for u in mega_main):
        raise AssertionError(f"btp_mega at f<5,9> must build both routes without a "
                             f"spill: {mega_main}")
    if args.decomposition_only is not None:
        readings = dict(zip(DECOMP_PHASES, decomposition_phases(
            smi, args.decomposition_only or DECOMP_PHASES)))
        (OUT_DIR / "decomposition.json").write_text(json.dumps(readings, default=str))
        print(smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0
    t0 = time.perf_counter()
    build_variants(ABLATED_SOURCES + ("btp_mega",), [(d,) for _, d in ABLATIONS])
    build_variants(["btp_mega"], [(d,) for _, d in MEGA_ABLATIONS[len(ABLATIONS):]])
    print(f"phase 2 build: the two ablated variants of {', '.join(ABLATED_SOURCES)} and "
          f"the four of btp_mega (timed only) in {time.perf_counter() - t0:.1f} s")
    for name, define in MEGA_ABLATIONS:
        with variant(define):
            print(f"phase 2 ptxas btp_mega {name} ({define}): "
                  + "; ".join(resource_usage("btp_mega")))
    from hnumo_tpu_torch.ops.btp_tail import btp_faces_layout, btp_update_layout
    from hnumo_tpu_torch.ops.btp_volume import btp_volume_layout
    from hnumo_tpu_torch.ops.btp_volume_uni import btp_volume_uni_layout
    from hnumo_tpu_torch.ops.mega import btp_mega_layout

    print("phase 2 layout btp_mega (route, elements per block, threads, shared memory "
          "per block, resident blocks per SM, grid): " + "; ".join(
              f"{dt} p={ngl - 1} E={E} "
              + json.dumps(btp_mega_layout(getattr(torch, dt), E, ngl, nq))
              for dt in ("float32", "float64") for ngl, nq in ((5, 9), (7, 13))
              for E in (30, 625, 1024, 4096)))

    # (dtype, ngl, nq) -> faces or elements per tile, shared memory per block,
    # resident blocks per SM
    layouts = {"btp_volume": btp_volume_layout, "btp_volume_uni": btp_volume_uni_layout,
               "btp_faces": btp_faces_layout,
               "btp_update": lambda dtype, ngl, nq: btp_update_layout(dtype, ngl)}
    for name, layout in layouts.items():
        print(f"phase 2 layout {name} (units per tile, shared memory per block, "
              f"resident blocks per SM): " + "; ".join(
                  f"{dt} p={ngl - 1} {json.dumps(layout(getattr(torch, dt), ngl, nq))}"
                  for dt in ("float32", "float64") for ngl, nq in ((5, 9), (9, 17))))

    if args.split_probe:
        probe = split_probe()
        (OUT_DIR / "split_probe.json").write_text(json.dumps(probe, default=str))
        print(smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0

    # ---- phase 3: volume kernel vs plain version -----------------------------
    # E=30 and E=4096 (1024 tiles of 4 for 264 resident blocks: the ring turns
    # over, the aligned 16-byte route); E=35, 9, 2: 3, 1, 2 modulo 4 and less
    # than a tile (value-by-value route, ragged last tile); p=8 (tiles of 2 in
    # f32, of 1 in f64, sizes at run time); a metric that differs at every point
    worst = {"float64": 0.0, "float32": 0.0}
    worst_p8 = dict(worst)
    worst_curv = dict(worst)
    main_err = None
    for dtype in ("float64", "float32"):
        for botfr in (0, 1, 2):
            for nelx, nely in ((6, 5), (7, 5), (3, 3), (1, 2), (64, 64)):
                scaled, abs_err = check_kernel_against_plain(nelx, nely, dtype, botfr)
                worst[dtype] = max(worst[dtype], scaled)
                if (dtype, botfr, nelx) == ("float32", 1, 64):   # the main path's shapes
                    main_err = (abs_err, scaled)
            for nelx, nely in ((3, 3), (4, 4)):
                scaled, _ = check_kernel_against_plain(nelx, nely, dtype, botfr, nop=8)
                worst_p8[dtype] = max(worst_p8[dtype], scaled)
            for nelx, nely, nop in ((7, 5, 4), (16, 16, 4), (3, 3, 8)):
                scaled, _ = check_kernel_against_plain(nelx, nely, dtype, botfr, nop=nop,
                                                       curvilinear=True)
                worst_curv[dtype] = max(worst_curv[dtype], scaled)
    print(f"phase 3 kernel vs plain (botfr 0/1/2; rhs+accv+accn; inputs unchanged), max "
          f"err/scale f64 / f32 (tol {F64_TOL:g} / {F32_TOL:g}): p=4 E=30, 35, 9, 2, 4096 "
          f"{worst['float64']:.3e} / {worst['float32']:.3e}; p=8 E=9, 16 "
          f"{worst_p8['float64']:.3e} / {worst_p8['float32']:.3e}; metric perturbed at "
          f"every point, p=4 E=35, 256 and p=8 E=9 {worst_curv['float64']:.3e} / "
          f"{worst_curv['float32']:.3e}")

    # ---- phase 4: barotropic solve, kernel vs plain stage --------------------
    w, n = check_solve_kernel_vs_plain()
    print(f"phase 4 f64 barotropic_solve 12x12, kernel vs plain stage: qb + {n - 4} "
          f"averages, max err/scale {w:.3e} (tol {SOLVE_TOL:g})")

    # ---- phase 5: per-stage path, 64x64 f32 ----------------------------------
    m64 = Model(main_path_config(64, "float32"))
    if m64.static.mega or m64.static.volume_impl != "kernel":
        raise AssertionError("64x64 is over 1024 elements: 'auto' must leave it on "
                             "the per-stage path with the CUDA volume kernel")
    run64, s64 = drive(m64, warm=2, steps=3)
    tv64 = time_volume_stage(m64)
    b64 = volume_bound(m64)
    print(f"phase 5 per-stage path 64x64 p=4 L=2 f32 N_btp={m64.static.n_btp}: "
          f"{run64['ms_per_step']:.2f} ms/step ({run64['step_impl']}), "
          f"{run64['gp_steps_per_s']:.4g} gp-steps/s, {run64['launches_per_step']} kernel "
          f"launches/step ({run64['launches']} through the wrapper), ok, finite, "
          f"mass drift {run64['mass_drift']:.2e}; volume kernel {tv64['ms']:.4f} ms/launch "
          f"on the device ({tv64['ms_with_wrapper']:.4f} as the host launches it; hot "
          f"{tv64['ms_hot']:.4f} / {tv64['ms_hot_with_wrapper']:.4f}), plain "
          f"{tv64['plain_ms']:.4f}, bound {b64['bound_ms']:.4f} ms by {b64['bound_by']}")
    extra = {}
    if args.profile:
        extra = profile_step(m64, s64, args.profile, "64x64 f32, per-stage path")
        extra["device_idle_share"] = 1.0 - extra["device_busy_ms"] / run64["ms_per_step"]
        extra.update(profile_solve(m64, args.profile,
                                   "64x64 f32, one barotropic solve, per-stage path"))
        print(f"phase 5 profile of one step and of one solve: {json.dumps(extra)}")
    del s64, m64

    # ---- phase 6: 256x256 f32 -------------------------------------------------
    m256 = Model(main_path_config(256, "float32"))
    if m256.static.mega or m256.static.batched_faces:
        raise AssertionError("256x256 must stay on the per-stage path under 'auto', with "
                             "the per-direction faces above 8192 elements")
    run256, _ = drive(m256, warm=1, steps=2)
    tv256 = time_volume_stage(m256, n=20, nsets=2)
    b256 = volume_bound(m256)
    print(f"phase 6 256x256 p=4 L=2 f32 (per-direction faces): "
          f"{run256['ms_per_step']:.1f} ms/step "
          f"({run256['step_impl']}), "
          f"{run256['gp_steps_per_s']:.4g} gp-steps/s, ok, finite, mass drift "
          f"{run256['mass_drift']:.2e}; volume kernel {tv256['ms']:.4f} ms/launch on the "
          f"device ({tv256['ms_with_wrapper']:.4f} as the host launches it), "
          f"plain {tv256['plain_ms']:.4f}, bound {b256['bound_ms']:.4f} ms by "
          f"{b256['bound_by']}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    big = {"ms_256": tv256["ms"], "ms_with_wrapper_256": tv256["ms_with_wrapper"],
           "plain_ms_256": tv256["plain_ms"],
           "bound_ms_256": b256["bound_ms"],
           "step_ms_256": run256["ms_per_step"],
           "gp_steps_per_s_256": run256["gp_steps_per_s"]}
    del m256
    torch.cuda.empty_cache()

    # ---- phase 7: megakernel vs its plain version, both routes ---------------
    # the 6x5 matrix on the route the size chooses (resident) and on the
    # streamed one; 25x25 and 32x32 in f32 (resident, and streamed by name)
    # and f64 (streamed: 528 resident blocks); 64x64 with mega="on" (more
    # elements than resident blocks: each block walks several between two
    # grid barriers)
    w6 = {"resident": 0.0, "streamed": 0.0}
    nfields = 0
    for visc, botfr, kstages, nop, walls in (
            (False, 1, 5, 4, FREE_SLIP), (True, 1, 5, 4, FREE_SLIP),
            (True, 2, 5, 4, FREE_SLIP), (False, 0, 3, 4, FREE_SLIP),
            (True, 1, 5, 6, FREE_SLIP), (True, 1, 5, 4, OTHER_WALLS)):
        for route in (None, "streamed"):
            w, _, nfields, taken = check_mega_vs_plain(
                small_config(6, 5, "float64", botfr, mega="on", visc=visc,
                             kstages=kstages, nop=nop, walls=walls), SOLVE_TOL, route=route)
            if route is None and taken != "resident":
                raise AssertionError("6x5 f64 must take the resident route")
            w6[taken] = max(w6[taken], w)
    # O(1) velocity shear and a large viscosity: the neighbours' viscous
    # gradient (recomputed by each block from its neighbours' state) matters
    w_shear = {}
    for route in (None, "streamed"):
        w, _, _, taken = check_mega_vs_plain(
            small_config(6, 5, "float64", 1, mega="on", visc_mlswe=SHEAR_VISC), SOLVE_TOL,
            route=route, inputs=sheared_inputs)
        w_shear[taken] = w
    if sorted(w_shear) != ["resident", "streamed"]:
        raise AssertionError(f"the sheared state must run on both routes: {sorted(w_shear)}")
    solves = {}
    for nel, dtype, mode, route in ((25, "float64", "auto", None), (32, "float64", "auto", None),
                                    (64, "float64", "on", None), (25, "float32", "auto", None),
                                    (25, "float32", "auto", "streamed"),
                                    (32, "float32", "auto", None),
                                    (32, "float32", "auto", "streamed"),
                                    (64, "float32", "on", None)):
        tol = SOLVE_TOL if dtype == "float64" else F32_MEGA_TOL
        w, wa, _, taken = check_mega_vs_plain(main_path_config(nel, dtype, mega=mode), tol,
                                              route=route)
        solves[(nel, dtype, taken)] = (w, wa)
    if (32, "float32", "resident") not in solves or (64, "float32", "streamed") not in solves:
        raise AssertionError(f"32x32 f32 must take the resident route and 64x64 the "
                             f"streamed one: {sorted(solves)}")
    mega_err, mega_abs = solves[(32, "float32", "resident")]
    print(f"phase 7 megakernel vs plain, one solve, qb (4 channels) + {nfields - 4} "
          f"averages, max err/scale: f64 6x5 matrix (visc on/off, botfr 0/1/2, kstages 3/5, "
          f"nop 4/6, walls free-slip and copy/no-slip) resident {w6['resident']:.3e}, streamed "
          f"{w6['streamed']:.3e}; sheared state (u, v ~ 1 m/s, visc {SHEAR_VISC:g}) "
          f"resident {w_shear['resident']:.3e}, streamed {w_shear['streamed']:.3e} "
          f"(tol {SOLVE_TOL:g}); " + "; ".join(
              f"{nel}x{nel} {dt} {r} {w:.3e}" for (nel, dt, r), (w, _) in solves.items())
          + f" (tol f64 {SOLVE_TOL:g}, f32 {F32_MEGA_TOL:g}); qb_df unchanged")

    # ---- phase 8: megakernel vs the per-stage path ---------------------------
    w_solve, n, w_step = check_mega_vs_per_stage()
    print(f"phase 8 f64 12x12, megakernel vs per-stage path with the volume kernel: "
          f"one solve, {n} fields, max err/scale {w_solve:.3e} (tol {SOLVE_TOL:g}); "
          f"two full steps {w_step:.3e} (tol {STEP_TOL:g})")

    # ---- phase 9: main path, 32x32 f32 through the megakernel ----------------
    m32 = Model(main_path_config(32, "float32"))
    if not (m32.static.mega and m32.static.mega_impl == "kernel"):
        raise AssertionError("32x32 with default arguments must take the megakernel")
    run32, s32 = drive(m32, warm=3, steps=20)
    if run32["mega_routes"] != {"streamed": 0, "resident": run32["launches"]}:
        raise AssertionError(f"32x32 f32 must launch the resident route only: "
                             f"{run32['mega_routes']}")
    tm32 = time_mega(m32)
    b32 = mega_bound(m32)
    # the grid of the committed f32 campaign, one element per block too
    m25 = Model(main_path_config(25, "float32"))
    tm25 = time_mega(m25)
    b25 = mega_bound(m25)
    route25 = btp_mega_layout(torch.float32, 25 * 25, 5, 9)["route"]
    del m25
    m32off = Model(main_path_config(32, "float32", mega="off"))
    run32off, _ = drive(m32off, warm=1, steps=3)
    del m32off
    # over the 1024 elements of "auto": 64x64 through the megakernel because
    # the caller says so, beside phase 5's reading of the same grid
    m64on = Model(main_path_config(64, "float32", mega="on"))
    run64on, _ = drive(m64on, warm=1, steps=5)
    if run64on["mega_routes"] != {"streamed": run64on["launches"], "resident": 0}:
        raise AssertionError(f"64x64 must take the streamed route: {run64on['mega_routes']}")
    tm64on = time_mega(m64on, n=5, ablations=False)
    del m64on
    print(f"phase 9 main path 32x32 p=4 L=2 f32 N_btp={m32.static.n_btp}: "
          f"{run32['ms_per_step']:.2f} ms/step ({run32['step_impl']}), "
          f"{run32['gp_steps_per_s']:.4g} gp-steps/s, "
          f"{run32['launches_per_step']} megakernel launches/step, 0 volume kernel "
          f"launches, ok, finite, mass drift {run32['mass_drift']:.2e}; with mega='off' "
          f"{run32off['ms_per_step']:.2f} ms/step, {run32off['gp_steps_per_s']:.4g} "
          f"gp-steps/s ({run32off['launches_per_step']} volume kernel launches/step); "
          f"{run32['mega_routes']['resident']} of the resident route; " + "; ".join(
              f"megakernel {g}x{g} ({r} route) {t['ms']:.4f} ms/launch on the device "
              f"({t['ms_with_wrapper']:.4f} with its wrapper), plain {t['plain_ms']:.2f}, "
              f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}, {b['barriers']} grid "
              f"barriers/launch: barrier-only floor {t['ms_barrier_only']:.4f}, memory-only "
              f"{t['ms_memory_only']:.4f}, compute-only {t['ms_compute_only']:.4f}, "
              f"grid barriers in place of the neighbour counters {t['ms_grid_barrier']:.4f}"
              for g, r, t, b in ((32, "resident", tm32, b32), (25, route25, tm25, b25)))
          + f"; 64x64 with mega='on': {run64on['ms_per_step']:.2f} ms/step, "
          f"{run64on['gp_steps_per_s']:.4g} gp-steps/s, megakernel (streamed route) "
          f"{tm64on['ms']:.4f} ms/launch on the device")
    extra32 = {}
    if args.profile:
        extra32 = profile_step(m32, s32, args.profile, "32x32 f32, megakernel path")
        extra32["device_idle_share"] = (1.0 - extra32["device_busy_ms"]
                                        / run32["ms_per_step"])
        print(f"phase 9 profile of one step: {json.dumps(extra32)}")
    del s32, m32

    # ---- phase 10: kernels A, F, U vs their plain versions ---------------------
    names = ("btp_volume_uni", "btp_faces", "btp_update")
    worst3 = {"float64": dict.fromkeys(names, 0.0), "float32": dict.fromkeys(names, 0.0)}
    main_err3 = None
    # the three kernels at the ragged counts (E = 35, 20, 9, 2; F = 82, 49, 24,
    # 7: 2, 1, 0 and 3 modulo 4, besides 6x5's F = 71) and at p=8
    worst_r = {"float64": dict.fromkeys(names, 0.0), "float32": dict.fromkeys(names, 0.0)}
    for dtype in ("float64", "float32"):
        for botfr, visc, case in ((0, True, "double_gyre"), (1, True, "double_gyre"),
                                  (2, True, "double_gyre"), (1, False, "double_gyre"),
                                  (1, True, "seamount")):
            for nelx, nely in ((6, 5), (64, 64)):
                w = check_fused_kernels(nelx, nely, dtype, botfr, visc=visc, test_case=case)
                for k in names:
                    worst3[dtype][k] = max(worst3[dtype][k], w[k][0])
                if (dtype, botfr, visc, case, nelx) == ("float32", 1, True, "double_gyre", 64):
                    main_err3 = w       # the main path's shapes
            for nelx, nely, nop in ((7, 5, 4), (5, 4, 4), (3, 3, 4), (1, 2, 4), (3, 3, 8),
                                    (4, 4, 8)):
                w = check_fused_kernels(nelx, nely, dtype, botfr, visc=visc, test_case=case,
                                        nop=nop)
                for k in names:
                    worst_r[dtype][k] = max(worst_r[dtype][k], w[k][0])
    print("phase 10 kernels A, F, U vs plain, one stage (viscous botfr 0/1/2, inviscid, "
          "non-flat bottom; E=30/F=71 and E=4096/F=8320; every output on its own scale; "
          "inputs unchanged), max err/scale: " + "; ".join(
              f"{k} f64 {worst3['float64'][k]:.3e} f32 {worst3['float32'][k]:.3e}"
              for k in names) + "; at E=35/F=82, E=20/F=49, E=9/F=24, E=2/F=7 (p=4) and "
          "E=9/F=24, E=16/F=40 (p=8): " + "; ".join(
              f"{k} f64 {worst_r['float64'][k]:.3e} f32 {worst_r['float32'][k]:.3e}"
              for k in names) + f" (tol f64 {F64_TOL:g}, f32 {F32_TOL:g})")

    # ---- phase 11: fused solve vs plain versions and vs the per-stage path ----
    wsolve, nfields = check_fused_solve()
    print(f"phase 11 f64 barotropic_solve (12x12 viscous free-slip; 6x5 viscous and "
          f"inviscid with copy/no-slip walls), qb + {nfields - 4} averages, max err/scale: "
          + "; ".join(f"{k} {v:.3e}" for k, v in wsolve.items())
          + f" (tol {SOLVE_TOL:g})")

    # ---- phase 12: the fused path at full width, 64x64 f32 -------------------
    f64m = Model(fused_config(64, "float32"))
    if not (f64m.static.fused_tail and not f64m.static.mega
            and f64m.static.volume_impl == "kernel" and f64m.static.tail_impl == "kernel"):
        raise AssertionError("mega='off', fused_tail='on' must take the fused path "
                             "with its three CUDA kernels")
    runf64, sf64 = drive(f64m, warm=2, steps=3)
    tf64 = time_fused_kernels(f64m)
    bf64 = fused_bounds(f64m)
    print(f"phase 12 fused path 64x64 p=4 L=2 f32 N_btp={f64m.static.n_btp}: "
          f"{runf64['ms_per_step']:.2f} ms/step ({runf64['step_impl']}), "
          f"{runf64['gp_steps_per_s']:.4g} gp-steps/s "
          f"(per-stage path in this call, phase 5: {run64['ms_per_step']:.2f} ms/step, "
          f"{run64['gp_steps_per_s']:.4g} gp-steps/s), launches through the wrappers "
          f"{json.dumps(runf64['counts'])}, ok, finite, mass drift "
          f"{runf64['mass_drift']:.2e}; " + "; ".join(
              f"{k} {tf64[k]['ms']:.4f} ms/launch on the device "
              f"({tf64[k]['ms_with_wrapper']:.4f} as the host launches it), plain "
              f"{tf64[k]['plain_ms']:.4f}, bound "
              f"{bf64[k]['bound_ms']:.4f} ms by {bf64[k]['bound_by']}" for k in names))
    extraf = {}
    if args.profile:
        extraf = profile_step(f64m, sf64, args.profile, "64x64 f32, fused path")
        extraf["device_idle_share"] = (1.0 - extraf["device_busy_ms"]
                                       / runf64["ms_per_step"])
        extraf.update(profile_solve(f64m, args.profile,
                                    "64x64 f32, one barotropic solve, fused path"))
        print(f"phase 12 profile of one step and of one solve: {json.dumps(extraf)}")
    del sf64, f64m

    # ---- phase 13: the fused path at 256x256 f32 ------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    f256m = Model(fused_config(256, "float32"))
    runf256, _ = drive(f256m, warm=1, steps=2)
    peak256 = torch.cuda.max_memory_allocated() / 2**30
    tf256 = time_fused_kernels(f256m, n=20)
    bf256 = fused_bounds(f256m)
    print(f"phase 13 fused path 256x256 p=4 L=2 f32: {runf256['ms_per_step']:.1f} ms/step "
          f"({runf256['step_impl']}), "
          f"{runf256['gp_steps_per_s']:.4g} gp-steps/s (per-stage path in this call, "
          f"phase 6: {run256['ms_per_step']:.1f} ms/step), ok, finite, mass drift "
          f"{runf256['mass_drift']:.2e}, peak device memory {peak256:.2f} GiB; "
          + "; ".join(
              f"{k} {tf256[k]['ms']:.4f} ms/launch on the device "
              f"({tf256[k]['ms_with_wrapper']:.4f} as the host launches it), plain "
              f"{tf256[k]['plain_ms']:.4f}, bound "
              f"{bf256[k]['bound_ms']:.4f} ms by {bf256[k]['bound_by']}" for k in names))
    del f256m
    torch.cuda.empty_cache()
    for name, t64, t256 in (("btp_volume", tv64, tv256),
                            *((k, tf64[k], tf256[k]) for k in names)):
        print(f"phase 13 what limits {name}, ms at 64x64 / 256x256 (whole kernel; "
              f"contractions compiled out; no global reads): {t64['ms']:.4f} / "
              f"{t256['ms']:.4f}; {t64['ms_memory_only']:.4f} / {t256['ms_memory_only']:.4f}; "
              f"{t64['ms_compute_only']:.4f} / {t256['ms_compute_only']:.4f}")

    # ---- phase 14: the graphed step against the eager one, bitwise ------------
    # ---- phase 15: a step under the sync debug mode, eager and graphed --------
    # ---- phase 16: the kernels of a replayed step, counted in a trace --------
    graph_paths = {"32x32 megakernel": (main_path_config(32, "float32"), 4),
                   "64x64 fused": (fused_config(64, "float32"), 3),
                   "64x64 per-stage": (main_path_config(64, "float32"), 3)}
    replays = {}
    for label, (cfg, steps) in graph_paths.items():
        me, se, mg, sg, at_capture = check_graph_vs_eager(cfg, steps)
        sync_free_step(me, se)
        sg = sync_free_step(mg, sg)
        replays[label] = {"steps_bitwise": steps, "launches_at_capture": at_capture,
                          **replay_profile(mg, sg, args.profile,
                                           f"{label} f32, one replayed step")}
        del me, se, mg, sg
    torch.cuda.empty_cache()
    print("phase 14 graphed step == eager step, bitwise, every field of every state, and "
          "neither the given nor a returned state changed by later steps: " + "; ".join(
              f"{k} over {v['steps_bitwise']} steps" for k, v in replays.items()))
    print("phase 15 sync debug mode 'error': one eager and one graphed step of each path "
          "ran without a synchronising call")
    print("phase 16 kernels in one replayed step (torch.profiler trace; launches through "
          "the wrappers in the first step, eager warm-up + capture): " + "; ".join(
              f"{k}: {json.dumps({n: c for n, c in v['replay_kernels'].items() if c})}, "
              f"{v['replay_device_activities']} device activities, "
              f"{v['replay_device_busy_ms']:.3f} ms busy; at capture "
              f"{json.dumps({n: c for n, c in v['launches_at_capture'].items() if c})}"
              for k, v in replays.items()))

    # ---- phase 17: the frozen f64 trajectories and the CI bump, graphed --------
    gold = check_goldens()
    print(f"phase 17 f64 graphed megakernel path: bump_traj steps 3, 10 (resident route) "
          f"worst {gold['bump_traj'][0]:.3e} of the tolerance ({gold['bump_traj'][1]}); "
          f"dgyre_traj steps 3, 10 (streamed route) {gold['dgyre_traj'][0]:.3e} "
          f"({gold['dgyre_traj'][1]}) (rtol 1e-9, atol 1e-13 of scale); CI bump "
          f"{gold['ci_bump']['steps']} steps: FIN values worst rel dev "
          f"{gold['ci_bump']['fin_rel_dev']:.3e} (tol 1e-5), mass loss "
          f"{gold['ci_bump']['mass_rel_loss']:.3e} (tol 1e-12)")

    # ---- phase 18: the f32 campaign's spin-up in the f64 band, graphed ---------
    spin = check_campaign_spin_up(2.0)
    print(f"phase 18 double gyre f32 25x25, first 2 model days ({spin['steps']} steps, "
          f"{spin['ms_per_step']} ms/step graphed with 4 samples read back), against "
          f"dgyre_f64_cpu.json at {spin['samples']} samples: KE {spin['ke_rel']:.3e} (band "
          f"0.02), |u|max {spin['umax_rel']:.3e} (0.03), SSH extrema {spin['ssh_rel']:.3e} "
          f"(0.10), mass drift {spin['mass_rel_drift']:.3e} (1e-5)")

    # ---- phase 19: eager and graphed ms/step in turns ---------------------------
    turn_cfgs = {"32x32 megakernel": (main_path_config(32, "float32"), 20),
                 "64x64 fused": (fused_config(64, "float32"), 5),
                 "64x64 per-stage": (main_path_config(64, "float32"), 2),
                 "256x256 fused": (fused_config(256, "float32"), 2)}
    turns = {k: time_in_turns(cfg, n, args.profile, f"{k} f32, one replayed step (turns)")
             for k, (cfg, n) in turn_cfgs.items()}
    torch.cuda.empty_cache()
    print("phase 19 ms/step in turns eager, graph, graph, eager (after one untimed step "
          "each); device idle share of one replayed step; peak device memory eager / "
          "graph: " + "; ".join(
              f"{k}: {t['ms_eager'][0]:.2f}, {t['ms_graph'][0]:.2f}, {t['ms_graph'][1]:.2f}, "
              f"{t['ms_eager'][1]:.2f} ms; replay busy {t['replay_device_busy_ms']:.2f} ms, "
              f"idle {t['replay_device_idle_share']:.3f}; {t['peak_gib_eager']:.2f} / "
              f"{t['peak_gib_graph']:.2f} GiB" for k, t in turns.items()))

    def graph_extras(path, turn):
        """What the graphed step adds to a kernel's entry."""
        r, t = replays[path], turns[turn]
        return {"launches_at_capture": r["launches_at_capture"],
                "replay_kernels": r["replay_kernels"],
                "replay_device_busy_ms": r["replay_device_busy_ms"],
                "step_ms_eager_turns": t["ms_eager"], "step_ms_graph_turns": t["ms_graph"],
                "replay_device_idle_share": t["replay_device_idle_share"],
                "peak_gib_eager": t["peak_gib_eager"], "peak_gib_graph": t["peak_gib_graph"]}

    # ---- phase 20: the run layer: the CLI at full width, restart included -------
    from hnumo_tpu_torch.mesh import _native

    native_before = dict(_native.calls)
    with tempfile.TemporaryDirectory() as tmp:
        cli = check_cli(pathlib.Path(tmp))
    c32, c64 = cli["f32"], cli["f64"]
    turns_cli = c32["turns"]

    def restart_text(c):
        return (f"restored pb' off by {c['restored_pb_prime_err']:.3e} Pa (limit one ulp of "
                f"max|pb|, {c['pb_ulp']:.3e}), other channels by at most "
                f"{max(v for k, v in c['restored_ulps'].items() if k != 'qb_df[1]'):.2f} "
                f"units of their rounding (limit {RESTORE_ULPS}); final state vs the "
                f"straight run, "
                f"per channel over its max: " + ", ".join(
                    f"{k} {v:.2e}" for k, v in c["restart_vs_straight"].items())
                + f" (limit {c['restart_tol']:.2e} but pb', whose final error "
                f"{c['final_pb_prime_err']:.3e} Pa is within twice the restored one)")

    print(f"phase 20 CLI (python -m hnumo_tpu_torch numo3d.in) on bench.py's 32x32 "
          f"configuration, {CLI_STEPS} steps, a txt snapshot every {CLI_EVERY}, through the "
          f"graphed megakernel: f32 (--f32) {c32['wall_s']:.2f} s, f64 {c64['wall_s']:.2f} s; "
          f"mlswe0000-{CLI_STEPS:04d}, mlswe_FIN.txt, time.csv, mass_mlswe.cons written; "
          f"mass loss per layer f32 {', '.join(f'{v:.2e}' for v in c32['mass_loss'])}, f64 "
          f"{', '.join(f'{v:.2e}' for v in c64['mass_loss'])} (limit {MASS_TOL:g}); launches "
          f"at capture {json.dumps({k: v for k, v in c32['launches_at_capture'].items() if v})}"
          f", one replayed step "
          f"{json.dumps({k: v for k, v in c32['replay']['replay_kernels'].items() if v})}; "
          f"restarted from mlswe{CLI_RESTART_AT:04d}: == the straight model stepped from the "
          f"restored snapshot, bitwise (f32 and f64); f32 {restart_text(c32)}; f64 "
          f"{restart_text(c64)}; NetCDF snapshot read back exactly, binary VTK written; "
          f"f32 ms/step in turns Runner, Model.run, Model.run, Runner: "
          f"{turns_cli['runner'][0]:.2f}, {turns_cli['model_run'][0]:.2f}, "
          f"{turns_cli['model_run'][1]:.2f}, {turns_cli['runner'][1]:.2f} (the Runner's "
          f"steps alone {turns_cli['runner_steps'][0]:.2f}, "
          f"{turns_cli['runner_steps'][1]:.2f})")

    # ---- phase 21: kernel 1 on a curvilinear grid read from an MSH file --------
    with tempfile.TemporaryDirectory() as tmp:
        curv = check_curvilinear(pathlib.Path(tmp))
    native_calls = {k: v - native_before[k] for k, v in _native.calls.items()}
    cr, ct, cb = curv["run"], curv["timing"], curv["bound"]
    print(f"phase 21 curvilinear 32x32 (deformed by {CURV_DEFORM:g} of a cell, $BC, "
          f"$Bathy seamount; metric spread {curv['metric_spread']:.3f} of its max) f32: "
          f"uniform_geom False, {cr['ms_per_step']:.2f} ms/step ({cr['step_impl']}), "
          f"{cr['gp_steps_per_s']:.4g} gp-steps/s, launches at capture "
          f"{json.dumps({k: v for k, v in cr['counts'].items() if v})}, one replayed step "
          f"{json.dumps({k: v for k, v in curv['replay']['replay_kernels'].items() if v})}, "
          f"ok, finite, mass drift {cr['mass_drift']:.2e}; volume kernel vs plain on this "
          f"model's operands f64 / f32 {curv['errs']['float64'][0]:.3e} / "
          f"{curv['errs']['float32'][0]:.3e} (tol {F64_TOL:g} / {F32_TOL:g}); f64 two "
          f"steps, kernel vs plain version "
          + ", ".join(f"{k} {v:.2e}" for k, v in curv["step_err"].items())
          + f" (tol {STEP_TOL:g}); volume kernel {ct['ms']:.4f} ms/launch on the device "
          f"({ct['ms_with_wrapper']:.4f} as the host launches it), plain "
          f"{ct['plain_ms']:.4f}, bound {cb['bound_ms']:.4f} ms by {cb['bound_by']}; on the "
          f"32x32 brick {curv['timing_brick']['ms']:.4f}")

    # ---- phase 22: the quad-family LDG viscosity, 64x64 -------------------------
    t_phase = time.perf_counter()
    quad = check_quad_family(args.profile)
    secs_22 = time.perf_counter() - t_phase
    qg = quad["graph"]
    print(f"phase 22 ({secs_22:.1f} s) quad-family LDG (method_visc=1) 64x64 f32, "
          f"per-direction faces: "
          f"graphed == eager bitwise over {qg['steps_bitwise']} steps; one replayed step "
          f"{nonzero(qg['replay_kernels'])}, "
          f"{qg['replay_device_activities']} device activities, "
          f"{qg['replay_device_busy_ms']:.2f} ms busy; {qg['ms_per_step']:.2f} ms/step "
          f"(graph), {qg['gp_steps_per_s']:.4g} gp-steps/s, mass drift over {qg['steps']} "
          f"steps {qg['mass_drift']:.2e} (limit {MASS_TOL:g}); kernel 1 vs plain on this "
          f"model's operands f64 / f32 {quad['errs']['float64'][0]:.3e} / "
          f"{quad['errs']['float32'][0]:.3e} (tol {F64_TOL:g} / {F32_TOL:g}); f64 12x12 two "
          f"steps kernel vs plain " + ", ".join(f"{k} {v:.2e}" for k, v in
                                               quad["step_err"].items())
          + f" (tol {SOLVE_TOL:g})")

    # ---- phase 23: the two face paths of the per-stage path, 128x128 -------------
    t_phase = time.perf_counter()
    faces = check_face_paths(profile=args.profile)
    secs_23 = time.perf_counter() - t_phase
    fms, fru = faces["ms_turns"], faces["runs"]
    print(f"phase 23 ({secs_23:.1f} s) 128x128 f32 per-stage path, ms/step graphed in "
          f"turns auto "
          f"(per-direction faces), on (flat axis), on, auto: {fms['auto'][0]:.2f}, "
          f"{fms['on'][0]:.2f}, {fms['on'][1]:.2f}, {fms['auto'][1]:.2f}; one replayed step "
          + "; ".join(f"{k}: {nonzero(r['replay_kernels'])}"
                      f", {r['replay_device_activities']} device activities, "
                      f"{r['replay_device_busy_ms']:.2f} ms busy"
                      for k, r in faces["replays"].items())
          + "; mass drift " + ", ".join(f"{k} {r['mass_drift']:.2e}" for k, r in fru.items())
          + "; f64 6x5 copy/no-slip walls, two steps per-direction vs flat "
          + ", ".join(f"{k} {v:.2e}" for k, v in faces["step_err"].items())
          + f" (tol {SOLVE_TOL:g})")

    # ---- phase 24: LSRK, 64x64; lsrk_ref through the fused path, 32x32 -----------
    t_phase = time.perf_counter()
    lsrk = check_lsrk()
    secs_24 = time.perf_counter() - t_phase
    lr = lsrk["lsrk_ref"]
    print(f"phase 24 ({secs_24:.1f} s) lsrk 64x64 f32 per-stage path: " + "; ".join(
              f"kstages {k[4:]}: graphed == eager bitwise over {v['steps_bitwise']} steps, "
              f"one replayed step {nonzero(v['replay_kernels'])}, "
              f"{v['replay_device_busy_ms']:.2f} ms busy, {v['ms_per_step']:.2f} ms/step, "
              f"mass drift {v['mass_drift']:.2e} over {v['steps']} steps"
              for k, v in lsrk.items() if k != "lsrk_ref")
          + f"; lsrk_ref 32x32 f32 fused (warned): one replayed step "
          f"{nonzero(lr['replay_kernels'])}, ok {lr['ok']}, "
          f"finite {lr['finite']}; A, F, U vs plain with U on LSRK weights "
          f"{tuple(round(x, 6) for x in lr['update_weights'])}, f64 / f32: " + "; ".join(
              f"{k} {lr['errs']['float64'][k][0]:.3e} / {lr['errs']['float32'][k][0]:.3e}"
              for k in lr["errs"]["float32"])
          + "; f64 12x12 one step kernels vs plain " + ", ".join(
              f"{k} {v:.2e}" for k, v in lr["step_err"].items()) + f" (tol {SOLVE_TOL:g})")

    # ---- phase 25: periodic boundaries, 64x64 ------------------------------------
    t_phase = time.perf_counter()
    per = check_periodic()
    secs_25 = time.perf_counter() - t_phase
    print(f"phase 25 ({secs_25:.1f} s) periodic double gyre 64x64 f32 (x: "
          "x_boundary=(3,3), free-slip y "
          "walls; y: y_boundary=(3,3), free-slip x walls): " + "; ".join(
              f"{k}: {v['run']['ms_per_step']:.2f} ms/step ({v['run']['step_impl']}), one "
              f"replayed step {nonzero(v['replay']['replay_kernels'])}, "
              f"mass drift {v['run']['mass_drift']:.2e}, kernels vs plain on its wrapped "
              f"operands f64 / f32 " + ", ".join(
                  f"{kn} {v['errs']['float64'][kn][0]:.3e} / {v['errs']['float32'][kn][0]:.3e}"
                  for kn in v["errs"]["float32"])
              for k, v in per.items() if k != "x_32_auto")
          + f" (tol {F64_TOL:g} / {F32_TOL:g}); 32x32 periodic under mega='auto': one "
          f"replayed step {nonzero(per['x_32_auto']['replay']['replay_kernels'])}")

    # ---- phase 26: the shear stress and quadratic bottom drag ---------------------
    t_phase = time.perf_counter()
    sb = check_shear_and_botfr2()
    secs_26 = time.perf_counter() - t_phase
    sh = sb["shear"]
    print(f"phase 26 ({secs_26:.1f} s) shear stress ad_mlswe={SHEAR_AD:g} 32x32 f32 "
          f"megakernel: graphed == "
          f"eager bitwise over {sh['steps_bitwise']} steps, one replayed step "
          f"{nonzero(sh['replay_kernels'])}, {sh['ms_per_step']:.2f} ms/step, mass drift "
          f"{sh['mass_drift']:.2e}; max|du| of the layer momenta against ad_mlswe=0, f32 "
          f"after {sh['steps']} steps {sh['du_max_float32']:.3e} "
          f"({sh['du_over_scale_float32']:.2e} of their max), f64 after 2 "
          f"{sh['du_max_float64']:.3e} ({sh['du_over_scale_float64']:.2e}); "
          f"megakernel vs plain on a "
          f"solve from its stepped state ({sh['mega_vs_plain']['route']} route) "
          f"{sh['mega_vs_plain']['max_err_over_scale']:.3e} (tol {F32_MEGA_TOL:g}); botfr=2: "
          + "; ".join(f"{k} {v['run']['ms_per_step']:.2f} ms/step, one replayed step "
                      f"{nonzero(v['replay']['replay_kernels'])}, "
                      f"mass drift {v['run']['mass_drift']:.2e}"
                      for k, v in sb.items() if k in ("botfr2_mega_32", "botfr2_fused_64"))
          + "; f64 12x12 two steps against the per-stage path: " + "; ".join(
              f"{k} " + ", ".join(f"{f} {e:.2e}" for f, e in v.items())
              for k, v in sb["botfr2_vs_per_stage_f64"].items())
          + f" (tol {STEP_TOL:g})")

    # ---- phases 27-27d: domain decomposition ------------------------------------------
    dec27, dec27b, self27c, dec27d = decomposition_phases(smi)

    # ---- phase 28: the native mesh front end; the CLI decomposed ----------------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        nat = check_native_and_cli_mesh(pathlib.Path(tmp), native_calls)
    secs_28 = time.perf_counter() - t_phase
    print(f"phase 28 ({secs_28:.1f} s) native mesh front end ({nat['library']}, built "
          f"from hnumo_tpu_torch/mesh/csrc/qmesh.cpp): native calls in phases 20-21 "
          f"{json.dumps({k: v for k, v in nat['native_calls'].items() if v})}; geometry "
          f"of phase 21's deformed 32x32 MSH through the native path == the Python "
          f"path's, bitwise; python -m hnumo_tpu_torch numo3d.in --mesh 2x2 --backend "
          f"gloo, 32x32 f64 {CLI_MESH_STEPS} steps ({nat['wall_s']['mesh']:.1f} s; serial "
          f"CLI {nat['wall_s']['serial']:.1f} s): FIN values vs serial "
          f"{nat['fin_err']:.2e}, final snapshot {nat['snapshot_err']:.2e} of their "
          f"scale (limit 1e-9)")

    # ---- phase 29: the flat unstructured faces on the card ----------------------------
    t_phase = time.perf_counter()
    flat = check_flat_faces()
    secs_29 = time.perf_counter() - t_phase
    print(f"phase 29 ({secs_29:.1f} s) flat unstructured faces (mesh/flatfaces.py) on the "
          f"{FLAT_NEL}x{FLAT_NEL} brick ({flat['elements']} elements, {flat['faces']} faces, "
          f"{flat['interior_faces']} interior; tables built on the host in "
          f"{flat['tables_build_s']:.1f} s): " + "; ".join(
              f"{dt} ({v['channels']} channels: state0 + random): traces == CPU and == the "
              f"structured path's, bitwise; scatter vs CPU {v['scatter_err_vs_cpu']:.2e} of "
              f"the max (tol {v['scatter_tol']:g}); adjoint {v['adjoint_err']:.2e}; device "
              f"ms extract_traces {v['ms_extract']:.4f} (bound {v['bound_ms_extract']:.4f}), "
              f"scatter_faces {v['ms_scatter']:.4f} (bound {v['bound_ms_scatter']:.4f})"
              for dt, v in flat.items() if dt in ("float32", "float64"))
          + f"; pinwheel: coordinate continuity {flat['pinwheel']['coord_continuity']:.1e}, "
          f"unit normals {flat['pinwheel']['unit_normal_err']:.1e}, spoke length "
          f"{flat['pinwheel']['spoke_length_err']:.1e}; deformed {FLAT_NEL}x{FLAT_NEL}: "
          f"continuity {flat[f'deformed_{FLAT_NEL}']['coord_continuity']:.1e}, unit normals "
          f"{flat[f'deformed_{FLAT_NEL}']['unit_normal_err']:.1e} | {smi}")

    # ---- phase 30: the bench tool's runs, path by path ----------------------------------
    t_phase = time.perf_counter()
    bench30 = []
    for (nel, nop), variants in BENCH_RUNS:
        bench30 += bench.time_in_turns([(v, bench.variant_config(nel, nop, v))
                                        for v in variants], BENCH_STEPS, BENCH_REPEATS)
    secs_30 = time.perf_counter() - t_phase
    print(f"phase 30 ({secs_30:.1f} s) hnumo_tpu_torch/tools/bench.py's runs (--table), "
          f"{BENCH_REPEATS} windows of {BENCH_STEPS} graphed steps each in turns; every "
          f"captured graph holds exactly its variant's kernels, ok, finite, mass change "
          f"within {MASS_TOL:g}; ms/step (spread), idle share, kernels a step: " + "; ".join(
              f"{r['nel'][0]}x{r['nel'][1]} p={r['nop']} {r['variant']} "
              f"{r['ms_per_step']:.2f} ({r['spread']:.3f}), {r['device_idle_share']:.3f}, "
              f"{json.dumps(r['kernels_per_step'])}" for r in bench30) + f" | {smi}")
    for r in bench30:
        print("phase 30 " + json.dumps(r))

    def decomposed_entry(name):
        """A kernel's readings in phase 27 (27b), per case of its path."""
        def cases(d):
            return {k: {"launches_per_rank_per_step": v["launches_per_rank_per_step"].get(
                            name, 0),
                        "max_err_over_scale": v["max_err"], "mass_drift": v["mass_drift"],
                        "ms_per_step_ranks": v["ms_per_step_ranks"],
                        "ms_per_step_serial": v["ms_per_step_serial"]}
                    for k, v in d["cases"].items()
                    if v["launches_per_rank_per_step"].get(name, 0)}
        out = {"gloo_2x2_shared_gpu": cases(dec27)}
        for key, d in (("nccl", dec27b), ("nccl_256", dec27d)):
            if d is not None:
                out[key] = cases(d)
                for k, v in out[key].items():
                    g = d["cases"][k]["graph"]
                    v.update(graph_equals_eager=all(g["bitwise_ranks"]
                                                    + g["replay_bitwise_ranks"]),
                             ms_eager_ranks=g["ms_eager_ranks"],
                             ms_graph_ranks=g["ms_graph_ranks"],
                             replay_launches=g["replay_kernels"].get(name, 0))
        out["self_exchange_one_gpu"] = {
            k: {"replay_launches": v["replay_kernels"].get(name, 0),
                "nccl_sendrecv_nodes": v["nccl_sendrecv_nodes"]}
            for k, v in self27c["models"].items() if v["replay_kernels"].get(name, 0)}
        return out

    # ---- the kernels line -----------------------------------------------------------
    replaces = {"btp_volume_uni": "hnumo_tpu/ops/pallas_btp.py:287",
                "btp_faces": "hnumo_tpu/ops/pallas_btp_tail.py:158",
                "btp_update": "hnumo_tpu/ops/pallas_btp_tail.py:362"}
    def ablated_extras(name, t64, t256):
        """What the four streaming kernels add to their entries: both
        ablations, the launch's layout and what ptxas said."""
        return {"ms_memory_only": t64["ms_memory_only"],
                "ms_compute_only": t64["ms_compute_only"],
                "ms_256_memory_only": t256["ms_memory_only"],
                "ms_256_compute_only": t256["ms_compute_only"],
                "layout": layouts[name](torch.float32, 5, 9),
                "ptxas": resource_usage(name)}

    fused_entries = [{
        "name": k, "route": "cuda", "source": f"hnumo_tpu_torch/ops/csrc/{k}.cu",
        "replaces": replaces[k], "launches": runf64["counts"][k],
        "max_abs_err": main_err3[k][1], "max_err_over_scale": main_err3[k][0],
        "tolerance_over_scale": F32_TOL,
        "ms": tf64[k]["ms"], "ms_with_wrapper": tf64[k]["ms_with_wrapper"],
        "plain_ms": tf64[k]["plain_ms"],
        "bound_ms": bf64[k]["bound_ms"], "bound_by": bf64[k]["bound_by"],
        "library_ms": None, "checked_against_plain": True,
        "launches_per_step": runf64["launches_per_step"],
        "step_ms": runf64["ms_per_step"], "gp_steps_per_s": runf64["gp_steps_per_s"],
        "step_ms_per_stage_path": run64["ms_per_step"],
        "ms_256": tf256[k]["ms"], "ms_with_wrapper_256": tf256[k]["ms_with_wrapper"],
        "plain_ms_256": tf256[k]["plain_ms"],
        "bound_ms_256": bf256[k]["bound_ms"], "step_ms_256": runf256["ms_per_step"],
        "gp_steps_per_s_256": runf256["gp_steps_per_s"],
        "step_ms_256_per_stage_path": run256["ms_per_step"],
        "peak_memory_gib_256": peak256, **extraf,
        **ablated_extras(k, tf64[k], tf256[k]),
        "graph": graph_extras("64x64 fused", "64x64 fused"),
        "graph_256": graph_extras("64x64 fused", "256x256 fused"),
        "periodic": {
            case: {"replay_launches_per_step": per[case]["replay"]["replay_kernels"][k],
                   "launches_at_capture": per[case]["run"]["counts"][k],
                   "max_err_over_scale": per[case]["errs"]["float32"][k][0],
                   "max_abs_err": per[case]["errs"]["float32"][k][1],
                   "max_err_over_scale_f64": per[case]["errs"]["float64"][k][0],
                   "step_ms": per[case]["run"]["ms_per_step"],
                   "mass_drift": per[case]["run"]["mass_drift"]}
            for case in ("x_fused", "y_fused")},
        "lsrk_ref_32": {
            "replay_launches_per_step": lr["replay_kernels"][k],
            "launches_at_capture": lr["launches_at_capture"][k],
            "max_err_over_scale": lr["errs"]["float32"][k][0],
            "max_abs_err": lr["errs"]["float32"][k][1],
            "max_err_over_scale_f64": lr["errs"]["float64"][k][0],
            "step_err_f64_kernels_vs_plain": lr["step_err"]},
        "decomposed": decomposed_entry(k),
        "botfr2_64": {
            "replay_launches_per_step": sb["botfr2_fused_64"]["replay"]["replay_kernels"][k],
            "step_ms": sb["botfr2_fused_64"]["run"]["ms_per_step"],
            "mass_drift": sb["botfr2_fused_64"]["run"]["mass_drift"],
            "step_err_f64_vs_per_stage": sb["botfr2_vs_per_stage_f64"]["fused"]},
    } for k in names]
    kernels = [{
        "name": "btp_volume", "route": "cuda",
        "source": "hnumo_tpu_torch/ops/csrc/btp_volume.cu",
        "replaces": "hnumo_tpu/ops/pallas_btp.py:117",
        "launches": run64["launches"], "max_abs_err": main_err[0],
        "max_err_over_scale": main_err[1], "tolerance_over_scale": F32_TOL,
        "ms": tv64["ms"], "ms_with_wrapper": tv64["ms_with_wrapper"],
        "plain_ms": tv64["plain_ms"],
        "bound_ms": b64["bound_ms"], "bound_by": b64["bound_by"],
        "library_ms": None,
        "checked_against_plain": True, "ms_hot": tv64["ms_hot"],
        "ms_hot_with_wrapper": tv64["ms_hot_with_wrapper"],
        "plain_ms_hot": tv64["plain_ms_hot"],
        **ablated_extras("btp_volume", tv64, tv256),
        "launches_per_step": run64["launches_per_step"],
        "step_ms": run64["ms_per_step"], "gp_steps_per_s": run64["gp_steps_per_s"],
        **big, **extra,
        "graph": graph_extras("64x64 per-stage", "64x64 per-stage"),
        "decomposed": decomposed_entry("btp_volume"),
        "curvilinear_32": {
            "launches_at_capture": cr["counts"]["btp_volume"],
            "replay_launches_per_step": curv["replay"]["replay_kernels"]["btp_volume"],
            "max_abs_err": curv["errs"]["float32"][1],
            "max_err_over_scale": curv["errs"]["float32"][0],
            "max_err_over_scale_f64": curv["errs"]["float64"][0],
            "step_err_f64_kernel_vs_plain": curv["step_err"],
            "ms": ct["ms"], "ms_with_wrapper": ct["ms_with_wrapper"],
            "plain_ms": ct["plain_ms"], "ms_hot": ct["ms_hot"],
            "bound_ms": cb["bound_ms"], "bound_by": cb["bound_by"],
            "ms_brick_32": curv["timing_brick"]["ms"],
            "plain_ms_brick_32": curv["timing_brick"]["plain_ms"],
            "metric_spread": curv["metric_spread"], "step_ms": cr["ms_per_step"],
            "gp_steps_per_s": cr["gp_steps_per_s"], "mass_drift": cr["mass_drift"]},
        "quad_family_64": {
            "replay_launches_per_step": qg["replay_kernels"]["btp_volume"],
            "launches_at_capture": qg["launches_at_capture"]["btp_volume"],
            "max_err_over_scale": quad["errs"]["float32"][0],
            "max_abs_err": quad["errs"]["float32"][1],
            "max_err_over_scale_f64": quad["errs"]["float64"][0],
            "step_err_f64_kernel_vs_plain": quad["step_err"],
            "step_ms": qg["ms_per_step"], "gp_steps_per_s": qg["gp_steps_per_s"],
            "mass_drift": qg["mass_drift"], "replay_device_busy_ms": qg["replay_device_busy_ms"]},
        "face_paths_128": {
            "replay_launches_per_step": {k: r["replay_kernels"]["btp_volume"]
                                         for k, r in faces["replays"].items()},
            "step_ms_graph_turns": fms,
            "replay_device_busy_ms": {k: r["replay_device_busy_ms"]
                                      for k, r in faces["replays"].items()},
            "replay_device_activities": {k: r["replay_device_activities"]
                                         for k, r in faces["replays"].items()},
            "step_err_f64_per_direction_vs_flat": faces["step_err"]},
        "lsrk_64": {
            k: {"replay_launches_per_step": v["replay_kernels"]["btp_volume"],
                "launches_at_capture": v["launches_at_capture"]["btp_volume"],
                "replay_device_busy_ms": v["replay_device_busy_ms"],
                "step_ms": v["ms_per_step"], "mass_drift": v["mass_drift"]}
            for k, v in lsrk.items() if k != "lsrk_ref"},
        "periodic": {
            "x_per_stage_64": {
                "replay_launches_per_step":
                    per["x_per_stage"]["replay"]["replay_kernels"]["btp_volume"],
                "max_err_over_scale": per["x_per_stage"]["errs"]["float32"]["btp_volume"][0],
                "max_abs_err": per["x_per_stage"]["errs"]["float32"]["btp_volume"][1],
                "max_err_over_scale_f64":
                    per["x_per_stage"]["errs"]["float64"]["btp_volume"][0],
                "step_ms": per["x_per_stage"]["run"]["ms_per_step"],
                "mass_drift": per["x_per_stage"]["run"]["mass_drift"]},
            "x_32_mega_auto": {
                "replay_launches_per_step":
                    per["x_32_auto"]["replay"]["replay_kernels"]["btp_volume"],
                "replay_megakernel_launches":
                    per["x_32_auto"]["replay"]["replay_kernels"]["btp_mega"]}},
    }, {
        "name": "btp_mega", "route": "cuda",
        "source": "hnumo_tpu_torch/ops/csrc/btp_mega.cu",
        "replaces": "hnumo_tpu/ops/pallas_mega.py:319",
        "launches": run32["launches"], "max_abs_err": mega_abs,
        "max_err_over_scale": mega_err, "tolerance_over_scale": F32_MEGA_TOL,
        "ms": tm32["ms"], "plain_ms": tm32["plain_ms"],
        "bound_ms": b32["bound_ms"], "bound_by": b32["bound_by"],
        "library_ms": None,
        "checked_against_plain": True, "ms_with_wrapper": tm32["ms_with_wrapper"],
        "grid_barriers": b32["barriers"], "mega_route": "resident",
        "launches_resident": run32["mega_routes"]["resident"],
        "ms_memory_only": tm32["ms_memory_only"], "ms_compute_only": tm32["ms_compute_only"],
        "ms_barrier_only": tm32["ms_barrier_only"], "ms_grid_barrier": tm32["ms_grid_barrier"],
        "ms_25": tm25["ms"], "ms_with_wrapper_25": tm25["ms_with_wrapper"],
        "plain_ms_25": tm25["plain_ms"], "bound_ms_25": b25["bound_ms"],
        "mega_route_25": route25,
        "ms_25_memory_only": tm25["ms_memory_only"],
        "ms_25_compute_only": tm25["ms_compute_only"],
        "ms_25_barrier_only": tm25["ms_barrier_only"],
        "ms_25_grid_barrier": tm25["ms_grid_barrier"],
        "max_err_over_scale_by_solve": {f"{g}x{g} {dt} {r}": w
                                        for (g, dt, r), (w, _) in solves.items()},
        "layout": btp_mega_layout(torch.float32, 32 * 32, 5, 9),
        "ptxas": resource_usage("btp_mega"),
        "launches_per_step": run32["launches_per_step"],
        "step_ms": run32["ms_per_step"], "gp_steps_per_s": run32["gp_steps_per_s"],
        "step_ms_mega_off": run32off["ms_per_step"],
        "gp_steps_per_s_mega_off": run32off["gp_steps_per_s"],
        "ms_64": tm64on["ms"], "step_ms_64_mega_on": run64on["ms_per_step"],
        "gp_steps_per_s_64_mega_on": run64on["gp_steps_per_s"],
        **extra32,
        "graph": graph_extras("32x32 megakernel", "32x32 megakernel"),
        "goldens_f64": gold, "campaign_spin_up": spin,
        "cli_32": {"launches_at_capture": c32["launches_at_capture"]["btp_mega"],
                   "replay_launches_per_step": c32["replay"]["replay_kernels"]["btp_mega"],
                   "wall_s": c32["wall_s"], "mass_loss": c32["mass_loss"],
                   "restart_f32": {k: c32[k] for k in (
                       "restored_pb_prime_err", "pb_ulp", "restored_ulps",
                       "restart_vs_straight", "restart_tol", "final_pb_prime_err")},
                   "restart_f64": {k: c64[k] for k in (
                       "restored_pb_prime_err", "pb_ulp", "restored_ulps",
                       "restart_vs_straight", "restart_tol", "final_pb_prime_err")},
                   "ms_per_step_turns": turns_cli},
        "shear_32": {
            "ad_mlswe": SHEAR_AD,
            "replay_launches_per_step": sh["replay_kernels"]["btp_mega"],
            "launches_at_capture": sh["launches_at_capture"]["btp_mega"],
            "steps_graph_equals_eager": sh["steps_bitwise"], "mass_drift": sh["mass_drift"],
            "step_ms": sh["ms_per_step"],
            "du_max_vs_ad0": sh["du_max_float32"],
            "du_over_scale_vs_ad0": sh["du_over_scale_float32"],
            "du_max_vs_ad0_f64": sh["du_max_float64"],
            "du_over_scale_vs_ad0_f64": sh["du_over_scale_float64"],
            "max_err_over_scale": sh["mega_vs_plain"]["max_err_over_scale"],
            "max_abs_err": sh["mega_vs_plain"]["max_abs_err"],
            "mega_route": sh["mega_vs_plain"]["route"]},
        "botfr2_32": {
            "replay_launches_per_step":
                sb["botfr2_mega_32"]["replay"]["replay_kernels"]["btp_mega"],
            "step_ms": sb["botfr2_mega_32"]["run"]["ms_per_step"],
            "mass_drift": sb["botfr2_mega_32"]["run"]["mass_drift"],
            "step_err_f64_vs_per_stage": sb["botfr2_vs_per_stage_f64"]["mega"]},
    }] + fused_entries
    for entry in kernels:      # phase 30's runs that launched the kernel
        entry["bench_30"] = {
            f"{r['nel'][0]}x{r['nel'][1]} p={r['nop']} {r['variant']}": {
                "launches_per_step": r["kernels_per_step"][entry["name"]],
                "ms_per_launch_in_replay": r["kernel_ms_per_launch"].get(entry["name"]),
                "bound_ms": r["bound_ms"][entry["name"]], "step_ms": r["ms_per_step"]}
            for r in bench30 if entry["name"] in r["kernels_per_step"]}
    print(json.dumps({"kernels": kernels, "flatfaces_256": {
        "what": "hnumo_tpu_torch/mesh/flatfaces.py: index_select / index_add_, no kernel "
                "of its own (the JAX package's is an XLA gather and segment-sum)",
        "card": smi, **flat}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
