"""Smoke run of the PyTorch/CUDA port (hnumo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # everything; needs one CUDA device + nvcc
    python3 chip_smoke.py --profile FILE  # also a torch.profiler table of one step

Builds the CUDA kernel from the sources in this checkout, holds it against
its plain PyTorch version on the card, drives the port's main path (the
double-gyre configuration, f32, 64x64 elements, p=4, 2 layers, SSP(5,3),
N_btp=20) through `Model.run`, and repeats a short run at 256x256. Any
failure raises and the run exits non-zero; there is no CPU path.

Output: one line per phase, then a `{"kernels": [...]}` line, the card's
name and power limit, and as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet): the yardstick of `bound_ms`
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

F64_TOL = 1e-12     # kernel vs plain, f64: same operations, other summation order
F32_TOL = 2e-5      # kernel vs plain, f32: ~100-term sums in another order
SOLVE_TOL = 1e-11   # f64 barotropic solve, kernel vs plain, over N_btp*kstages stages
MASS_TOL = 1e-6     # relative total-mass change over the f32 run


def main_path_config(nel: int, dtype: str, nop: int = 4):
    """The double-gyre basin of the JAX package's bench.py (same dt scaling)."""
    from hnumo_tpu_torch.config import Config

    scale = (25.0 / nel) * (4.0 / nop) ** 2
    return Config(
        nelx=nel, nely=nel, nopx=nop, nopy=nop,
        xdims=(0.0, 2.0e6), ydims=(0.0, 2.0e6), nlayers=2,
        dt=500.0 * scale, dt_btp=25.0 * scale, time_final=1e9,
        test_case="double_gyre", f0=9.3e-5, beta=2.0e-11,
        botfr=1, cd_mlswe=1.0e-7, method_visc=2, visc_mlswe=100.0,
        dtype=dtype)


def small_config(nelx: int, nely: int, dtype: str, botfr: int):
    from hnumo_tpu_torch.config import Config

    return Config(nelx=nelx, nely=nely, nopx=4, nopy=4, xdims=(0.0, 2e6),
                  ydims=(0.0, 2e6), nlayers=2, dt=400.0, dt_btp=20.0,
                  time_final=1e9, test_case="double_gyre", f0=9.3e-5,
                  beta=2e-11, botfr=botfr, cd_mlswe=1e-7,
                  method_visc=2, visc_mlswe=100.0, dtype=dtype)


def perturbed_inputs(m, seed: int):
    """A state off the rest state (so nothing is all zeros) and its coupling."""
    from hnumo_tpu_torch.core.bcl import extract_qprime_faces
    from hnumo_tpu_torch.core.coupling import btp_bcl_coeffs

    rng = np.random.default_rng(seed)
    s = m.state0

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


def check_kernel_against_plain(nelx, nely, dtype, botfr):
    """One comparison; returns (max scaled error, max abs error)."""
    from hnumo_tpu_torch.model import Model
    from hnumo_tpu_torch.ops.btp_volume import btp_volume_cuda, btp_volume_plain

    m = Model(small_config(nelx, nely, dtype, botfr))
    qbf, qplq, coupf, accv0, accn0 = volume_operands(m, seed=botfr)
    kw = volume_kwargs(m.static)
    av_k, an_k = accv0.clone(), accn0.clone()
    rhs_k, av_k2, an_k2 = btp_volume_cuda(m.vol_ops, qbf, qplq, coupf, av_k, an_k, **kw)
    torch.cuda.synchronize()
    if av_k2 is not av_k or an_k2 is not an_k:
        raise AssertionError("kernel wrapper must return the accumulators it was given")
    av_p, an_p = accv0.clone(), accn0.clone()
    rhs_p, _, _ = btp_volume_plain(m.vol_ops, qbf, qplq, coupf, av_p, an_p, **kw)
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
                f"kernel != plain: {name} {dtype} botfr={botfr} E={nelx * nely}: "
                f"max|diff|={err:.3e} > {tol:g}*{scale:.3e}")
    return worst_scaled, worst_abs


def check_solve_kernel_vs_plain():
    """f64 barotropic_solve at 12x12: kernel stage vs plain stage."""
    import dataclasses

    from hnumo_tpu_torch.core.btp import barotropic_solve
    from hnumo_tpu_torch.model import Model

    m = Model(small_config(12, 12, "float64", 1))
    _, qb, qp, coup = perturbed_inputs(m, seed=7)
    out = {}
    for impl in ("kernel", "plain"):
        st = dataclasses.replace(m.static, volume_impl=impl)
        out[impl] = barotropic_solve(st, m.P, m.g, m.bc, coup, qb, qp,
                                     vol_ops=m.vol_ops)
        torch.cuda.synchronize()

    def leaves(qb_new, avg):
        yield "qb", qb_new
        for f in avg._fields:
            if f != "faces":
                yield f, getattr(avg, f)
        for d, fa in zip("xy", avg.faces):
            for f in fa._fields:
                yield f"faces.{d}.{f}", getattr(fa, f)

    worst, n = 0.0, 0
    for (name, a), (_, b) in zip(leaves(*out["kernel"]), leaves(*out["plain"])):
        scale = max(float(b.abs().max()), 1e-300)
        err = float((a - b).abs().max())
        worst = max(worst, err / scale)
        n += 1
        if not err <= SOLVE_TOL * scale:
            raise AssertionError(f"solve kernel != plain: {name}: {err:.3e} vs scale {scale:.3e}")
    return worst, n


def time_launches(fn, operand_sets, n):
    """Mean ms per call of fn(*operands), rotating over the operand sets."""
    for ops in operand_sets:
        fn(*ops)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(n):
        fn(*operand_sets[i % len(operand_sets)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def time_volume_stage(m, n=60, nsets=None):
    """Kernel and plain version at this model's shapes.

    Times are taken twice: rotating over enough independent operand sets to
    exceed the 50 MB L2 ("cold": every launch reads its data from device
    memory), and on one set again and again ("hot")."""
    from hnumo_tpu_torch.ops.btp_volume import btp_volume_cuda, btp_volume_plain

    kw = volume_kwargs(m.static)
    first = volume_operands(m, seed=11)
    set_bytes = sum(t.numel() * t.element_size() for t in first)
    if nsets is None:
        nsets = max(2, min(6, int(np.ceil(3 * 50e6 / set_bytes)) + 1))
    sets = [first] + [tuple(t.clone() for t in first) for _ in range(nsets - 1)]

    def kernel(*ops):
        btp_volume_cuda(m.vol_ops, *ops, **kw)

    def plain(*ops):
        btp_volume_plain(m.vol_ops, *ops, **kw)

    return {"ms": time_launches(kernel, sets, n),
            "plain_ms": time_launches(plain, sets, n),
            "ms_hot": time_launches(kernel, sets[:1], n),
            "plain_ms_hot": time_launches(plain, sets[:1], n)}


def volume_bound(m):
    """Least time the card could take for one volume stage at this model's
    shapes: bytes once over the HBM rate vs flops over the f32 peak."""
    ngl, nq = m.g.psiq.shape
    npts, nqq = ngl * ngl, nq * nq
    E = m.cfg.nelx * m.cfg.nely
    itemsize = 8 if m.cfg.dtype == "float64" else 4
    # in: qb 4, pbp 1, accn 3 (nodal); qpl 3, met 5, ptab 8, coup 4, accv 12 (quad)
    # out: rhs 3, accn 3 (nodal); accv 12 (quad); operators 3*npts*nqq once
    nbytes = itemsize * (E * (14 * npts + 44 * nqq) + 3 * npts * nqq)
    # 4 interpolations + 8 scatter rows, 2 flops per multiply-add; ~110 pointwise per quad point
    flops = E * (2 * 12 * npts * nqq + 110 * nqq + 8 * npts)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": nbytes, "flops": flops}


def total_mass(m, state) -> float:
    dp = (m.P.dpp_ref_df + state.q_df[0]).double()
    return float((m.g.wjac_df.double() * dp).sum())


def drive(m, warm: int, steps: int):
    """`warm` + `steps` baroclinic steps through Model.run; launches are
    counted over the timed steps only (the counter is zeroed just before)."""
    from hnumo_tpu_torch.ops.btp_volume import btp_volume_cuda

    s = m.state0
    mass0 = total_mass(m, s)
    s = m.run(s, warm)
    torch.cuda.synchronize()
    btp_volume_cuda.launches = 0
    t0 = time.perf_counter()
    s = m.run(s, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = btp_volume_cuda.launches
    per_step = 2 * m.static.n_btp * m.static.kstages
    if launches != steps * per_step:
        raise AssertionError(
            f"volume kernel launched {launches} times in {steps} steps, "
            f"expected {steps}*{per_step}")
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
    return {"ms_per_step": wall / steps * 1e3, "gp_steps_per_s": gp * steps / wall,
            "launches": launches, "launches_per_step": per_step,
            "mass_drift": drift, "t": float(s.t)}, s


def profile_step(m, state, out_path):
    """torch.profiler over one step: device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        m.step(state)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    with open(out_path, "w") as f:
        f.write(table)
    # rows of device activities (kernels, memcpys) only: the operator rows
    # repeat their kernels' device time
    from torch.autograd import DeviceType
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {"device_busy_ms": sum(e.self_device_time_total for e in dev) / 1e3,
            "device_activities": sum(e.count for e in dev)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="FILE", default=None,
                    help="also write a torch.profiler table of one 64x64 step to FILE")
    args = ap.parse_args()

    # ---- phase 1: device ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"phase 1 device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    from hnumo_tpu_torch.model import Model
    from hnumo_tpu_torch.ops._build import load_library
    from hnumo_tpu_torch.ops.btp_volume import btp_volume_cuda

    # ---- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    load_library("btp_volume")
    print(f"phase 2 build: btp_volume.cu compiled and loaded in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- phase 3: kernel vs plain version ------------------------------------
    worst = {"float64": 0.0, "float32": 0.0}
    main_err = None
    for dtype in ("float64", "float32"):
        for botfr in (0, 1, 2):
            for nelx, nely in ((6, 5), (64, 64)):
                scaled, abs_err = check_kernel_against_plain(nelx, nely, dtype, botfr)
                worst[dtype] = max(worst[dtype], scaled)
                if (dtype, botfr, nelx) == ("float32", 1, 64):   # the main path's shapes
                    main_err = (abs_err, scaled)
    print(f"phase 3 kernel vs plain (botfr 0/1/2, E=30 and E=4096, rhs+accv+accn): "
          f"f64 max err/scale {worst['float64']:.3e} (tol {F64_TOL:g}), "
          f"f32 {worst['float32']:.3e} (tol {F32_TOL:g})")

    # ---- phase 4: barotropic solve, kernel vs plain stage --------------------
    w, n = check_solve_kernel_vs_plain()
    print(f"phase 4 f64 barotropic_solve 12x12, kernel vs plain stage: qb + {n - 1} "
          f"averages, max err/scale {w:.3e} (tol {SOLVE_TOL:g})")

    # ---- phase 5: main path, 64x64 f32 ---------------------------------------
    m64 = Model(main_path_config(64, "float32"))
    if m64.static.volume_impl != "kernel":
        raise AssertionError("the main path must run the CUDA volume kernel")
    run64, s64 = drive(m64, warm=2, steps=5)
    tv64 = time_volume_stage(m64)
    b64 = volume_bound(m64)
    print(f"phase 5 main path 64x64 p=4 L=2 f32 N_btp={m64.static.n_btp}: "
          f"{run64['ms_per_step']:.2f} ms/step, {run64['gp_steps_per_s']:.4g} gp-steps/s, "
          f"{run64['launches_per_step']} kernel launches/step, ok, finite, "
          f"mass drift {run64['mass_drift']:.2e}; volume kernel {tv64['ms']:.4f} ms/launch "
          f"(hot {tv64['ms_hot']:.4f}), plain {tv64['plain_ms']:.4f}, "
          f"bound {b64['bound_ms']:.4f} ms by {b64['bound_by']}")
    extra = {}
    if args.profile:
        extra = profile_step(m64, s64, args.profile)
        extra["device_idle_share"] = 1.0 - extra["device_busy_ms"] / run64["ms_per_step"]
        print(f"phase 5 profile of one step: {json.dumps(extra)}")
    del s64

    # ---- phase 6: 256x256 f32 -------------------------------------------------
    m256 = Model(main_path_config(256, "float32"))
    run256, _ = drive(m256, warm=0, steps=2)
    tv256 = time_volume_stage(m256, n=20, nsets=2)
    b256 = volume_bound(m256)
    print(f"phase 6 256x256 p=4 L=2 f32: {run256['ms_per_step']:.1f} ms/step, "
          f"{run256['gp_steps_per_s']:.4g} gp-steps/s, ok, finite, mass drift "
          f"{run256['mass_drift']:.2e}; volume kernel {tv256['ms']:.4f} ms/launch, "
          f"plain {tv256['plain_ms']:.4f}, bound {b256['bound_ms']:.4f} ms by "
          f"{b256['bound_by']}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    big = {"ms_256": tv256["ms"], "plain_ms_256": tv256["plain_ms"],
           "bound_ms_256": b256["bound_ms"],
           "step_ms_256": run256["ms_per_step"],
           "gp_steps_per_s_256": run256["gp_steps_per_s"]}
    del m256

    # ---- phase 7: the kernels line -------------------------------------------
    kernels = [{
        "name": "btp_volume", "route": "cuda",
        "source": "hnumo_tpu_torch/ops/csrc/btp_volume.cu",
        "replaces": "hnumo_tpu/ops/pallas_btp.py:117",
        "launches": run64["launches"], "max_abs_err": main_err[0],
        "max_err_over_scale": main_err[1], "tolerance_over_scale": F32_TOL,
        "ms": tv64["ms"], "plain_ms": tv64["plain_ms"],
        "bound_ms": b64["bound_ms"], "bound_by": b64["bound_by"],
        "library_ms": None,
        "checked_against_plain": True, "ms_hot": tv64["ms_hot"],
        "plain_ms_hot": tv64["plain_ms_hot"],
        "launches_per_step": run64["launches_per_step"],
        "step_ms": run64["ms_per_step"], "gp_steps_per_s": run64["gp_steps_per_s"],
        **big, **extra,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
