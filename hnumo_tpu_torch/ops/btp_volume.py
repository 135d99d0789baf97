"""Fused barotropic volume RHS + average accumulation: kernel and plain version.

Counterpart of hnumo_tpu/ops/pallas_btp.py (`_kernel` / `btp_volume_pallas`).
The innermost hot op of the model: the volume RHS plus the volume/nodal
average accumulators run N_btp*kstages times per barotropic solve, twice per
baroclinic dt (reference create_rhs_btp_volume_qdf,
src/mod_rhs_btp.F90:102-209, plus the accumulator updates of
src/mod_rk_mlswe.F90:84-98).

Element-flattened layouts: nodal (C, E, npts) with npts = ngl*ngl, quad
(C, E, nqq) with nqq = nq*nq. The 2D tensor-product operators become
single products with Kronecker matrices:
  interp     u_q = u_n @ K,           K[n,Q]  = psi_j(J) psi_i(I)
  scatter    r_n = a_ksi @ DkT + a_eta @ DeT + s @ K^T
where DkT[Q,n] = psi_j(J) dpsi_i(I), DeT[Q,n] = dpsi_j(J) psi_i(I) — the
flattened form of ops.dg.scatter_volume. The plain version multiplies by
these matrices; the kernel applies the same operators as two passes each
over the 1-D tables psiq, dpsiq they are built from (sum factorisation),
which holds for any geometry: the metric enters pointwise, through `met`.

Two implementations of one function with one contract — `accv` and `accn`
are updated IN PLACE and returned beside the freshly allocated `rhs`:
  btp_volume_cuda   the hand-written CUDA kernel (csrc/btp_volume.cu),
                    f32 and f64, CUDA tensors only; built at first launch
  btp_volume_plain  the same arithmetic in torch ops, any device; used by
                    the CPU tests, by `device="cpu"` models and as the
                    kernel's yardstick of correctness on the card
Neither falls back to the other.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import Tensor

from ._build import load_library


class BtpVolOperators(NamedTuple):
    """Static flattened tensor-product operator matrices + element tables.

    The Kronecker matrices serve the plain version, the 1-D tables the
    kernel; both describe the same operators."""

    K: Tensor       # (npts, nqq) node->quad interp (its transpose scatters Fs)
    DkT: Tensor     # (nqq, npts) d/dksi-weighted scatter
    DeT: Tensor     # (nqq, npts)
    met: Tensor     # (5, E, nqq): ksiq_x, ksiq_y, etaq_x, etaq_y, wjac
    ptab: Tensor    # (8, E, nqq): coriolis, tau_u, tau_v, gzx, gzy,
    #                 one_over_pbprime, dpp_ref_q[-1], H_bcl_ref
    pbp_df: Tensor  # (E, npts): 1/pbprime_df (nodal, for the mu2_df average)
    psiq: Tensor    # (ngl, nq) 1-D node->quad interpolation
    dpsiq: Tensor   # (ngl, nq) 1-D derivative at the quad points


def eflat(a: Tensor) -> Tensor:
    """(..., ney, nex, m, m) -> (..., E, m*m): element-flatten.

    A free view on a contiguous tensor; raises (rather than copying
    silently) on a layout that cannot be viewed — call `.contiguous()` at
    the call site where a stack or slice made the tensor non-contiguous."""
    return a.view(a.shape[:-4] + (a.shape[-4] * a.shape[-3],
                                  a.shape[-2] * a.shape[-1]))


def operators_from_tables(g, P) -> BtpVolOperators:
    """Build the flattened operator tables from geometry and precomputed
    physics tables (state-independent: built once per model)."""
    ngl, nq = g.psiq.shape
    K = torch.einsum("jJ,iI->jiJI", g.psiq, g.psiq).reshape(ngl**2, nq**2)
    Dk = torch.einsum("jJ,iI->jiJI", g.psiq, g.dpsiq).reshape(K.shape)
    De = torch.einsum("jJ,iI->jiJI", g.dpsiq, g.psiq).reshape(K.shape)
    def ef(a):   # one-time build: make the layout explicit, then view
        return eflat(a.contiguous())

    met = torch.stack([ef(g.ksiq_x), ef(g.ksiq_y), ef(g.etaq_x), ef(g.etaq_y),
                       ef(g.wjac)])
    ptab = torch.stack([
        ef(P.coriolis_quad), ef(P.tau_wind[0]), ef(P.tau_wind[1]),
        ef(P.grad_zbot_quad[0]), ef(P.grad_zbot_quad[1]),
        ef(P.one_over_pbprime), ef(P.dpp_ref_q[-1]), ef(P.H_bcl_ref)])
    return BtpVolOperators(K=K.contiguous(), DkT=Dk.T.contiguous(),
                           DeT=De.T.contiguous(), met=met, ptab=ptab,
                           pbp_df=ef(P.one_over_pbprime_df),
                           psiq=g.psiq.contiguous(), dpsiq=g.dpsiq.contiguous())


def _check_operands(ops: BtpVolOperators, qb_n, qpl_q, coup_q, accv, accn, botfr):
    """Shape/dtype/device/contiguity contract shared by both implementations."""
    if botfr not in (0, 1, 2):
        raise ValueError(f"botfr must be 0, 1 or 2, got {botfr!r}")
    if qb_n.ndim != 3 or coup_q.ndim != 3:
        raise ValueError("qb_n must be (4, E, npts) and coup_q (4, E, nqq)")
    _, E, npts = qb_n.shape
    nqq = coup_q.shape[2]
    if ops.psiq.ndim != 2:
        raise ValueError(f"ops.psiq must be (ngl, nq), got {tuple(ops.psiq.shape)}")
    ngl, nq = ops.psiq.shape
    if (ngl * ngl, nq * nq) != (npts, nqq):
        raise ValueError(f"the 1-D tables are for npts={ngl * ngl}, nqq={nq * nq}; "
                         f"the operands have npts={npts}, nqq={nqq}")
    want = {"qb_n": (qb_n, (4, E, npts)), "qpl_q": (qpl_q, (3, E, nqq)),
            "coup_q": (coup_q, (4, E, nqq)), "accv": (accv, (12, E, nqq)),
            "accn": (accn, (3, E, npts)), "ops.K": (ops.K, (npts, nqq)),
            "ops.DkT": (ops.DkT, (nqq, npts)), "ops.DeT": (ops.DeT, (nqq, npts)),
            "ops.met": (ops.met, (5, E, nqq)), "ops.ptab": (ops.ptab, (8, E, nqq)),
            "ops.pbp_df": (ops.pbp_df, (E, npts)),
            "ops.psiq": (ops.psiq, (ngl, nq)), "ops.dpsiq": (ops.dpsiq, (ngl, nq))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != qb_n.dtype or t.device != qb_n.device:
            raise ValueError(
                f"{name} is {t.dtype} on {t.device}, expected {qb_n.dtype} on "
                f"{qb_n.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return E, ngl, nq


def btp_volume_plain(ops: BtpVolOperators, qb_n: Tensor, qpl_q: Tensor,
                     coup_q: Tensor, accv: Tensor, accn: Tensor, *,
                     grav: float, botfr: int, cd: float, alpha_bot: float):
    """The fused volume stage in plain torch ops (any device).

    qb_n: (4, E, npts) nodal barotropic state; qpl_q: (3, E, nqq) bottom
    layer primes AT QUAD POINTS (channel 0 = δdp'; constant over a solve);
    coup_q: (4, E, nqq) coupling fields (Quu, Quv, Qvv, dH_bcl);
    accv: (12, E, nqq); accn: (3, E, npts) — both updated in place.
    Returns (rhs (3, E, npts) without massinv, accv, accn).
    `btp_volume_plain.calls` counts the calls.
    """
    _check_operands(ops, qb_n, qpl_q, coup_q, accv, accn, botfr)
    K, DkT, DeT = ops.K, ops.DkT, ops.DeT
    qbq = qb_n @ K                                  # (4, E, nqq)
    dp, dpp, udp, vdp = qbq[0], qbq[1], qbq[2], qbq[3]
    ppq, up, vp = qpl_q[0], qpl_q[1], qpl_q[2]
    cor, tau_u, tau_v, gzx, gzy, opbp, pref, Href = ops.ptab
    pp = pref + ppq                                 # full bottom-layer dp'

    inv_dp = 1.0 / dp
    ub = udp * inv_dp
    vb = vdp * inv_dp

    if botfr == 1:      # linear bottom drag (reference :157-162)
        spd = (cd / grav) * pp
        tb_u = spd * (up + ub)
        tb_v = spd * (vp + vb)
    elif botfr == 2:    # quadratic (reference :163-169)
        ubot, vbot = up + ub, vp + vb
        spd = (cd / alpha_bot) * torch.sqrt(ubot * ubot + vbot * vbot)
        tb_u = spd * ubot
        tb_v = spd * vbot
    else:
        tb_u = torch.zeros_like(dp)
        tb_v = torch.zeros_like(dp)

    sc_x = cor * vdp + grav * (tau_u - tb_u) - grav * dpp * gzx
    sc_y = -cor * udp + grav * (tau_v - tb_v) - grav * dpp * gzy

    Quu, Quv, Qvv, dHbcl = coup_q
    mu = dpp * opbp                                 # ope - 1, conditioned
    mu2 = mu * (2.0 + mu)                           # ope^2 - 1
    ope = 1.0 + mu
    dHq = dHbcl + mu2 * (Href + dHbcl)              # Hq - H_bcl_ref
    qu = ub * udp + ope * Quu
    quv = ub * vdp + ope * Quv
    qv = vb * vdp + ope * Qvv

    kx, ky, ex, ey, wj = ops.met

    def scatter(Fx, Fy, Fs):
        r = (wj * (Fx * kx + Fy * ky)) @ DkT + (wj * (Fx * ex + Fy * ey)) @ DeT
        if Fs is not None:
            r = r + (wj * Fs) @ K.T
        return r

    rhs = torch.stack([scatter(udp, vdp, None),
                       scatter(dHq + qu, quv, sc_x),
                       scatter(quv, dHq + qv, sc_y)])

    # volume averages in core/btp._VOL_ORDER (reference src/mod_rhs_btp.F90:183-192)
    accv += torch.stack([dHq, qu, qv, quv, mu, mu2, ub, vb, udp, vdp, tb_u, tb_v])
    # nodal averages, from the PRE-stage qb (reference :90-92)
    t_df = qb_n[1] * ops.pbp_df
    inv_pb = 1.0 / qb_n[0]
    accn += torch.stack([t_df * (2.0 + t_df), qb_n[2] * inv_pb, qb_n[3] * inv_pb])
    btp_volume_plain.calls += 1
    return rhs, accv, accn


btp_volume_plain.calls = 0


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("btp_volume")
    if not getattr(lib, "_hnumo_declared", False):
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.btp_volume_launch.argtypes = [i, i] + [p] * 11 + [i, i, i, d, d, d, p]
        lib.btp_volume_launch.restype = ctypes.c_int
        lib.btp_volume_describe.argtypes = [i, i, i, ctypes.POINTER(i),
                                            ctypes.POINTER(ctypes.c_longlong),
                                            ctypes.POINTER(i)]
        lib.btp_volume_describe.restype = ctypes.c_int
        lib.btp_volume_smem_bytes.argtypes = [i, i, i]
        lib.btp_volume_smem_bytes.restype = ctypes.c_longlong
        lib.btp_volume_smem_limit.argtypes = []
        lib.btp_volume_smem_limit.restype = ctypes.c_longlong
        lib.btp_volume_error_string.argtypes = [i]
        lib.btp_volume_error_string.restype = ctypes.c_char_p
        lib._hnumo_declared = True
    return lib


def btp_volume_cuda(ops: BtpVolOperators, qb_n: Tensor, qpl_q: Tensor,
                    coup_q: Tensor, accv: Tensor, accn: Tensor, *,
                    grav: float, botfr: int, cd: float, alpha_bot: float):
    """The fused volume stage as one CUDA kernel launch (csrc/btp_volume.cu).

    Same operands and contract as `btp_volume_plain`; float32 or float64
    CUDA tensors only. Launches on the current stream and does not
    synchronise. Raises on operands the kernel does not take and on a
    refused launch; builds the kernel at the first call.
    `btp_volume_cuda.launches` counts the launches made.
    """
    E, ngl, nq = _check_operands(ops, qb_n, qpl_q, coup_q, accv, accn, botfr)
    if qb_n.device.type != "cuda":
        raise ValueError(
            f"btp_volume_cuda takes CUDA tensors, got {qb_n.device}; use "
            "btp_volume_plain (volume_impl='plain') on other devices")
    if qb_n.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"btp_volume_cuda takes float32/float64, got {qb_n.dtype}")
    is_double = int(qb_n.dtype == torch.float64)
    lib = _library()
    smem = lib.btp_volume_smem_bytes(is_double, ngl, nq)
    if smem > lib.btp_volume_smem_limit():
        raise ValueError(
            f"btp_volume_cuda stages two elements' inputs in shared memory: "
            f"ngl={ngl}, nq={nq}, {qb_n.dtype} needs {smem} bytes, the "
            f"card allows {lib.btp_volume_smem_limit()}")
    rhs = torch.empty((3, E, ngl * ngl), dtype=qb_n.dtype, device=qb_n.device)
    with torch.cuda.device(qb_n.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.btp_volume_launch(
            is_double, botfr, qb_n.data_ptr(), qpl_q.data_ptr(),
            ops.met.data_ptr(), ops.ptab.data_ptr(), coup_q.data_ptr(),
            ops.psiq.data_ptr(), ops.dpsiq.data_ptr(),
            ops.pbp_df.data_ptr(), accv.data_ptr(), accn.data_ptr(),
            rhs.data_ptr(), E, ngl, nq, float(grav), float(cd),
            float(alpha_bot), stream)
    if err != 0:
        raise RuntimeError(
            f"btp_volume kernel launch failed: CUDA error {err} "
            f"({lib.btp_volume_error_string(err).decode()})")
    btp_volume_cuda.launches += 1
    return rhs, accv, accn


btp_volume_cuda.launches = 0


def launch_layout(lib, prefix: str, dtype: torch.dtype, *sizes: int,
                  unit: str = "elements") -> dict:
    """How the kernel `prefix` of the built library `lib` lays a launch out
    on the current CUDA device at these sizes (`ngl, nq`, or what the
    kernel's `<prefix>_describe` takes): `unit`s (elements or faces) per
    tile, bytes of shared memory per block, resident blocks per SM."""
    tile, blocks = ctypes.c_int(), ctypes.c_int()
    smem = ctypes.c_longlong()
    err = getattr(lib, f"{prefix}_describe")(
        int(dtype == torch.float64), *sizes, ctypes.byref(tile), ctypes.byref(smem),
        ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(
            f"{prefix}: no launch layout at sizes {sizes}, {dtype}: CUDA error "
            f"{err} ({getattr(lib, f'{prefix}_error_string')(err).decode()})")
    return {f"tile_{unit}": tile.value, "smem_bytes": smem.value,
            "blocks_per_sm": blocks.value}


def btp_volume_layout(dtype: torch.dtype, ngl: int, nq: int) -> dict:
    """`launch_layout` of the volume kernel (builds it at the first call)."""
    return launch_layout(_library(), "btp_volume", dtype, ngl, nq)
