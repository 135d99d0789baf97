"""Uniform-geometry barotropic volume stage: kernel and plain version.

Counterpart of the second half of hnumo_tpu/ops/pallas_btp.py (`_kernel_uni`
/ `btp_volume_pallas_uni` / `btp_volume_grad_pallas_uni`): kernel A of the
fused barotropic stage, and the volume stage of the per-stage path under
`Config.uni_volume="on"`. On an affine brick mesh every element has the same
diagonal metric, so the metric terms and quadrature weights (and, when asked,
the inverse lumped mass) are constants folded into the scatter weights
instead of per-element tables, and the 3 bottom-layer primes come in NODAL
(25 instead of 81 values per element and channel at p=4) and are interpolated
beside the 4 barotropic channels. With a gradient accumulator (`agr`) the
stage also emits the nodal velocity gradient gv = (u_x, u_y, v_x, v_y), the
auxiliary variable of the LDG viscosity (reference compute_gradient_uv,
src/mod_barotropic_terms.F90:411-443), and adds it to `agr`.
Reference math: create_rhs_btp_volume_qdf (src/mod_rhs_btp.F90:102-209).

Layouts as in ops/btp_volume: nodal (C, E, npts), quad (C, E, nqq).

Two implementations of one function with one contract — `accv`, `accn` and
`agr` are updated IN PLACE and returned beside the freshly allocated `rhs`
(and `gv`):
  btp_volume_uni_cuda   the hand-written CUDA kernel
                        (csrc/btp_volume_uni.cu), f32 and f64, CUDA tensors
                        only; it applies the operators sum-factorised from
                        the 1-D tables
  btp_volume_uni_plain  the same function in torch ops with the Kronecker
                        matrices K, M2, Gx, Gy, any device; used by the CPU
                        tests, by `device="cpu"` models and as the kernel's
                        yardstick of correctness on the card
Neither falls back to the other.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import Tensor

from ._build import load_library
from .btp_volume import eflat, launch_layout


class BtpVolOpsUni(NamedTuple):
    """Operators of the uniform-geometry volume stage (state-independent).

    The Kronecker matrices serve the plain version, the 1-D tables and
    folded weights the kernel; both describe the same operators."""

    K: Tensor        # (npts, nqq) node->quad interp
    M2: Tensor       # (3*nqq, npts) merged weighted scatter operator
    ptab: Tensor     # (6|8, E, nqq): cor, tau_u, tau_v, 1/pbprime,
    #                  dpp_ref_q[-1], H_bcl_ref [, gzx, gzy]
    pbp_df: Tensor   # (E, npts) 1/pbprime_df
    Gx: Tensor | None   # (npts, npts) nodal d/dx (with_grad)
    Gy: Tensor | None
    psiq: Tensor     # (ngl, nq) 1-D node->quad interpolation
    dpsiq: Tensor    # (ngl, nq) 1-D derivative at quad points
    dpsi: Tensor     # (ngl, ngl) 1-D derivative at the nodes
    wq3: Tensor      # (3, nqq): w*ksi_x, w*eta_y, w (uniform metrics folded)
    minv: Tensor     # (npts,) inverse mass folded into the scatter, or ones
    kx_df: float     # nodal d(ksi)/dx, d(eta)/dy of the uniform brick
    ey_df: float

    @property
    def flat_bottom(self) -> bool:
        return self.ptab.shape[0] == 6


def operators_uniform(g, P, flat_bottom: bool, fold_massinv: bool = False,
                      with_grad: bool = False, cell=None) -> BtpVolOpsUni:
    """Build the folded operators (state-independent: once per model).

    fold_massinv: multiply the scatter result by the (uniform) inverse
    lumped mass so the stage emits massinv*rhs directly (the fused path
    applies its face terms pre-folded the same way); without it the stage
    emits rhs and the caller's face path applies massinv. with_grad: also
    build the nodal-gradient matrices of the LDG viscosity aux variable.
    cell: the DeviceGeom whose first element gives the metric that every
    element of the uniform grid shares (default `g`); a block of a domain
    decomposition passes the whole grid's, so that every block folds the
    numbers a serial run folds (the elements' metrics agree only to rounding).
    """
    cell = g if cell is None else cell
    ngl, nq = g.psiq.shape
    K = torch.einsum("jJ,iI->jiJI", g.psiq, g.psiq).reshape(ngl**2, nq**2)
    Dk = torch.einsum("jJ,iI->jiJI", g.psiq, g.dpsiq).reshape(K.shape)
    De = torch.einsum("jJ,iI->jiJI", g.dpsiq, g.psiq).reshape(K.shape)
    wvec = cell.wjac[0, 0].reshape(-1)            # (nqq,), the same in every element
    kx, ey = cell.ksiq_x[0, 0, 0, 0], cell.etaq_y[0, 0, 0, 0]
    wq3 = torch.stack([wvec * kx, wvec * ey, wvec])
    M2 = torch.cat([Dk.T * wq3[0][:, None], De.T * wq3[1][:, None],
                    K.T * wq3[2][:, None]], dim=0)
    minv = (cell.massinv[0, 0].reshape(-1) if fold_massinv
            else torch.ones(ngl * ngl, dtype=K.dtype, device=K.device))
    M2 = M2 * minv[None, :]
    kx_df, ey_df = float(cell.ksi_x[0, 0, 0, 0]), float(cell.eta_y[0, 0, 0, 0])
    Gx = Gy = None
    if with_grad:
        eye = torch.eye(ngl, dtype=K.dtype, device=K.device)
        Gx = kx_df * torch.einsum("jJ,iI->jiJI", eye, g.dpsi).reshape(ngl**2, ngl**2)
        Gy = ey_df * torch.einsum("jJ,iI->jiJI", g.dpsi, eye).reshape(ngl**2, ngl**2)
        Gx, Gy = Gx.contiguous(), Gy.contiguous()

    def ef(a):   # one-time build: make the layout explicit, then view
        return eflat(a.contiguous())

    chans = [ef(P.coriolis_quad), ef(P.tau_wind[0]), ef(P.tau_wind[1]),
             ef(P.one_over_pbprime), ef(P.dpp_ref_q[-1]), ef(P.H_bcl_ref)]
    if not flat_bottom:
        chans += [ef(P.grad_zbot_quad[0]), ef(P.grad_zbot_quad[1])]
    return BtpVolOpsUni(
        K=K.contiguous(), M2=M2.contiguous(), ptab=torch.stack(chans),
        pbp_df=ef(P.one_over_pbprime_df), Gx=Gx, Gy=Gy,
        psiq=g.psiq.contiguous(), dpsiq=g.dpsiq.contiguous(),
        dpsi=g.dpsi.contiguous(), wq3=wq3.contiguous(), minv=minv.contiguous(),
        kx_df=kx_df, ey_df=ey_df)


def _check_operands(ops: BtpVolOpsUni, qb_n, qpln, coup_q, accv, accn, agr, botfr):
    """Shape/dtype/device/contiguity contract shared by both implementations."""
    if botfr not in (0, 1, 2):
        raise ValueError(f"botfr must be 0, 1 or 2, got {botfr!r}")
    if qb_n.ndim != 3 or coup_q.ndim != 3:
        raise ValueError("qb_n must be (4, E, npts) and coup_q (4, E, nqq)")
    _, E, npts = qb_n.shape
    nqq = coup_q.shape[2]
    ngl, nq = ops.psiq.shape
    if ops.ptab.shape[0] not in (6, 8):
        raise ValueError(f"ops.ptab must have 6 or 8 rows, got {ops.ptab.shape[0]}")
    want = {"qb_n": (qb_n, (4, E, npts)), "qpln": (qpln, (3, E, npts)),
            "coup_q": (coup_q, (4, E, nqq)), "accv": (accv, (12, E, nqq)),
            "accn": (accn, (3, E, npts)), "ops.K": (ops.K, (npts, nqq)),
            "ops.M2": (ops.M2, (3 * nqq, npts)),
            "ops.ptab": (ops.ptab, (ops.ptab.shape[0], E, nqq)),
            "ops.pbp_df": (ops.pbp_df, (E, npts)),
            "ops.psiq": (ops.psiq, (ngl, nq)), "ops.dpsiq": (ops.dpsiq, (ngl, nq)),
            "ops.dpsi": (ops.dpsi, (ngl, ngl)), "ops.wq3": (ops.wq3, (3, nqq)),
            "ops.minv": (ops.minv, (npts,))}
    if agr is not None:
        if ops.Gx is None or ops.Gy is None:
            raise ValueError("a gradient accumulator needs operators built "
                             "with with_grad=True")
        want.update({"agr": (agr, (4, E, npts)), "ops.Gx": (ops.Gx, (npts, npts)),
                     "ops.Gy": (ops.Gy, (npts, npts))})
    if (ngl * ngl, nq * nq) != (npts, nqq):
        raise ValueError(f"operators are for npts={ngl * ngl}, nqq={nq * nq}; "
                         f"the operands have npts={npts}, nqq={nqq}")
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


def btp_volume_uni_plain(ops: BtpVolOpsUni, qb_n: Tensor, qpln: Tensor,
                         accv: Tensor, accn: Tensor, coup_q: Tensor,
                         agr: Tensor | None = None, *, grav: float, botfr: int,
                         cd: float, alpha_bot: float):
    """The uniform-geometry volume stage in plain torch ops (any device).

    qb_n: (4, E, npts) nodal barotropic state; qpln: (3, E, npts) NODAL
    bottom-layer primes (channel 0 = δdp'; constant over a solve);
    coup_q: (4, E, nqq) coupling fields (Quu, Quv, Qvv, dH_bcl);
    accv: (12, E, nqq); accn: (3, E, npts); agr: (4, E, npts) or None —
    all updated in place. Whether the bathymetry-gradient source is applied
    follows from the operators (`ops.flat_bottom`).
    Returns (rhs (3, E, npts) — with massinv when the operators fold it —,
    accv, accn) and, with `agr`, also (gv (4, E, npts), agr).
    """
    E, _, _ = _check_operands(ops, qb_n, qpln, coup_q, accv, accn, agr, botfr)
    # one product interpolates all 7 nodal channels to the quad points
    qq = torch.cat([qb_n, qpln]) @ ops.K                   # (7, E, nqq)
    dp, dpp, udp, vdp, ppq, up, vp = qq
    cor, tau_u, tau_v, opbp, pref, Href = ops.ptab[:6]
    pp = pref + ppq                                        # full bottom-layer dp'

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

    sc_x = cor * vdp + grav * (tau_u - tb_u)
    sc_y = -cor * udp + grav * (tau_v - tb_v)
    if not ops.flat_bottom:
        sc_x = sc_x - grav * dpp * ops.ptab[6]
        sc_y = sc_y - grav * dpp * ops.ptab[7]

    Quu, Quv, Qvv, dHbcl = coup_q
    mu = dpp * opbp                                 # ope - 1, conditioned
    mu2 = mu * (2.0 + mu)                           # ope^2 - 1
    ope = 1.0 + mu
    dHq = dHbcl + mu2 * (Href + dHbcl)              # Hq - H_bcl_ref
    qu = ub * udp + ope * Quu
    quv = ub * vdp + ope * Quv
    qv = vb * vdp + ope * Qvv

    # one product scatters all 3 channels: rows are [Fx | Fy | Fs] per element
    zero = torch.zeros_like(dp)
    B = torch.stack([torch.cat([udp, vdp, zero], dim=-1),
                     torch.cat([dHq + qu, quv, sc_x], dim=-1),
                     torch.cat([quv, dHq + qv, sc_y], dim=-1)])   # (3, E, 3*nqq)
    rhs = B @ ops.M2

    # volume averages in core/btp._VOL_ORDER (reference src/mod_rhs_btp.F90:183-192)
    accv += torch.stack([dHq, qu, qv, quv, mu, mu2, ub, vb, udp, vdp, tb_u, tb_v])
    # nodal averages, from the PRE-stage qb (reference :90-92)
    t_df = qb_n[1] * ops.pbp_df
    inv_pb = 1.0 / qb_n[0]
    u_df = qb_n[2] * inv_pb
    v_df = qb_n[3] * inv_pb
    accn += torch.stack([t_df * (2.0 + t_df), u_df, v_df])
    btp_volume_uni_plain.calls += 1
    if agr is None:
        return rhs, accv, accn
    gv = torch.stack([u_df @ ops.Gx, u_df @ ops.Gy, v_df @ ops.Gx, v_df @ ops.Gy])
    agr += gv
    return rhs, accv, accn, gv, agr


btp_volume_uni_plain.calls = 0


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("btp_volume_uni")
    if not getattr(lib, "_hnumo_declared", False):
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.btp_volume_uni_launch.argtypes = [i] * 7 + [p] * 15 + [d] * 5 + [p]
        lib.btp_volume_uni_launch.restype = ctypes.c_int
        lib.btp_volume_uni_describe.argtypes = [i, i, i, ctypes.POINTER(i),
                                                ctypes.POINTER(ctypes.c_longlong),
                                                ctypes.POINTER(i)]
        lib.btp_volume_uni_describe.restype = ctypes.c_int
        lib.btp_volume_uni_smem_bytes.argtypes = [i, i, i]
        lib.btp_volume_uni_smem_bytes.restype = ctypes.c_longlong
        lib.btp_volume_uni_smem_limit.argtypes = []
        lib.btp_volume_uni_smem_limit.restype = ctypes.c_longlong
        lib.btp_volume_uni_error_string.argtypes = [i]
        lib.btp_volume_uni_error_string.restype = ctypes.c_char_p
        lib._hnumo_declared = True
    return lib


def btp_volume_uni_cuda(ops: BtpVolOpsUni, qb_n: Tensor, qpln: Tensor,
                        accv: Tensor, accn: Tensor, coup_q: Tensor,
                        agr: Tensor | None = None, *, grav: float, botfr: int,
                        cd: float, alpha_bot: float):
    """The uniform-geometry volume stage as one CUDA kernel launch
    (csrc/btp_volume_uni.cu); `agr=None` selects the variant without the
    velocity gradient.

    Same operands and contract as `btp_volume_uni_plain`; float32 or float64
    CUDA tensors only. Launches on the current stream and does not
    synchronise. Raises on operands the kernel does not take and on a
    refused launch; builds the kernel at the first call.
    `btp_volume_uni_cuda.launches` counts the launches made.
    """
    E, ngl, nq = _check_operands(ops, qb_n, qpln, coup_q, accv, accn, agr, botfr)
    if qb_n.device.type != "cuda":
        raise ValueError(
            f"btp_volume_uni_cuda takes CUDA tensors, got {qb_n.device}; use "
            "btp_volume_uni_plain (volume_impl='plain') on other devices")
    if qb_n.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"btp_volume_uni_cuda takes float32/float64, got {qb_n.dtype}")
    is_double = int(qb_n.dtype == torch.float64)
    lib = _library()
    smem = lib.btp_volume_uni_smem_bytes(is_double, ngl, nq)
    if smem > lib.btp_volume_uni_smem_limit():
        raise ValueError(
            f"btp_volume_uni_cuda needs {smem} bytes of shared memory per block "
            f"at ngl={ngl}, nq={nq}, {qb_n.dtype}; the card allows "
            f"{lib.btp_volume_uni_smem_limit()}")
    opts = dict(dtype=qb_n.dtype, device=qb_n.device)
    rhs = torch.empty((3, E, ngl * ngl), **opts)
    gv = torch.empty((4, E, ngl * ngl), **opts) if agr is not None else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(qb_n.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.btp_volume_uni_launch(
            is_double, E, ngl, nq, botfr, int(ops.flat_bottom), int(agr is not None),
            qb_n.data_ptr(), qpln.data_ptr(), ops.ptab.data_ptr(), coup_q.data_ptr(),
            ops.pbp_df.data_ptr(), ops.psiq.data_ptr(), ops.dpsiq.data_ptr(),
            ops.dpsi.data_ptr(), ops.wq3.data_ptr(), ops.minv.data_ptr(),
            accv.data_ptr(), accn.data_ptr(), ptr(agr), rhs.data_ptr(), ptr(gv),
            float(grav), float(cd), float(alpha_bot), ops.kx_df, ops.ey_df, stream)
    if err != 0:
        raise RuntimeError(
            f"btp_volume_uni kernel launch failed: CUDA error {err} "
            f"({lib.btp_volume_uni_error_string(err).decode()})")
    btp_volume_uni_cuda.launches += 1
    if agr is None:
        return rhs, accv, accn
    return rhs, accv, accn, gv, agr


btp_volume_uni_cuda.launches = 0


def btp_volume_uni_layout(dtype: torch.dtype, ngl: int, nq: int) -> dict:
    """`launch_layout` of the uniform-geometry volume kernel (builds it at the
    first call)."""
    return launch_layout(_library(), "btp_volume_uni", dtype, ngl, nq)
