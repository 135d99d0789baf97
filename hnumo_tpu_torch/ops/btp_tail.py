"""The tail of the fused barotropic stage — face fluxes, LDG viscosity,
SSPRK update, all face averages: two kernels and their plain versions.

Counterpart of hnumo_tpu/ops/pallas_btp_tail.py. Together with
ops/btp_volume_uni (kernel A) this makes the whole barotropic stage — the
model's innermost hot loop, N_btp*kstages evaluations per solve, 2 solves per
baroclinic dt — three kernels plus one plain-PyTorch trace exchange
(core/btp._barotropic_solve_fused):

  kernel F (`btp_faces_*`): per-face linearised-Riemann / averaged flux of
      the 4 barotropic variables (reference creat_btp_fluxes_qdf,
      src/mod_rhs_btp.F90:211-364) + the nodal LDG viscosity face flux
      (create_rhs_laplacian_flux, src/mod_laplacian_quad.F90:427-519) + the
      16 quad + 8 nodal face averages (src/mod_rk_mlswe.F90:45-78), over ALL
      faces of both directions on one flat face axis
        [x-faces row-major (ney, nex+1) ; y-faces (ney+1, nex)].
      The formulas depend on direction only through the per-face tables.
  kernel U (`btp_update_*`): per-element placement of the signed face values
      on the edge nodes, the nodal LDG viscosity volume term
      (btp_compute_laplacian, src/mod_laplacian_quad.F90:357-425), the static
      δ-form reference vector, inverse mass (folded into the operators), the
      SSPRK stage combine (src/mod_rk_mlswe.F90:99-119) and the wall momentum
      projection (as multiplicative masks).

Each function has two implementations with one contract:
  btp_faces_cuda / btp_update_cuda    hand-written CUDA kernels
      (csrc/btp_faces.cu, csrc/btp_update.cu), f32 and f64, CUDA tensors only
  btp_faces_plain / btp_update_plain  the same functions in torch ops, any
      device; used by the CPU tests, by `device="cpu"` models and as the
      kernels' yardstick of correctness on the card
Neither falls back to the other. The face stage updates its accumulators
`af` and `ag` IN PLACE and returns them; the update stage writes a NEW state
tensor and mutates none of its inputs (the caller's SSPRK registers alias).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import Tensor

from ._build import load_library
from .btp_volume import eflat, launch_layout

_FTAB_STATIC = ("nx", "ny", "jac", "coeff_pbpert_L", "coeff_pbpert_R",
                "coeff_pbub_LR", "one_over_pbprime_edge", "coeff_mass_pbub_L",
                "coeff_mass_pbub_R", "coeff_mass_pbpert_LR", "Hedge_ref")
_NTAB = ("pbprime_df_face_L", "pbprime_df_face_R", "nx_df", "ny_df", "jac_df")


def _fflat(a: Tensor) -> Tensor:
    """(..., fy, fx, m) -> (..., F, m)."""
    return a.reshape(a.shape[:-3] + (a.shape[-3] * a.shape[-2], a.shape[-1]))


def _cat_faces(ax: Tensor, ay: Tensor) -> Tensor:
    """x-face and y-face tables on the one flat face axis."""
    return torch.cat([_fflat(ax), _fflat(ay)], dim=-2)


# ---------------------------------------------------------------------------
# kernel F: all-faces flux + face averages
# ---------------------------------------------------------------------------


class FaceTailTables(NamedTuple):
    """Flattened all-faces tables of the face stage."""

    ftab: Tensor         # (15, F, nq): nx, ny, jac, cpL, cpR, cpub, omE,
    #                      cmL, cmR, cmLR, Hedge, Quu_e, Quv_e, Qvv_e, dHb_e
    ntab: Tensor         # (5, F, ngl): pbdfL, pbdfR, nx_df, ny_df, jac_df
    bgf: Tensor | None   # (10, F, ngl): btp_graduv_dpp_face, L rows 0-4, R rows
    #                      5-9 (rows 4 and 9 the multiplier); None when inviscid
    psiq: Tensor         # (ngl, nq)
    nfx: int             # x-face count ney*(nex+1)
    nfy: int


def static_face_rows(P) -> tuple[Tensor, Tensor]:
    """The rows of `ftab` and the `ntab` that do not depend on the state
    ((11, F, nq), (5, F, ngl)): built once per model."""
    fx, fy = P.faces.x, P.faces.y
    ftab = torch.stack([_cat_faces(getattr(fx, n), getattr(fy, n)) for n in _FTAB_STATIC])
    ntab = torch.stack([_cat_faces(getattr(fx, n), getattr(fy, n)) for n in _NTAB])
    return ftab.contiguous(), ntab.contiguous()


def build_face_tables(P, coup, psiq: Tensor, use_visc: bool,
                      static_rows=None) -> FaceTailTables:
    """Both directions' static and per-solve coupling face tables on the flat
    face axis. `static_rows`: what `static_face_rows(P)` returned, when the
    caller built it ahead; the per-solve rows (the coupling edge values and
    `bgf`) are appended here, once per barotropic solve."""
    ftab_s, ntab = static_rows if static_rows is not None else static_face_rows(P)
    ftab = torch.cat([ftab_s, torch.stack([
        _cat_faces(p.x, p.y) for p in (coup.Q_uu_dp_edge, coup.Q_uv_dp_edge,
                                       coup.Q_vv_dp_edge, coup.dH_bcl_edge)])])
    fx = P.faces.x.nx
    fy = P.faces.y.nx
    nfx, nfy = fx.shape[0] * fx.shape[1], fy.shape[0] * fy.shape[1]
    bgf = None
    if use_visc:
        # (5, 2, F.., ngl) -> (2, 5, F, ngl) -> (10, F, ngl): rows 0-4 L, 5-9 R
        ngl = ntab.shape[-1]
        bx = coup.btp_graduv_dpp_face.x.transpose(0, 1).reshape(10, nfx, ngl)
        by = coup.btp_graduv_dpp_face.y.transpose(0, 1).reshape(10, nfy, ngl)
        bgf = torch.cat([bx, by], dim=1)
    return FaceTailTables(ftab=ftab, ntab=ntab, bgf=bgf, psiq=psiq.contiguous(),
                          nfx=nfx, nfy=nfy)


def _check_faces(tabs: FaceTailTables, trL, trR, af, ag, use_visc):
    ngl, nq = tabs.psiq.shape
    F = tabs.nfx + tabs.nfy
    C = 8 if use_visc else 4
    want = {"trL": (trL, (C, F, ngl)), "trR": (trR, (C, F, ngl)),
            "af": (af, (16, F, nq)), "tabs.ftab": (tabs.ftab, (15, F, nq)),
            "tabs.ntab": (tabs.ntab, (5, F, ngl)), "tabs.psiq": (tabs.psiq, (ngl, nq))}
    if use_visc:
        if ag is None or tabs.bgf is None:
            raise ValueError("the viscous face stage needs `ag` and `tabs.bgf`")
        want.update({"ag": (ag, (8, F, ngl)), "tabs.bgf": (tabs.bgf, (10, F, ngl))})
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != trL.dtype or t.device != trL.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, expected "
                             f"{trL.dtype} on {trL.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return F, ngl, nq


def btp_faces_plain(tabs: FaceTailTables, trL: Tensor, trR: Tensor, af: Tensor,
                    ag: Tensor | None, *, use_visc: bool):
    """The all-faces stage in plain torch ops (any device).

    trL/trR: (8|4, F, ngl) packed left/right traces ([qb 4 channels, graduv 4
    channels when viscous]); af: (16, F, nq) and ag: (8, F, ngl) (viscous
    only, else passed through untouched) are updated in place.
    Returns (S (3, F, ngl), Sv (2, F, ngl) | None, af, ag)."""
    _check_faces(tabs, trL, trR, af, ag, use_visc)
    psiq = tabs.psiq
    qblq = trL[:4] @ psiq                    # (4, F, nq)
    qbrq = trR[:4] @ psiq
    (nx, ny, jacf, cpL, cpR, cpub, omE, cmL, cmR, cmLR, Hedge,
     Qe_uu, Qe_uv, Qe_vv, dHe) = tabs.ftab

    # reference creat_btp_fluxes_qdf (src/mod_rhs_btp.F90:211-364)
    pU_L = nx * qblq[2] + ny * qblq[3]
    pU_R = -(nx * qbrq[2] + ny * qbrq[3])
    pbpert_edge = cpL * qblq[1] + cpR * qbrq[1] + cpub * (pU_L + pU_R)
    mue = pbpert_edge * omE
    mue2 = mue * (2.0 + mue)
    ope_edge = 1.0 + mue

    flux_edge_x = cmL * qblq[2] + cmR * qbrq[2] + cmLR * nx * (qblq[1] - qbrq[1])
    flux_edge_y = cmL * qblq[3] + cmR * qbrq[3] + cmLR * ny * (qblq[1] - qbrq[1])

    inv_l, inv_r = 1.0 / qblq[0], 1.0 / qbrq[0]
    ul, ur = qblq[2] * inv_l, qbrq[2] * inv_r
    vl, vr = qblq[3] * inv_l, qbrq[3] * inv_r

    quu = 0.5 * (ul * qblq[2] + ur * qbrq[2]) + ope_edge * Qe_uu
    quv = 0.5 * (vl * qblq[2] + vr * qbrq[2]) + ope_edge * Qe_uv
    qvu = 0.5 * (ul * qblq[3] + ur * qbrq[3]) + ope_edge * Qe_uv
    qvv = 0.5 * (vl * qblq[3] + vr * qbrq[3]) + ope_edge * Qe_vv
    dH_face = dHe + mue2 * (Hedge + dHe)

    dispu = 0.5 * cmLR * (qbrq[2] - qblq[2])
    dispv = 0.5 * cmLR * (qbrq[3] - qblq[3])
    flux_x = nx * quu + ny * quv - dispu
    flux_y = nx * qvu + ny * qvv - dispv
    flux = nx * flux_edge_x + ny * flux_edge_y

    S = (jacf * torch.stack([flux, nx * dH_face + flux_x,
                             ny * dH_face + flux_y])) @ psiq.T    # (3, F, ngl)

    # one-sided reference pb' from the nodal face tables (:257-258)
    pbl = tabs.ntab[0] @ psiq
    pbr = tabs.ntab[1] @ psiq
    muL = qblq[1] / pbl
    muR = qbrq[1] / pbr
    # in core/btp._FACE_ORDER
    af += torch.stack([dH_face, quu, quv, qvu, qvv, muL, muR,
                       muL * (2.0 + muL), muR * (2.0 + muR),
                       flux_edge_x, flux_edge_y, mue2, ul, ur, vl, vr])
    btp_faces_plain.calls += 1
    if not use_visc:
        return S, None, af, ag

    # nodal LDG viscosity face flux (create_rhs_laplacian_flux,
    # src/mod_laplacian_quad.F90:427-519): flip-flop central flux
    gfL, gfR = trL[4:8], trR[4:8]            # (4, F, ngl)
    bgf = tabs.bgf
    fl = bgf[4] * gfL + bgf[0:4]
    fr = bgf[9] * gfR + bgf[5:9]
    qmean = 0.5 * (fl + fr)
    nx_df, ny_df, jac_df = tabs.ntab[2], tabs.ntab[3], tabs.ntab[4]
    Sv = jac_df * torch.stack([
        (qmean[0] - fl[0] * nx_df) + (qmean[1] - fl[1] * ny_df),
        (qmean[2] - fl[2] * nx_df) + (qmean[3] - fl[3] * ny_df)])
    ag[:4] += gfL
    ag[4:] += gfR
    return S, Sv, af, ag


btp_faces_plain.calls = 0


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# the C signatures of `<name>_launch` and `<name>_describe` (its sizes) per kernel
_LAUNCH_ARGS = {"btp_faces": [_I] * 5 + [_P] * 10 + [_P],
                "btp_update": [_I] * 4 + [_P] * 16 + [_D] * 5 + [_P]}
_SIZE_ARGS = {"btp_faces": [_I, _I], "btp_update": [_I]}


def _library(name: str) -> ctypes.CDLL:
    """The built library of kernel `name` with its C signatures declared."""
    lib = load_library(name)
    if not getattr(lib, "_hnumo_declared", False):
        sizes = _SIZE_ARGS[name]
        getattr(lib, f"{name}_launch").argtypes = _LAUNCH_ARGS[name]
        getattr(lib, f"{name}_launch").restype = ctypes.c_int
        getattr(lib, f"{name}_describe").argtypes = [_I, *sizes, ctypes.POINTER(_I),
                                                     ctypes.POINTER(ctypes.c_longlong),
                                                     ctypes.POINTER(_I)]
        getattr(lib, f"{name}_describe").restype = ctypes.c_int
        getattr(lib, f"{name}_smem_bytes").argtypes = [_I, *sizes]
        getattr(lib, f"{name}_smem_bytes").restype = ctypes.c_longlong
        getattr(lib, f"{name}_smem_limit").argtypes = []
        getattr(lib, f"{name}_smem_limit").restype = ctypes.c_longlong
        getattr(lib, f"{name}_error_string").argtypes = [_I]
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        lib._hnumo_declared = True
    return lib


def _check_smem(lib, name: str, unit: str, dtype: torch.dtype, *sizes: int) -> None:
    """Raise unless one `unit` (face, element) fits the two stages of one
    block's shared memory on the card: the kernel never falls back."""
    need = getattr(lib, f"{name}_smem_bytes")(int(dtype == torch.float64), *sizes)
    limit = getattr(lib, f"{name}_smem_limit")()
    if need > limit:
        raise ValueError(
            f"{name}_cuda stages the inputs of one {unit} twice in shared memory: "
            f"sizes {sizes}, {dtype} need {need} bytes per block, the card allows {limit}")


def _require_cuda(name: str, t: Tensor) -> int:
    """Raise unless `t` is a float32/float64 CUDA tensor; returns is_double."""
    if t.device.type != "cuda":
        raise ValueError(
            f"{name}_cuda takes CUDA tensors, got {t.device}; use {name}_plain "
            "(tail_impl='plain') on other devices")
    if t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}_cuda takes float32/float64, got {t.dtype}")
    return int(t.dtype == torch.float64)


def _ptr(t: Tensor | None):
    return None if t is None else t.data_ptr()


def btp_faces_cuda(tabs: FaceTailTables, trL: Tensor, trR: Tensor, af: Tensor,
                   ag: Tensor | None, *, use_visc: bool):
    """The all-faces stage as one CUDA kernel launch (csrc/btp_faces.cu).

    Same operands and contract as `btp_faces_plain`; float32 or float64 CUDA
    tensors only. Launches on the current stream and does not synchronise.
    Raises on operands the kernel does not take and on a refused launch;
    builds the kernel at the first call. `btp_faces_cuda.launches` counts the
    launches made."""
    F, ngl, nq = _check_faces(tabs, trL, trR, af, ag, use_visc)
    is_double = _require_cuda("btp_faces", trL)
    lib = _library("btp_faces")
    _check_smem(lib, "btp_faces", "face", trL.dtype, ngl, nq)
    opts = dict(dtype=trL.dtype, device=trL.device)
    S = torch.empty((3, F, ngl), **opts)
    Sv = torch.empty((2, F, ngl), **opts) if use_visc else None
    with torch.cuda.device(trL.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.btp_faces_launch(
            is_double, F, ngl, nq, int(use_visc),
            trL.data_ptr(), trR.data_ptr(), tabs.ftab.data_ptr(),
            tabs.ntab.data_ptr(), _ptr(tabs.bgf if use_visc else None),
            tabs.psiq.data_ptr(), af.data_ptr(), _ptr(ag if use_visc else None),
            S.data_ptr(), _ptr(Sv), stream)
    if err != 0:
        raise RuntimeError(
            f"btp_faces kernel launch failed: CUDA error {err} "
            f"({lib.btp_faces_error_string(err).decode()})")
    btp_faces_cuda.launches += 1
    return S, Sv, af, ag


btp_faces_cuda.launches = 0


def btp_faces_layout(dtype: torch.dtype, ngl: int, nq: int) -> dict:
    """`launch_layout` of the face kernel: faces per tile, shared memory per
    block, resident blocks per SM (builds it at the first call)."""
    return launch_layout(_library("btp_faces"), "btp_faces", dtype, ngl, nq, unit="faces")


# ---------------------------------------------------------------------------
# kernel U: edge placement + viscosity volume term + SSPRK update
# ---------------------------------------------------------------------------


class UpdateOps(NamedTuple):
    """Static operators of the update stage (inverse mass folded in).

    The matrices serve the plain version, the 1-D tables the kernel; both
    describe the same operators."""

    Escat: Tensor        # (4*ngl, npts) edge placement [W,E,S,N] * massinv
    Evisc: Tensor        # (4*ngl, npts) edge placement * visc * massinv
    Vx: Tensor           # (npts, npts) -visc * massinv * nodal d/dx scatter
    Vy: Tensor
    pbprime_df: Tensor   # (E, npts)
    ref: Tensor          # (3, E, npts) massinv * btp_rhs_ref
    dpsi: Tensor         # (ngl, ngl) 1-D derivative at the nodes
    wn2: Tensor          # (2, npts): w_df*ksi_x, w_df*eta_y (nodal quadrature)
    minv: Tensor         # (npts,) inverse lumped mass of the uniform brick
    visc: float


def build_update_ops(static, P, g, cell=None) -> UpdateOps:
    """Fold inverse mass, viscosity constant and edge placement into static
    operators (uniform affine geometry: massinv identical in every element).
    State-independent: built once per model. `cell`: the DeviceGeom whose
    first element gives the shared metric (ops/btp_volume_uni.
    operators_uniform; default `g`)."""
    cell = g if cell is None else cell
    ngl = g.wjac_df.shape[-1]
    npts = ngl * ngl
    opts = dict(dtype=g.massinv.dtype, device=g.massinv.device)
    minv = cell.massinv[0, 0].reshape(-1).contiguous()     # (npts,)

    E4 = torch.zeros((4 * ngl, npts), **opts)
    j = torch.arange(ngl)
    E4[j, j * ngl] = 1.0                            # west edge slot j -> (j, 0)
    E4[ngl + j, j * ngl + ngl - 1] = 1.0            # east
    E4[2 * ngl + j, j] = 1.0                        # south -> (0, j)
    E4[3 * ngl + j, (ngl - 1) * ngl + j] = 1.0      # north
    Escat = E4 * minv[None, :]
    Evisc = E4 * (static.visc_mlswe * minv)[None, :]

    # nodal weak d/dx, d/dy scatter (ops/dg.scatter_volume_nodal, uniform):
    # out[(j,i)] = sum_I wjac_df[(j,I)] * kx * F[(j,I)] * dpsi[i,I]   (x)
    #            + sum_J wjac_df[(J,i)] * ey * F[(J,i)] * dpsi[j,J]   (y)
    wj = cell.wjac_df[0, 0]
    kx, ey = cell.ksi_x[0, 0, 0, 0], cell.eta_y[0, 0, 0, 0]
    eye = torch.eye(ngl, **opts)
    Vx = torch.einsum("JI,Jj,iI->JIji", wj * kx, eye, g.dpsi).reshape(npts, npts)
    Vy = torch.einsum("JI,Ii,jJ->JIji", wj * ey, eye, g.dpsi).reshape(npts, npts)
    scale = -static.visc_mlswe * minv[None, :]
    return UpdateOps(
        Escat=Escat.contiguous(), Evisc=Evisc.contiguous(),
        Vx=(Vx * scale).contiguous(), Vy=(Vy * scale).contiguous(),
        pbprime_df=eflat(P.pbprime_df.contiguous()),
        ref=(eflat(P.btp_rhs_ref.contiguous()) * minv).contiguous(),
        dpsi=g.dpsi.contiguous(),
        wn2=torch.stack([(wj * kx).reshape(-1), (wj * ey).reshape(-1)]).contiguous(),
        minv=minv, visc=float(static.visc_mlswe))


def _check_update(ops: UpdateOps, w, rhs, edges, vedges, qb0, qb1, qb2, gv,
                  pbpv, bdg, mask, use_visc):
    if len(w) != 4:
        raise ValueError(f"w must hold (a0, a1, a2, dt*beta), got {len(w)} values")
    if rhs.ndim != 3:
        raise ValueError("rhs must be (3, E, npts)")
    _, E, npts = rhs.shape
    ngl = ops.dpsi.shape[0]
    if ngl * ngl != npts:
        raise ValueError(f"operators are for npts={ngl * ngl}, rhs has npts={npts}")
    want = {"rhs": (rhs, (3, E, npts)), "edges": (edges, (3, E, 4 * ngl)),
            "qb0": (qb0, (4, E, npts)), "qb1": (qb1, (4, E, npts)),
            "qb2": (qb2, (4, E, npts)), "mask": (mask, (2, E, npts)),
            "ops.ref": (ops.ref, (3, E, npts)),
            "ops.pbprime_df": (ops.pbprime_df, (E, npts)),
            "ops.Escat": (ops.Escat, (4 * ngl, npts)),
            "ops.minv": (ops.minv, (npts,))}
    if use_visc:
        for name, t in (("vedges", vedges), ("gv", gv), ("pbpv", pbpv), ("bdg", bdg)):
            if t is None:
                raise ValueError(f"the viscous update stage needs `{name}`")
        want.update({"vedges": (vedges, (2, E, 4 * ngl)), "gv": (gv, (4, E, npts)),
                     "pbpv": (pbpv, (1, E, npts)), "bdg": (bdg, (4, E, npts)),
                     "ops.Evisc": (ops.Evisc, (4 * ngl, npts)),
                     "ops.Vx": (ops.Vx, (npts, npts)), "ops.Vy": (ops.Vy, (npts, npts)),
                     "ops.dpsi": (ops.dpsi, (ngl, ngl)), "ops.wn2": (ops.wn2, (2, npts))})
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != rhs.dtype or t.device != rhs.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, expected "
                             f"{rhs.dtype} on {rhs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return E, ngl


def btp_update_plain(ops: UpdateOps, w, rhs: Tensor, edges: Tensor,
                     vedges: Tensor | None, qb0: Tensor, qb1: Tensor, qb2: Tensor,
                     gv: Tensor | None, pbpv: Tensor | None, bdg: Tensor | None,
                     mask: Tensor, *, use_visc: bool) -> Tensor:
    """The SSPRK stage update in plain torch ops (any device).

    w: four host floats (a0, a1, a2, dt*beta); rhs: (3, E, npts) pre-edge,
    massinv-folded volume RHS; edges: (3, E, 4*ngl) signed face values
    [W, E, S, N]; vedges: (2, E, 4*ngl); qb0/qb1/qb2: (4, E, npts) SSPRK
    registers (they may alias each other); gv: (4, E, npts); pbpv:
    (1, E, npts); bdg: (4, E, npts); mask: (2, E, npts) wall projection.
    Returns a new qb (4, E, npts); no operand is mutated."""
    _check_update(ops, w, rhs, edges, vedges, qb0, qb1, qb2, gv, pbpv, bdg,
                  mask, use_visc)
    a0, a1, a2, dtt = (float(v) for v in w)
    r = rhs + edges @ ops.Escat + ops.ref
    if use_visc:
        qq = pbpv * gv + bdg                     # (4, E, npts)
        lap = torch.stack([qq[0] @ ops.Vx + qq[1] @ ops.Vy,
                           qq[2] @ ops.Vx + qq[3] @ ops.Vy]) + vedges @ ops.Evisc
        r = torch.cat([r[:1], r[1:] + lap])
    new = a0 * qb0[1:4] + a1 * qb1[1:4] + a2 * qb2[1:4] + dtt * r
    btp_update_plain.calls += 1
    return torch.stack([new[0] + ops.pbprime_df, new[0],
                        new[1] * mask[0], new[2] * mask[1]])


btp_update_plain.calls = 0


def btp_update_cuda(ops: UpdateOps, w, rhs: Tensor, edges: Tensor,
                    vedges: Tensor | None, qb0: Tensor, qb1: Tensor, qb2: Tensor,
                    gv: Tensor | None, pbpv: Tensor | None, bdg: Tensor | None,
                    mask: Tensor, *, use_visc: bool) -> Tensor:
    """The SSPRK stage update as one CUDA kernel launch (csrc/btp_update.cu).

    Same operands and contract as `btp_update_plain`; float32 or float64
    CUDA tensors only. The four weights cross as host floats: no device read.
    Launches on the current stream and does not synchronise. Raises on
    operands the kernel does not take and on a refused launch; builds the
    kernel at the first call. `btp_update_cuda.launches` counts the launches
    made."""
    E, ngl = _check_update(ops, w, rhs, edges, vedges, qb0, qb1, qb2, gv, pbpv,
                           bdg, mask, use_visc)
    is_double = _require_cuda("btp_update", rhs)
    lib = _library("btp_update")
    _check_smem(lib, "btp_update", "element", rhs.dtype, ngl)
    out = torch.empty((4, E, ngl * ngl), dtype=rhs.dtype, device=rhs.device)
    visc_only = (lambda t: _ptr(t)) if use_visc else (lambda t: None)
    with torch.cuda.device(rhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.btp_update_launch(
            is_double, E, ngl, int(use_visc),
            rhs.data_ptr(), edges.data_ptr(), qb0.data_ptr(), qb1.data_ptr(),
            qb2.data_ptr(), ops.ref.data_ptr(), ops.pbprime_df.data_ptr(),
            mask.data_ptr(), ops.minv.data_ptr(), visc_only(vedges), visc_only(gv),
            visc_only(pbpv), visc_only(bdg), visc_only(ops.dpsi),
            visc_only(ops.wn2), out.data_ptr(),
            *(float(v) for v in w), ops.visc, stream)
    if err != 0:
        raise RuntimeError(
            f"btp_update kernel launch failed: CUDA error {err} "
            f"({lib.btp_update_error_string(err).decode()})")
    btp_update_cuda.launches += 1
    return out


btp_update_cuda.launches = 0


def btp_update_layout(dtype: torch.dtype, ngl: int) -> dict:
    """`launch_layout` of the update kernel: elements per tile, shared memory
    per block, resident blocks per SM (builds it at the first call)."""
    return launch_layout(_library("btp_update"), "btp_update", dtype, ngl)
