"""Whole-solve barotropic megakernel: one kernel launch per barotropic solve.

Counterpart of hnumo_tpu/ops/pallas_mega.py (`_mega_kernel` /
`barotropic_solve_mega`). ONE launch runs the entire barotropic sub-cycling
— all N_btp x kstages SSPRK stages (reference ti_barotropic_ssprk_mlswe,
src/mod_rk_mlswe.F90:19-151) — with the volume RHS, the face fluxes of all
four sides of every element, the nodal-family LDG viscosity, the SSPRK
combine and all 23 running averages inside the kernel. The per-stage path
(core/btp.barotropic_solve) dispatches hundreds of small launches per stage
from the host; this path takes the stage loop off the host.

Layout (no padding anywhere): element-major flat fields, nodal
(C, E, npts) and quad (C, E, nqq) with npts = ngl*ngl, nqq = nq*nq, element
e = iy*nex + ix; per-element side tables (C, E, 4, m) with the sides in the
order east, west, north, south. Each element computes its own four sides;
an interior face is therefore computed by both of its elements from the
same left/right values in the same order. Neighbours are found by index
(`MegaStatic.nbr`, -1 on a domain boundary, where the wall mirror of
core/faces._mirror_signs takes the neighbour's place). The tensor-product
operators are applied sum-factorised from the 1-D tables (psiq, dpsiq,
dpsi), not as Kronecker matrices.

Two implementations of one function with the contract of
core/btp.barotropic_solve — (qb at t+dt, BtpAverages), `qb_df` not mutated:
  barotropic_solve_mega_cuda   the hand-written CUDA kernel
                               (csrc/btp_mega.cu), f32 and f64, CUDA tensors
                               only; built at first launch. Two routes of one
                               source, chosen from the launch's layout
                               (`btp_mega_layout`): "resident" (one block per
                               element, tables and running averages in shared
                               memory for the whole solve) when the grid fits
                               the card at once, else "streamed".
  barotropic_solve_mega_plain  the same arithmetic stage by stage in torch
                               ops, any device; used by the CPU tests, by
                               `device="cpu"` models and as the kernel's
                               yardstick of correctness on the card
Neither falls back to the other. Both build their per-solve operands with
`solve_operands` and turn the five accumulators into the structured
BtpAverages with `averages_from_accumulators`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import Tensor

from ..core.faces import _mirror_signs, face_n2q, wall_projection_masks
from ._build import load_library
from .btp_volume import eflat
from .dg import interp_n2q

# side order of every (.., E, 4, m) table
EAST, WEST, NORTH, SOUTH = range(4)
_OPPOSITE = (WEST, EAST, SOUTH, NORTH)
MAX_KSTAGES = 5     # size of the kernel's by-value SSPRK tables

_FTAB_FIELDS = ("nx", "ny", "jac", "coeff_pbpert_L", "coeff_pbpert_R",
                "coeff_pbub_LR", "coeff_mass_pbub_L", "coeff_mass_pbub_R",
                "coeff_mass_pbpert_LR", "one_over_pbprime_edge", "Hedge_ref")


class MegaStatic(NamedTuple):
    """State-independent megakernel operands (built once per model)."""

    psiq: Tensor        # (ngl, nq) 1-D node->quad interpolation
    dpsiq: Tensor       # (ngl, nq) 1-D derivative at quad points
    dpsi: Tensor        # (ngl, ngl) 1-D derivative at the nodes
    wq3: Tensor         # (3, nqq): w*ksi_x, w*eta_y, w (uniform metrics folded)
    wn2: Tensor         # (2, npts): w_df*ksi_x, w_df*eta_y (nodal quadrature)
    kx_df: float        # nodal d(ksi)/dx, d(eta)/dy of the uniform brick
    ey_df: float
    ptab: Tensor        # (8, E, nqq): cor, tau_u, tau_v, gzx, gzy, 1/pbprime,
    #                     dpp_ref_q[-1], H_bcl_ref
    btp_ref3: Tensor    # (3, E, npts) static delta-form RHS vector
    massinv: Tensor     # (E, npts)
    pbprime_df: Tensor  # (E, npts)
    opbp_df: Tensor     # (E, npts) 1/pbprime_df
    masku: Tensor       # (E, npts) wall projection masks
    maskv: Tensor
    ftab: Tensor        # (13, E, 4, nq): nx, ny, jac, cpL, cpR, cpub, cmL, cmR,
    #                     cmLR, 1/pbprime_edge, Hedge_ref, pb'_L, pb'_R (quad)
    ntab: Tensor        # (3, E, 4, ngl): nx_df, ny_df, jac_df
    nbr: Tensor         # (E, 4) int32 neighbour element per side, -1 = wall
    mir_q: Tensor       # (4 sides, 4 channels) wall mirror signs of qb
    mir_g: Tensor       # (4 sides, 4 channels) wall mirror signs of grad(u,v)
    a_tab: tuple        # kstages x 3 SSPRK weights over (qb0, qb1, qb2)
    b_tab: tuple        # kstages RHS weights
    ney: int
    nex: int


class SolveOperands(NamedTuple):
    """Per-solve operands, constant over the N_btp x kstages stages."""

    qb: Tensor      # (4, E, npts) state at t (a view of the caller's qb_df)
    qplq: Tensor    # (3, E, nqq) bottom-layer primes at quad points
    coup: Tensor    # (4, E, nqq) Q_uu, Q_uv, Q_vv, dH_bcl
    qe: Tensor      # (4, E, 4, nq) their edge values per side
    bgf: Tensor | None    # (10, E, 4, ngl) btp_graduv_dpp_face L(5) then R(5)
    pvisc: Tensor | None  # (E, npts) pbprime_visc
    bdg: Tensor | None    # (4, E, npts) btp_dpp_graduv


def side_views(pair_x: Tensor, pair_y: Tensor, ney: int, nex: int) -> Tensor:
    """Per-side element view (..., E, 4, m) of the structured per-direction
    face tables (..., ney, nex+1, m) and (..., ney+1, nex, m).

    east(i,j) = x-face (i, j+1); west = x-face (i, j); north = y-face
    (i+1, j); south = y-face (i, j)."""
    lead, m = pair_x.shape[:-3], pair_x.shape[-1]
    if (tuple(pair_x.shape[-3:-1]) != (ney, nex + 1)
            or tuple(pair_y.shape[-3:-1]) != (ney + 1, nex)):
        raise ValueError(
            f"face tables of shape {tuple(pair_x.shape)} / {tuple(pair_y.shape)} "
            f"do not belong to a {ney}x{nex} element grid")
    sides = (pair_x[..., :, 1:, :], pair_x[..., :, :-1, :],
             pair_y[..., 1:, :, :], pair_y[..., :-1, :, :])
    return torch.stack([s.reshape(lead + (ney * nex, m)) for s in sides], dim=-2)


def build_mega_static(static, g, P, bc) -> MegaStatic:
    """Build the static operand bundle (eager, at model build)."""
    dtype, device = g.psiq.dtype, g.psiq.device
    ngl, nq = g.psiq.shape
    ney, nex = g.wjac.shape[0], g.wjac.shape[1]
    E = ney * nex
    if not static.mega_envelope:
        raise ValueError("build_mega_static: the configuration is outside the "
                         "megakernel's envelope (StaticConfig.mega_envelope)")
    if static.kstages > MAX_KSTAGES:
        raise ValueError(f"the megakernel takes kstages <= {MAX_KSTAGES}, "
                         f"got {static.kstages}")

    def ef(a):
        return eflat(a.contiguous())

    # uniform brick: one element's weights and metric constants serve all
    kx, ey = g.ksiq_x[0, 0, 0, 0], g.etaq_y[0, 0, 0, 0]
    wq = g.wjac[0, 0].reshape(-1)
    wn = g.wjac_df[0, 0].reshape(-1)
    kx_df, ey_df = g.ksi_x[0, 0, 0, 0], g.eta_y[0, 0, 0, 0]

    ptab = torch.stack([
        ef(P.coriolis_quad), ef(P.tau_wind[0]), ef(P.tau_wind[1]),
        ef(P.grad_zbot_quad[0]), ef(P.grad_zbot_quad[1]),
        ef(P.one_over_pbprime), ef(P.dpp_ref_q[-1]), ef(P.H_bcl_ref)])
    mu_w, mv_w = wall_projection_masks((ney, nex, ngl, ngl), bc, dtype, device)

    fx, fy = P.faces.x, P.faces.y
    ftab = torch.stack(
        [side_views(getattr(fx, nm), getattr(fy, nm), ney, nex) for nm in _FTAB_FIELDS]
        + [side_views(face_n2q(g.psiq, fx.pbprime_df_face_L),
                      face_n2q(g.psiq, fy.pbprime_df_face_L), ney, nex),
           side_views(face_n2q(g.psiq, fx.pbprime_df_face_R),
                      face_n2q(g.psiq, fy.pbprime_df_face_R), ney, nex)])
    ntab = torch.stack([side_views(getattr(fx, nm), getattr(fy, nm), ney, nex)
                        for nm in ("nx_df", "ny_df", "jac_df")])

    e = torch.arange(E, dtype=torch.int32).reshape(ney, nex)
    nbr = torch.full((ney, nex, 4), -1, dtype=torch.int32)
    nbr[:, :-1, EAST] = e[:, 1:]
    nbr[:, 1:, WEST] = e[:, :-1]
    nbr[:-1, :, NORTH] = e[1:, :]
    nbr[1:, :, SOUTH] = e[:-1, :]

    walls = ((bc.east, "x"), (bc.west, "x"), (bc.north, "y"), (bc.south, "y"))
    mir_q = [_mirror_signs(4, code, d, ((2, 3),)) for code, d in walls]
    mir_g = [_mirror_signs(4, code, d, ((0, 1), (2, 3))) for code, d in walls]

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    a_tab = tuple(tuple(float(v) for v in row) for row in P.ssprk_a.tolist())
    b_tab = tuple(float(v) for v in P.ssprk_beta.tolist())
    return MegaStatic(
        psiq=g.psiq.contiguous(), dpsiq=g.dpsiq.contiguous(),
        dpsi=g.dpsi.contiguous(),
        wq3=torch.stack([wq * kx, wq * ey, wq]).contiguous(),
        wn2=torch.stack([wn * kx_df, wn * ey_df]).contiguous(),
        kx_df=float(kx_df), ey_df=float(ey_df),
        ptab=ptab, btp_ref3=ef(P.btp_rhs_ref), massinv=ef(g.massinv),
        pbprime_df=ef(P.pbprime_df), opbp_df=ef(P.one_over_pbprime_df),
        masku=ef(mu_w), maskv=ef(mv_w), ftab=ftab.contiguous(),
        ntab=ntab.contiguous(), nbr=nbr.reshape(E, 4).to(device).contiguous(),
        mir_q=dev(mir_q), mir_g=dev(mir_g), a_tab=a_tab, b_tab=b_tab,
        ney=ney, nex=nex)


def solve_operands(static, g, coup, qb_df: Tensor, qprime_df: Tensor,
                   mops: MegaStatic) -> SolveOperands:
    """The per-solve operands in the megakernel's layout."""
    ney, nex = mops.ney, mops.nex
    qplq = eflat(interp_n2q(g, qprime_df[:, -1]).contiguous())
    coup_v = torch.stack([eflat(c.contiguous()) for c in
                          (coup.Q_uu_dp, coup.Q_uv_dp, coup.Q_vv_dp, coup.dH_bcl)])
    qe = torch.stack([side_views(p.x, p.y, ney, nex) for p in
                      (coup.Q_uu_dp_edge, coup.Q_uv_dp_edge, coup.Q_vv_dp_edge,
                       coup.dH_bcl_edge)]).contiguous()
    bgf = pvisc = bdg = None
    if static.use_visc:
        # (5, 2, F.., ngl) -> (5, 2, E, 4, ngl) -> (10, E, 4, ngl): L(5), R(5)
        b = side_views(coup.btp_graduv_dpp_face.x, coup.btp_graduv_dpp_face.y,
                       ney, nex)
        bgf = b.transpose(0, 1).reshape((10,) + b.shape[2:]).contiguous()
        pvisc = eflat(coup.pbprime_visc.contiguous())
        bdg = eflat(coup.btp_dpp_graduv.contiguous())
    return SolveOperands(qb=eflat(qb_df.contiguous()), qplq=qplq, coup=coup_v,
                         qe=qe, bgf=bgf, pvisc=pvisc, bdg=bdg)


def new_accumulators(E: int, ngl: int, nq: int, **opts):
    """Zeroed (accv, accn, agr, aff, agt) for one solve."""
    return (torch.zeros((12, E, nq * nq), **opts),      # volume averages
            torch.zeros((3, E, ngl * ngl), **opts),     # nodal averages
            torch.zeros((4, E, ngl * ngl), **opts),     # grad(u,v) nodal
            torch.zeros((16, E, 4, nq), **opts),        # face averages per side
            torch.zeros((8, E, 4, ngl), **opts))        # grad traces L(4), R(4)


def averages_from_accumulators(static, mops: MegaStatic, accv, accn, agr, aff, agt):
    """Normalise the five accumulators by 1/(N_btp*kstages) and rebuild the
    structured BtpAverages.

    Interior faces were accumulated identically by both of their elements:
    the x-face table is the east blocks plus the west block of the first
    column, the y-face table the north blocks plus the south block of the
    first row (for the right-hand gradient traces: the west/south blocks
    plus the east/north block of the last column/row)."""
    from ..core.btp import _averages_view

    ney, nex = mops.ney, mops.nex
    ngl, nq = mops.psiq.shape
    n_inv = 1.0 / (static.n_btp * static.kstages)
    vol = (accv * n_inv).view(12, ney, nex, nq, nq)
    nod = (accn * n_inv).view(3, ney, nex, ngl, ngl)
    agrad = (agr * n_inv).view(4, ney, nex, ngl, ngl)
    af = (aff * n_inv).view(16, ney, nex, 4, nq)
    afx = torch.cat([af[:, :, :1, WEST], af[:, :, :, EAST]], dim=2)
    afy = torch.cat([af[:, :1, :, SOUTH], af[:, :, :, NORTH]], dim=1)
    ag = (agt * n_inv).view(2, 4, ney, nex, 4, ngl)
    gL, gR = ag[0], ag[1]
    gxl = torch.cat([gL[:, :, :1, WEST], gL[:, :, :, EAST]], dim=2)
    gxr = torch.cat([gR[:, :, :, WEST], gR[:, :, -1:, EAST]], dim=2)
    gyl = torch.cat([gL[:, :1, :, SOUTH], gL[:, :, :, NORTH]], dim=1)
    gyr = torch.cat([gR[:, :, :, SOUTH], gR[:, -1:, :, NORTH]], dim=1)
    return _averages_view(static, vol, nod, afx, afy, torch.stack([gxl, gxr]),
                          torch.stack([gyl, gyr]), agrad)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _edge_traces(q: Tensor, ngl: int) -> Tensor:
    """(C, E, ngl*ngl) -> (C, E, 4, ngl): the element's own edge nodes."""
    q4 = q.view(q.shape[0], q.shape[1], ngl, ngl)
    return torch.stack([q4[..., :, -1], q4[..., :, 0], q4[..., -1, :], q4[..., 0, :]],
                       dim=2)


def _add_edges(field: Tensor, edges: Tensor, ngl: int) -> Tensor:
    """field (C, E, npts) + per-side edge values (C, E, 4, ngl) placed on the
    element's edge nodes (corner nodes receive two sides). New tensor."""
    out = field.clone().view(field.shape[0], field.shape[1], ngl, ngl)
    out[..., :, -1] += edges[:, :, EAST]
    out[..., :, 0] += edges[:, :, WEST]
    out[..., -1, :] += edges[:, :, NORTH]
    out[..., 0, :] += edges[:, :, SOUTH]
    return out.view(field.shape)


def _mega_stages_plain(static, mops: MegaStatic, op: SolveOperands, acc):
    """All N_btp*kstages stages on flat operands; returns qb (4, E, npts) at
    t+dt and updates the accumulators in place."""
    accv, accn, agr, aff, agt = acc
    ngl, nq = mops.psiq.shape
    E = op.qb.shape[1]
    psiq, dpsiq, dpsi = mops.psiq, mops.dpsiq, mops.dpsi
    grav, cd = static.gravity, static.cd_mlswe
    kstages = static.kstages

    bnd = (mops.nbr < 0)[None, :, :, None]                    # (1, E, 4, 1)
    nbr = mops.nbr.clamp(min=0).long()                        # (E, 4)
    opp = torch.tensor(_OPPOSITE, device=nbr.device)
    first = torch.tensor([True, False, True, False],
                         device=nbr.device)[None, None, :, None]
    # sign with which a side's integrated flux lands on the element's edge
    # nodes: the element is the left side of its east/north faces and of any
    # boundary face (-), the right side of interior west/south faces (+)
    edge_sign = torch.where(first | bnd, -1.0, 1.0).to(op.qb.dtype)
    mir_q = mops.mir_q.T[:, None, :, None]                    # (4, 1, 4, 1)
    mir_g = mops.mir_g.T[:, None, :, None]

    def left_right(tr, mir):
        """Left/right values at each element's four sides from all elements'
        own traces (C, E, 4, m): neighbour by index, wall mirror on the
        boundary (where the element is the left side)."""
        nb = tr[:, nbr, opp]
        left = torch.where(first | bnd, tr, nb)
        right = torch.where(bnd, mir * tr, torch.where(first, nb, tr))
        return left, right

    def n2q(u):
        u4 = u.view(u.shape[0], E, ngl, ngl)
        return torch.einsum("ceji,jJ,iI->ceJI", u4, psiq, psiq).reshape(u.shape[0], E, nq * nq)

    def scatter(A, B, S):
        """Weak-form volume integral of 3 channels: A, B are the weighted
        x/y flux rows, S the weighted sources of channels 1 and 2."""
        A4, B4, S4 = (x.view(x.shape[0], E, nq, nq) for x in (A, B, S))
        r = (torch.einsum("ceJI,jJ,iI->ceji", A4, psiq, dpsiq)
             + torch.einsum("ceJI,jJ,iI->ceji", B4, dpsiq, psiq))
        r[1:] += torch.einsum("ceJI,jJ,iI->ceji", S4, psiq, psiq)
        return r.reshape(3, E, ngl * ngl)

    cor, tau_u, tau_v, gzx, gzy, opbp, ppref, Href = mops.ptab
    (nx, ny, jacf, cpL, cpR, cpub, cmL, cmR, cmLR, opbe, Hedge, pbl, pbr) = mops.ftab
    nxdf, nydf, jacdf = mops.ntab
    ppq, up, vp = op.qplq
    Quu, Quv, Qvv, dHbcl = op.coup
    Qe_uu, Qe_uv, Qe_vv, dHe = op.qe
    wkx, wey, wq = mops.wq3

    qb0 = qb1 = op.qb
    qb2 = torch.zeros_like(op.qb)
    for st in range(static.n_btp * kstages):
        ik = st % kstages
        if ik == 0:
            qb0 = qb1

        # ---- nodal averages from the PRE-stage state ----
        inv_pb = 1.0 / qb1[0]
        t_df = qb1[1] * mops.opbp_df
        u_df = qb1[2] * inv_pb
        v_df = qb1[3] * inv_pb
        accn += torch.stack([t_df * (2.0 + t_df), u_df, v_df])

        # ---- volume RHS (reference create_rhs_btp_volume_qdf) ----
        dp, dpp, udp, vdp = n2q(qb1)
        inv_dp = 1.0 / dp
        ub = udp * inv_dp
        vb = vdp * inv_dp
        if static.botfr == 1:
            spd = (cd / grav) * (ppref + ppq)
            tb_u = spd * (up + ub)
            tb_v = spd * (vp + vb)
        elif static.botfr == 2:
            ubot, vbot = up + ub, vp + vb
            spd = (cd / static.alpha_bot) * torch.sqrt(ubot * ubot + vbot * vbot)
            tb_u = spd * ubot
            tb_v = spd * vbot
        else:
            tb_u = torch.zeros_like(dp)
            tb_v = torch.zeros_like(dp)
        sc_x = cor * vdp + grav * (tau_u - tb_u) - grav * dpp * gzx
        sc_y = -cor * udp + grav * (tau_v - tb_v) - grav * dpp * gzy
        mu = dpp * opbp
        mu2 = mu * (2.0 + mu)
        ope = 1.0 + mu
        dHq = dHbcl + mu2 * (Href + dHbcl)
        qu_t = ub * udp + ope * Quu
        quv = ub * vdp + ope * Quv
        qv_t = vb * vdp + ope * Qvv
        accv += torch.stack([dHq, qu_t, qv_t, quv, mu, mu2, ub, vb, udp, vdp,
                             tb_u, tb_v])
        rhs = scatter(wkx * torch.stack([udp, dHq + qu_t, quv]),
                      wey * torch.stack([vdp, quv, dHq + qv_t]),
                      wq * torch.stack([sc_x, sc_y]))

        # ---- face flux at the four sides of every element (reference
        #      creat_btp_fluxes_qdf, src/mod_rhs_btp.F90:211-364) ----
        trL, trR = left_right(_edge_traces(qb1, ngl), mir_q)
        l0, l1, l2, l3 = torch.einsum("cesn,nq->cesq", trL, psiq)
        r0, r1, r2, r3 = torch.einsum("cesn,nq->cesq", trR, psiq)
        pU_L = nx * l2 + ny * l3
        pU_R = -(nx * r2 + ny * r3)
        mue = (cpL * l1 + cpR * r1 + cpub * (pU_L + pU_R)) * opbe
        mue2 = mue * (2.0 + mue)
        ope_e = 1.0 + mue
        flux_ex = cmL * l2 + cmR * r2 + cmLR * nx * (l1 - r1)
        flux_ey = cmL * l3 + cmR * r3 + cmLR * ny * (l1 - r1)
        ul_f, ur_f = l2 / l0, r2 / r0
        vl_f, vr_f = l3 / l0, r3 / r0
        quu_f = 0.5 * (ul_f * l2 + ur_f * r2) + ope_e * Qe_uu
        quv_f = 0.5 * (vl_f * l2 + vr_f * r2) + ope_e * Qe_uv
        qvu_f = 0.5 * (ul_f * l3 + ur_f * r3) + ope_e * Qe_uv
        qvv_f = 0.5 * (vl_f * l3 + vr_f * r3) + ope_e * Qe_vv
        dH_f = dHe + mue2 * (Hedge + dHe)
        fl_x = nx * quu_f + ny * quv_f - 0.5 * cmLR * (r2 - l2)
        fl_y = nx * qvu_f + ny * qvv_f - 0.5 * cmLR * (r3 - l3)
        fl_m = nx * flux_ex + ny * flux_ey
        muL_f = l1 / pbl
        muR_f = r1 / pbr
        aff += torch.stack([dH_f, quu_f, quv_f, qvu_f, qvv_f, muL_f, muR_f,
                            muL_f * (2.0 + muL_f), muR_f * (2.0 + muR_f),
                            flux_ex, flux_ey, mue2, ul_f, ur_f, vl_f, vr_f])
        Sq = jacf * torch.stack([fl_m, nx * dH_f + fl_x, ny * dH_f + fl_y])
        rhs = _add_edges(rhs, edge_sign * torch.einsum("cesq,nq->cesn", Sq, psiq), ngl)

        # ---- nodal-family LDG viscosity (reference
        #      src/mod_laplacian_quad.F90:357-519) ----
        if static.use_visc:
            uv4 = torch.stack([u_df, v_df]).view(2, E, ngl, ngl)
            gx = mops.kx_df * torch.einsum("ceji,iI->cejI", uv4, dpsi)
            gy = mops.ey_df * torch.einsum("ceji,jJ->ceJi", uv4, dpsi)
            graduv = torch.stack([gx[0], gy[0], gx[1], gy[1]]).reshape(4, E, ngl * ngl)
            agr += graduv
            gL, gR = left_right(_edge_traces(graduv, ngl), mir_g)
            agt[:4] += gL
            agt[4:] += gR
            fl_v = op.bgf[4] * gL + op.bgf[:4]
            fr_v = op.bgf[9] * gR + op.bgf[5:9]
            qmean = 0.5 * (fl_v + fr_v)
            flux_qu = (qmean[0] - fl_v[0] * nxdf) + (qmean[1] - fl_v[1] * nydf)
            flux_qv = (qmean[2] - fl_v[2] * nxdf) + (qmean[3] - fl_v[3] * nydf)
            Sv = jacdf * torch.stack([flux_qu, flux_qv])
            # volume: qq = pbprime_visc*graduv + btp_dpp_graduv, nodal quadrature
            qq = (op.pvisc * graduv + op.bdg).view(4, E, ngl, ngl)
            X = mops.wn2[0].view(ngl, ngl) * qq[0::2]
            Y = mops.wn2[1].view(ngl, ngl) * qq[1::2]
            lap = -(torch.einsum("cejI,iI->ceji", X, dpsi)
                    + torch.einsum("ceJi,jJ->ceji", Y, dpsi)).reshape(2, E, ngl * ngl)
            lap = _add_edges(lap, -edge_sign * Sv, ngl)
            rhs = torch.cat([rhs[:1], rhs[1:] + static.visc_mlswe * lap])

        # ---- SSPRK stage combine + wall projection ----
        rhs = mops.massinv * (rhs + mops.btp_ref3)
        a0, a1, a2 = mops.a_tab[ik]
        new234 = (a0 * qb0[1:] + a1 * qb1[1:] + a2 * qb2[1:]
                  + (static.dt_btp * mops.b_tab[ik]) * rhs)
        qb1 = torch.stack([new234[0] + mops.pbprime_df, new234[0],
                           mops.masku * new234[1], mops.maskv * new234[2]])
        if kstages == 5 and ik == 1:
            # SSP(5,3) snapshots the stage-2 state into the third register
            qb2 = qb1
    return qb1


def _check_static(static, mops: MegaStatic, qb_df: Tensor):
    ngl, nq = mops.psiq.shape
    want = (4, mops.ney, mops.nex, ngl, ngl)
    if tuple(qb_df.shape) != want:
        raise ValueError(f"qb_df has shape {tuple(qb_df.shape)}, expected {want}")
    if qb_df.dtype != mops.psiq.dtype or qb_df.device != mops.psiq.device:
        raise ValueError(
            f"qb_df is {qb_df.dtype} on {qb_df.device}, the megakernel operands "
            f"are {mops.psiq.dtype} on {mops.psiq.device}")
    if static.botfr not in (0, 1, 2):
        raise ValueError(f"botfr must be 0, 1 or 2, got {static.botfr!r}")
    if len(mops.a_tab) != static.kstages:
        raise ValueError("MegaStatic was built for another kstages")
    return mops.ney * mops.nex, ngl, nq


def barotropic_solve_mega_plain(static, P, g, bc, coup, qb_df: Tensor,
                                qprime_df: Tensor, mops: MegaStatic):
    """The whole-solve path in plain torch ops (any device): the kernel's
    arithmetic, stage by stage, on the same operands.

    Same contract as core/btp.barotropic_solve: returns (qb at t+dt
    (4, ney, nex, ngl, ngl), BtpAverages); `qb_df` is not mutated."""
    E, ngl, nq = _check_static(static, mops, qb_df)
    op = solve_operands(static, g, coup, qb_df, qprime_df, mops)
    acc = new_accumulators(E, ngl, nq, dtype=qb_df.dtype, device=qb_df.device)
    qb = _mega_stages_plain(static, mops, op, acc)
    return (qb.view(4, mops.ney, mops.nex, ngl, ngl),
            averages_from_accumulators(static, mops, *acc))


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = load_library("btp_mega")
    if not getattr(lib, "_hnumo_declared", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.btp_mega_launch_route.argtypes = [i, p, i, p, i, p, i, p, ctypes.POINTER(i)]
        lib.btp_mega_launch_route.restype = ctypes.c_int
        lib.btp_mega_smem_bytes.argtypes = [i, i, i]
        lib.btp_mega_smem_bytes.restype = ctypes.c_longlong
        lib.btp_mega_smem_limit.argtypes = []
        lib.btp_mega_smem_limit.restype = ctypes.c_longlong
        lib.btp_mega_layout.argtypes = [i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(i),
                                        ctypes.POINTER(i), ctypes.POINTER(ctypes.c_longlong),
                                        ctypes.POINTER(i), ctypes.POINTER(ctypes.c_longlong)]
        lib.btp_mega_layout.restype = ctypes.c_int
        lib.btp_mega_error_string.argtypes = [i]
        lib.btp_mega_error_string.restype = ctypes.c_char_p
        lib._hnumo_declared = True
    return lib


ROUTES = ("streamed", "resident")    # csrc/btp_mega.cu kStreamed, kResident


def _check_smem(lib, dtype: torch.dtype, ngl: int, nq: int) -> int:
    """Raise where one block's shared memory exceeds the card's limit;
    returns the launcher's is_double flag."""
    is_double = int(dtype == torch.float64)
    need, limit = lib.btp_mega_smem_bytes(is_double, ngl, nq), lib.btp_mega_smem_limit()
    if need > limit:
        raise ValueError(
            f"the megakernel needs {need} bytes of shared memory per block at "
            f"ngl={ngl}, nq={nq}, {dtype}; the card allows {limit}")
    return is_double


def btp_mega_layout(dtype: torch.dtype, E: int, ngl: int, nq: int,
                    route: str | None = None) -> dict:
    """How a launch of E elements at these sizes is laid out on the current
    CUDA device (builds the kernel at the first call): its route ("resident":
    one block per element for the whole solve, taken exactly when the grid of
    E blocks fits the card at once; else "streamed": blocks walk the
    elements), elements per block, threads and shared memory per block,
    resident blocks per SM and the grid. `route` names a route instead of
    letting the size choose (the resident one raises where it does not fit).
    The launcher keeps its plans per kernel, device and size, so this asks
    the occupancy once for each."""
    if route not in (None, *ROUTES):
        raise ValueError(f"route must be None, 'streamed' or 'resident', got {route!r}")
    lib = _library()
    is_double = _check_smem(lib, dtype, ngl, nq)
    c = ctypes
    chosen = c.c_int(-1 if route is None else ROUTES.index(route))
    epb, threads, blocks = c.c_int(), c.c_int(), c.c_int()
    smem, grid = c.c_longlong(), c.c_longlong()
    err = lib.btp_mega_layout(is_double, E, ngl, nq, c.byref(chosen), c.byref(epb),
                              c.byref(threads), c.byref(smem), c.byref(blocks),
                              c.byref(grid))
    if err != 0:
        raise RuntimeError(
            f"btp_mega: no launch layout for E={E}, ngl={ngl}, nq={nq}, {dtype}, "
            f"route={route}: CUDA error {err} ({lib.btp_mega_error_string(err).decode()})")
    return {"route": ROUTES[chosen.value], "elements_per_block": epb.value,
            "threads": threads.value, "smem_bytes": smem.value,
            "blocks_per_sm": blocks.value, "grid": grid.value}


def new_state_buffers(E: int, ngl: int, **opts):
    """(ws, qb_out) of one launch: the kernel's working state — on the
    streamed route four rotating state buffers (the roles qb0/qb1/qb2/output
    follow from the stage index inside the kernel), zeroed because one of
    them starts as the zero third register; on the resident route two
    exchange buffers and the per-element stage counters, in the same room —
    and the buffer the last stage writes."""
    return (torch.zeros((4, 4, E, ngl * ngl), **opts),
            torch.empty((4, E, ngl * ngl), **opts))


def mega_launch(static, mops: MegaStatic, op: SolveOperands, acc, ws: Tensor,
                qb_out: Tensor, route: str | None = None) -> Tensor:
    """All N_btp*kstages stages in ONE launch of csrc/btp_mega.cu, on flat
    CUDA operands: fills `qb_out` (4, E, npts) with qb at t+dt and adds the
    stage values to the accumulators `acc` in place (the resident route reads
    each accumulator once and stores it once; the streamed route adds to it
    in global memory stage by stage). The route is the one
    `btp_mega_layout(..., route)` gives: by default the size chooses it, and
    the launcher takes the same decision from the same plan; `route` names
    one (chip_smoke.py holds both against the plain version on the same
    grids). Launches on the current stream, does not synchronise, raises
    on operands the kernel does not take and on a refused launch. Counts in
    `barotropic_solve_mega_cuda.launches` and, per route as the launcher
    reports the one it launched, `.launches_resident` / `.launches_streamed`."""
    ngl, nq = mops.psiq.shape
    E = op.qb.shape[1]
    dtype, device = op.qb.dtype, op.qb.device
    if device.type != "cuda":
        raise ValueError(
            f"the megakernel takes CUDA tensors, got {device}; use "
            "barotropic_solve_mega_plain (mega_impl='plain') on other devices")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the megakernel takes float32/float64, got {dtype}")
    use_visc = int(static.use_visc)
    shapes = {
        "qb": (op.qb, (4, E, ngl * ngl)), "qplq": (op.qplq, (3, E, nq * nq)),
        "coup": (op.coup, (4, E, nq * nq)), "qe": (op.qe, (4, E, 4, nq)),
        "ws": (ws, (4, 4, E, ngl * ngl)), "qb_out": (qb_out, (4, E, ngl * ngl)),
        "accv": (acc[0], (12, E, nq * nq)), "accn": (acc[1], (3, E, ngl * ngl)),
        "agr": (acc[2], (4, E, ngl * ngl)), "aff": (acc[3], (16, E, 4, nq)),
        "agt": (acc[4], (8, E, 4, ngl)),
        "ptab": (mops.ptab, (8, E, nq * nq)), "ftab": (mops.ftab, (13, E, 4, nq)),
        "ntab": (mops.ntab, (3, E, 4, ngl)),
        "btp_ref3": (mops.btp_ref3, (3, E, ngl * ngl))}
    if use_visc:
        shapes.update({"bgf": (op.bgf, (10, E, 4, ngl)),
                       "pvisc": (op.pvisc, (E, ngl * ngl)),
                       "bdg": (op.bdg, (4, E, ngl * ngl))})
    for name in ("massinv", "pbprime_df", "opbp_df", "masku", "maskv"):
        shapes[name] = (getattr(mops, name), (E, ngl * ngl))
    for name, shape in (("mir_q", (4, 4)), ("mir_g", (4, 4)), ("psiq", (ngl, nq)),
                        ("dpsiq", (ngl, nq)), ("dpsi", (ngl, ngl)),
                        ("wq3", (3, nq * nq)), ("wn2", (2, ngl * ngl))):
        shapes[name] = (getattr(mops, name), shape)
    for name, (t, shape) in shapes.items():
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != device
                or not t.is_contiguous()):
            raise ValueError(
                f"megakernel operand {name}: shape {tuple(t.shape)}, {t.dtype} on "
                f"{t.device}, contiguous={t.is_contiguous()}; expected contiguous "
                f"{shape}, {dtype} on {device}")
    if (tuple(mops.nbr.shape) != (E, 4) or mops.nbr.dtype != torch.int32
            or mops.nbr.device != device or not mops.nbr.is_contiguous()):
        raise ValueError("MegaStatic.nbr must be contiguous (E, 4) int32 on the device")

    lib = _library()
    is_double = _check_smem(lib, dtype, ngl, nq)

    def ptr(t):
        return None if t is None else t.data_ptr()

    # the three argument arrays follow the enums at the top of
    # csrc/btp_mega.cu; the launcher checks their lengths against its own
    ptrs = [ptr(t) for t in (
        op.qb, ws, qb_out, op.qplq, op.coup, op.qe, op.bgf, op.pvisc, op.bdg,
        mops.ptab, mops.btp_ref3, mops.massinv, mops.pbprime_df, mops.opbp_df,
        mops.masku, mops.maskv, mops.ftab, mops.ntab, mops.nbr, mops.mir_q,
        mops.mir_g, mops.psiq, mops.dpsiq, mops.dpsi, mops.wq3, mops.wn2, *acc)]
    ints = [is_double, E, ngl, nq, static.n_btp * static.kstages,
            static.kstages, static.botfr, use_visc]
    unused = MAX_KSTAGES - static.kstages
    reals = [static.dt_btp, static.gravity, static.cd_mlswe, static.alpha_bot,
             static.visc_mlswe, mops.kx_df, mops.ey_df,
             *[v for row in mops.a_tab for v in row], *([0.0] * (3 * unused)),
             *mops.b_tab, *([0.0] * unused)]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_reals = (ctypes.c_double * len(reals))(*[float(v) for v in reals])
    taken = ctypes.c_int(-1)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.btp_mega_launch_route(-1 if route is None else ROUTES.index(route),
                                        c_ptrs, len(ptrs), c_ints, len(ints),
                                        c_reals, len(reals), stream, ctypes.byref(taken))
    if err != 0:
        raise RuntimeError(
            f"btp_mega kernel launch failed: CUDA error {err} "
            f"({lib.btp_mega_error_string(err).decode()})")
    name = f"launches_{ROUTES[taken.value]}"
    barotropic_solve_mega_cuda.launches += 1
    setattr(barotropic_solve_mega_cuda, name, getattr(barotropic_solve_mega_cuda, name) + 1)
    return qb_out


def barotropic_solve_mega_cuda(static, P, g, bc, coup, qb_df: Tensor,
                               qprime_df: Tensor, mops: MegaStatic):
    """The whole barotropic solve as one CUDA kernel launch
    (csrc/btp_mega.cu). Same operands and contract as
    `barotropic_solve_mega_plain`; float32 or float64 CUDA tensors only.
    Builds the kernel at the first call; raises on operands the kernel does
    not take and on a refused launch (a cooperative launch needs all its
    blocks resident at once). `barotropic_solve_mega_cuda.launches` counts
    the launches made, `.launches_resident` and `.launches_streamed` those of
    each route."""
    E, ngl, nq = _check_static(static, mops, qb_df)
    op = solve_operands(static, g, coup, qb_df, qprime_df, mops)
    opts = dict(dtype=qb_df.dtype, device=qb_df.device)
    acc = new_accumulators(E, ngl, nq, **opts)
    qb = mega_launch(static, mops, op, acc, *new_state_buffers(E, ngl, **opts))
    return (qb.view(4, mops.ney, mops.nex, ngl, ngl),
            averages_from_accumulators(static, mops, *acc))


barotropic_solve_mega_cuda.launches = 0
barotropic_solve_mega_cuda.launches_resident = 0
barotropic_solve_mega_cuda.launches_streamed = 0
