"""Barotropic solver: RHS stages + SSPRK sub-cycling with running averages.

Counterpart of hnumo_tpu/core/btp.py. `barotropic_solve` dispatches like
the JAX package, in its order: within the megakernel's envelope
(StaticConfig.mega, by default up to 1024 elements) the whole solve is one
launch of ops/mega; else under StaticConfig.fused_tail the fused path runs,
three kernels per stage (ops/btp_volume_uni, ops/btp_tail) around a
plain-PyTorch trace exchange; otherwise the per-stage path below: one fused
volume kernel per stage (ops/btp_volume, or ops/btp_volume_uni under
StaticConfig.uni_volume) plus the face path in plain PyTorch, both
directions on one flat axis or one pipeline per direction
(StaticConfig.batched_faces; the quad viscosity family takes the latter),
and the SSPRK combine or the LSRK 2N-register update.
Reference: src/mod_rhs_btp.F90 (create_rhs_btp, create_rhs_btp_volume_qdf,
creat_btp_fluxes_qdf), src/mod_rk_mlswe.F90 (ti_barotropic_ssprk_mlswe),
src/mod_barotropic_terms.F90 (btp_extract_df, btp_mom_boundary_df).

This is the innermost hot loop (N_btp * kstages evaluations per dt). The
sub-cycling is a Python loop; the 23 running averages are carried as
stacked accumulators, one per family (the face families flat or per
direction, as the face path). The volume/nodal accumulators are flat (C, E, m²)
and updated IN PLACE by the volume stage (they are allocated inside
barotropic_solve, so no caller's tensor is touched); the face and gradient
accumulators are out-of-place adds.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..ops.btp_tail import (UpdateOps, btp_faces_cuda, btp_faces_plain,
                            btp_update_cuda, btp_update_plain, build_face_tables,
                            build_update_ops, static_face_rows)
from ..ops.btp_volume import (BtpVolOperators, btp_volume_cuda,
                              btp_volume_plain, eflat, operators_from_tables)
from ..ops.btp_volume_uni import (BtpVolOpsUni, btp_volume_uni_cuda,
                                  btp_volume_uni_plain, operators_uniform)
from ..ops.mega import (MegaStatic, barotropic_solve_mega_cuda,
                        barotropic_solve_mega_plain)
from ..ops.dg import DeviceGeom, grad_nodal, interp_n2q, scatter_volume, scatter_volume_nodal
from .faces import (BCs, apply_wall_projection, extract_faces_from_slabs,
                    extract_faces_multi, extract_faces_stacked, face_n2q,
                    face_quad_scatter, face_views_x, face_views_y,
                    scatter_face_x, scatter_face_y, wall_projection_masks)
from .types import BtpAverages, BtpFaceAvg, CouplingFields, Pair, Precomputed
from .viscosity import btp_quad_laplacian


# stacked-accumulator channel orders (one tensor per family, so each stage
# is a single add per family; the BtpAverages view is built once per solve)
_VOL_ORDER = ("dH", "Qu", "Qv", "Quv", "mu", "mu2", "ub", "vb",
              "mfU", "mfV", "tbU", "tbV")
_NOD_ORDER = ("mu2_df", "ub_df", "vb_df")
_FACE_ORDER = ("dH", "QuU", "QuV", "QvU", "QvV", "muL", "muR", "mu2L",
               "mu2R", "fluxU", "fluxV", "mue2", "ubL", "ubR", "vbL", "vbR")


def btp_extract_df(bc: BCs, qb_df: Tensor):
    """Nodal face traces of the 4 barotropic variables with BC mirrors.

    Reference btp_extract_df (src/mod_barotropic_terms.F90:25-97): pb and
    pbpert copy across walls; (pbub, pbvb) get the free-slip/no-slip mirror.
    Returns a list of 4 FaceLR.
    """
    return extract_faces_multi(qb_df, bc, vec_pairs=((2, 3),))


def btp_volume_rhs(static, P: Precomputed, g: DeviceGeom, coup: CouplingFields,
                   qb_df: Tensor, qpl_q: Tensor):
    """Barotropic volume RHS + volume average increments, structured layout.

    Reference create_rhs_btp_volume_qdf (src/mod_rhs_btp.F90:102-209).
    `qpl_q`: bottom-layer primes at quad points (3, quad) — constant over
    one barotropic solve, interpolated once by the caller.
    Returns (rhs (3, nodal) without massinv, stacked increments (12, quad)
    in _VOL_ORDER). The solver itself goes through ops/btp_volume (flat
    layout); this structured form is what that module is held against.
    """
    grav = static.gravity
    qbq = interp_n2q(g, qb_df)                     # (4, quad)
    dp, dpp, udp, vdp = qbq[0], qbq[1], qbq[2], qbq[3]
    # bottom-layer primes (channel 0 carries δdp'; full needed for friction)
    pp, up, vp = P.dpp_ref_q[-1] + qpl_q[0], qpl_q[1], qpl_q[2]

    ub = udp / dp
    vb = vdp / dp

    if static.botfr == 1:      # linear bottom drag (reference :157-162)
        spd = (static.cd_mlswe / grav) * pp
        tb_u = spd * (up + ub)
        tb_v = spd * (vp + vb)
    elif static.botfr == 2:    # quadratic (reference :163-169)
        ubot, vbot = up + ub, vp + vb
        spd = (static.cd_mlswe / static.alpha_bot) * torch.sqrt(ubot**2 + vbot**2)
        tb_u = spd * ubot
        tb_v = spd * vbot
    else:
        tb_u = torch.zeros_like(dp)
        tb_v = torch.zeros_like(dp)

    # δ-form pressure/source terms (docs/float32.md): the static parts
    # (H_bcl_ref flux + g*pbprime*grad(zb) source + reference edge fluxes)
    # live in the precomputed P.btp_rhs_ref vector added by the face stage.
    f = P.coriolis_quad
    sc_x = f * vdp + grav * (P.tau_wind[0] - tb_u) - grav * dpp * P.grad_zbot_quad[0]
    sc_y = -f * udp + grav * (P.tau_wind[1] - tb_v) - grav * dpp * P.grad_zbot_quad[1]

    mu = dpp * P.one_over_pbprime              # ope - 1, conditioned
    mu2 = mu * (2.0 + mu)                      # ope^2 - 1
    ope = 1.0 + mu
    dHq = coup.dH_bcl + mu2 * (P.H_bcl_ref + coup.dH_bcl)   # Hq - H_bcl_ref
    qu = ub * udp + ope * coup.Q_uu_dp
    quv = ub * vdp + ope * coup.Q_uv_dp
    qv = vb * vdp + ope * coup.Q_vv_dp

    rhs1 = scatter_volume(g, Fx=udp, Fy=vdp)
    rhs2 = scatter_volume(g, Fx=dHq + qu, Fy=quv, Fs=sc_x)
    rhs3 = scatter_volume(g, Fx=quv, Fy=dHq + qv, Fs=sc_y)
    rhs = torch.stack([rhs1, rhs2, rhs3])

    # stacked in _VOL_ORDER
    avg_inc = torch.stack([dHq, qu, qv, quv, mu, mu2, ub, vb, udp, vdp,
                           tb_u, tb_v])
    return rhs, avg_inc


def _flatf(a: Tensor) -> Tensor:
    """Merge the two structured face axes: (..., A, B, m) -> (..., A*B, m)."""
    return a.reshape(a.shape[:-3] + (a.shape[-3] * a.shape[-2], a.shape[-1]))


def _catf(ax_arr: Tensor, ay_arr: Tensor) -> Tensor:
    """Concatenate flattened x-face and y-face tables on one flat face axis
    (x-faces first, Fx = ney*(nex+1) of them, then the y-faces).

    The direction-agnostic face-flux math (direction enters only through the
    normal tables) then runs BOTH directions in one batched pipeline, which
    halves the number of small launches per stage."""
    return torch.cat([_flatf(ax_arr), _flatf(ay_arr)], dim=-2)


def _face_flux_core(fg, Qe_uu, Qe_uv, Qe_vv, dHe, qblq, qbrq, pbl, pbr,
                    psiq):
    """Barotropic face flux kernel, direction-agnostic.

    Reference creat_btp_fluxes_qdf (src/mod_rhs_btp.F90:211-364).
    qblq/qbrq: (4, F..., nq) stacked quad traces; fg tables broadcastable to
    (F..., nq); pbl/pbr: one-sided reference pb' at quad points.
    Returns (S_left scatter values (3, F..., ngl), BtpFaceAvg increments
    (16, F..., nq) without the graduvb slots).
    """
    nx, ny = fg.nx, fg.ny

    pU_L = nx * qblq[2] + ny * qblq[3]
    pU_R = -(nx * qbrq[2] + ny * qbrq[3])
    pbpert_edge = (fg.coeff_pbpert_L * qblq[1] + fg.coeff_pbpert_R * qbrq[1]
                   + fg.coeff_pbub_LR * (pU_L + pU_R))
    mue = pbpert_edge * fg.one_over_pbprime_edge    # ope_edge - 1
    mue2 = mue * (2.0 + mue)                        # ope_edge^2 - 1
    ope_edge = 1.0 + mue

    flux_edge_x = (fg.coeff_mass_pbub_L * qblq[2] + fg.coeff_mass_pbub_R * qbrq[2]
                   + fg.coeff_mass_pbpert_LR * nx * (qblq[1] - qbrq[1]))
    flux_edge_y = (fg.coeff_mass_pbub_L * qblq[3] + fg.coeff_mass_pbub_R * qbrq[3]
                   + fg.coeff_mass_pbpert_LR * ny * (qblq[1] - qbrq[1]))

    ul, ur = qblq[2] / qblq[0], qbrq[2] / qbrq[0]
    vl, vr = qblq[3] / qblq[0], qbrq[3] / qbrq[0]

    quu = 0.5 * (ul * qblq[2] + ur * qbrq[2]) + ope_edge * Qe_uu
    quv = 0.5 * (vl * qblq[2] + vr * qbrq[2]) + ope_edge * Qe_uv
    qvu = 0.5 * (ul * qblq[3] + ur * qbrq[3]) + ope_edge * Qe_uv
    qvv = 0.5 * (vl * qblq[3] + vr * qbrq[3]) + ope_edge * Qe_vv
    # δ-form: H_face - Hedge_ref; static part in P.btp_rhs_ref
    dH_face = dHe + mue2 * (fg.Hedge_ref + dHe)

    lamb = fg.coeff_mass_pbpert_LR
    dispu = 0.5 * lamb * (qbrq[2] - qblq[2])
    dispv = 0.5 * lamb * (qbrq[3] - qblq[3])
    flux_x = nx * quu + ny * quv - dispu
    flux_y = nx * qvu + ny * qvv - dispv
    flux = nx * flux_edge_x + ny * flux_edge_y
    H_kx, H_ky = nx * dH_face, ny * dH_face

    # one batched quad->nodal face projection for all 3 scatter channels
    S = face_quad_scatter(psiq, fg.jac,
                          torch.stack([flux, H_kx + flux_x, H_ky + flux_y]))

    muL = qblq[1] / pbl
    muR = qbrq[1] / pbr
    # stacked in _FACE_ORDER
    inc = torch.stack([dH_face, quu, quv, qvu, qvv, muL, muR,
                       muL * (2.0 + muL), muR * (2.0 + muR),
                       flux_edge_x, flux_edge_y, mue2, ul, ur, vl, vr])
    return S, inc


def _face_flux_dir(static, fg, Qe_uu, Qe_uv, Qe_vv, dHe, traces, psiq):
    """Per-direction wrapper of _face_flux_core (the structured face path).

    traces: list of 4 (L, R) nodal trace pairs."""
    qblq = face_n2q(psiq, torch.stack([t[0] for t in traces]))
    qbrq = face_n2q(psiq, torch.stack([t[1] for t in traces]))
    # one-sided reference pb' interpolated from nodal face values (:257-258)
    pbl = face_n2q(psiq, fg.pbprime_df_face_L)
    pbr = face_n2q(psiq, fg.pbprime_df_face_R)
    return _face_flux_core(fg, Qe_uu, Qe_uv, Qe_vv, dHe, qblq, qbrq,
                           pbl, pbr, psiq)


def btp_nodal_laplacian(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                        coup: CouplingFields, qb_df: Tensor):
    """Nodal-family LDG barotropic viscosity (method_visc != 1), one face
    pipeline per direction.

    Reference btp_create_laplacian (src/mod_laplacian_quad.F90:32-121).
    Returns (rhs_lap (2, nodal), graduv (4, nodal), graduv_face Pair of
    (4, 2, F, ngl)) — the latter two feed the graduvb averages.
    """
    Uk_u = qb_df[2] / qb_df[0]
    Uk_v = qb_df[3] / qb_df[0]
    gux, guy = grad_nodal(g, Uk_u)
    gvx, gvy = grad_nodal(g, Uk_v)
    graduv = torch.stack([gux, guy, gvx, gvy])

    fg = extract_faces_multi(graduv, bc, vec_pairs=((0, 1), (2, 3)))
    gface_x = torch.stack([torch.stack([f.xl for f in fg]),
                           torch.stack([f.xr for f in fg])], dim=1)
    gface_y = torch.stack([torch.stack([f.yl for f in fg]),
                           torch.stack([f.yr for f in fg])], dim=1)

    # volume (reference btp_compute_laplacian :357-390): note the MINUS sign
    qq = coup.pbprime_visc[None] * graduv + coup.btp_dpp_graduv
    lap_u = -scatter_volume_nodal(g, qq[0], qq[1])
    lap_v = -scatter_volume_nodal(g, qq[2], qq[3])

    # face flux (reference create_rhs_laplacian_flux :427-519): nodal-resolution
    # faces, psi = identity, flip-flop central flux; L gets +, R gets -
    def face_dir(gface, bgf, nx_df, ny_df, jac_df):
        # gface: (4, 2, F, ngl); bgf: (5, 2, F, ngl)
        fl = bgf[4, 0] * gface[:, 0] + bgf[:4, 0]   # (4, F, ngl)
        fr = bgf[4, 1] * gface[:, 1] + bgf[:4, 1]
        qmean = 0.5 * (fl + fr)
        flux_qu = (qmean[0] - fl[0] * nx_df) + (qmean[1] - fl[1] * ny_df)
        flux_qv = (qmean[2] - fl[2] * nx_df) + (qmean[3] - fl[3] * ny_df)
        return jac_df * flux_qu, jac_df * flux_qv

    fgx, fgy = P.faces.x, P.faces.y
    SxU, SxV = face_dir(gface_x, coup.btp_graduv_dpp_face.x, fgx.nx_df, fgx.ny_df, fgx.jac_df)
    SyU, SyV = face_dir(gface_y, coup.btp_graduv_dpp_face.y, fgy.nx_df, fgy.ny_df, fgy.jac_df)

    lap_u = scatter_face_x(lap_u, -SxU, bc)
    lap_u = scatter_face_y(lap_u, -SyU, bc)
    lap_v = scatter_face_x(lap_v, -SxV, bc)
    lap_v = scatter_face_y(lap_v, -SyV, bc)

    rhs_lap = static.visc_mlswe * g.massinv * torch.stack([lap_u, lap_v])
    return rhs_lap, graduv, Pair(gface_x, gface_y)


def _btp_faces_visc(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                    coup: CouplingFields, qb_df: Tensor, qprime_df: Tensor,
                    rhs: Tensor):
    """Face fluxes + static δ-form terms + massinv + viscosity — everything
    in a barotropic RHS evaluation except the volume stage (reference
    create_rhs_btp, src/mod_rhs_btp.F90:38-57) — one face pipeline per
    direction. The viscosity is either LDG family: the quad family
    (method_visc == 1) takes only this pipeline.
    Returns (rhs, inc_x (16, Fx, nq), inc_y, graduv (4, nodal),
    gface Pair of (4, 2, F, ngl))."""
    traces = btp_extract_df(bc, qb_df)

    fx = P.faces.x
    fy = P.faces.y
    Sx, inc_x = _face_flux_dir(static, fx, coup.Q_uu_dp_edge.x, coup.Q_uv_dp_edge.x,
                               coup.Q_vv_dp_edge.x, coup.dH_bcl_edge.x,
                               [(t.xl, t.xr) for t in traces], g.psiq)
    Sy, inc_y = _face_flux_dir(static, fy, coup.Q_uu_dp_edge.y, coup.Q_uv_dp_edge.y,
                               coup.Q_vv_dp_edge.y, coup.dH_bcl_edge.y,
                               [(t.yl, t.yr) for t in traces], g.psiq)
    rhs = scatter_face_x(rhs, Sx, bc)
    rhs = scatter_face_y(rhs, Sy, bc)
    rhs = rhs + P.btp_rhs_ref          # static reference terms (δ-form)
    rhs = g.massinv * rhs

    if static.use_visc:
        if static.method_visc == 1:
            rhs_visc, graduv, gface = btp_quad_laplacian(static, P, g, bc, coup,
                                                         qb_df, qprime_df)
        else:
            rhs_visc, graduv, gface = btp_nodal_laplacian(static, P, g, bc, coup, qb_df)
        rhs = torch.cat([rhs[:1], rhs[1:] + rhs_visc])
    else:
        opts = dict(dtype=qb_df.dtype, device=qb_df.device)
        graduv = torch.zeros((4,) + qb_df.shape[1:], **opts)
        gface = Pair(torch.zeros((4, 2) + traces[0].xl.shape, **opts),
                     torch.zeros((4, 2) + traces[0].yl.shape, **opts))

    return rhs, inc_x, inc_y, graduv, gface


def create_rhs_btp(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                   coup: CouplingFields, qb_df: Tensor, qprime_df: Tensor):
    """One barotropic RHS evaluation in the structured layout, faces per
    direction (reference create_rhs_btp, src/mod_rhs_btp.F90:28-59).
    Returns (rhs (3, nodal), volume increments (12, quad), inc_x, inc_y,
    graduv, gface). The solver runs the volume stage through ops/btp_volume
    (or ops/btp_volume_uni) instead; this form is what the stage functions
    are held against."""
    qpl_q = interp_n2q(g, qprime_df[:, -1])
    rhs, vol_inc = btp_volume_rhs(static, P, g, coup, qb_df, qpl_q)
    rhs, inc_x, inc_y, graduv, gface = _btp_faces_visc(
        static, P, g, bc, coup, qb_df, qprime_df, rhs)
    return rhs, vol_inc, inc_x, inc_y, graduv, gface


class _FlatFaceGeom(NamedTuple):
    """The FaceDirGeom subset the flat-axis face path reads — only these
    tables are concatenated per solve (the multi-layer reference tables are
    consumed by the baroclinic path on the structured view only)."""

    nx: Tensor
    ny: Tensor
    jac: Tensor
    nx_df: Tensor
    ny_df: Tensor
    jac_df: Tensor
    coeff_pbpert_L: Tensor
    coeff_pbpert_R: Tensor
    coeff_pbub_LR: Tensor
    coeff_mass_pbub_L: Tensor
    coeff_mass_pbub_R: Tensor
    coeff_mass_pbpert_LR: Tensor
    one_over_pbprime_edge: Tensor
    Hedge_ref: Tensor
    pbprime_df_face_L: Tensor
    pbprime_df_face_R: Tensor


def _build_flat_faces(static, P: Precomputed, g: DeviceGeom,
                      coup: CouplingFields):
    """Per-solve flat face bundle for the flat-axis face path.

    Concatenates the consumed per-direction face tables ([x-faces; y-faces]
    on one flat axis) once per barotropic solve — amortized over
    N_btp*kstages stages — and hoists the stage-invariant reference pb'
    interpolation. Returns (fgf, (Qe_uu, Qe_uv, Qe_vv, dHe), pbl, pbr,
    bgf)."""
    fx, fy = P.faces.x, P.faces.y
    fgf = _FlatFaceGeom(*[_catf(getattr(fx, f), getattr(fy, f))
                          for f in _FlatFaceGeom._fields])
    Qe = tuple(_catf(p.x, p.y) for p in (coup.Q_uu_dp_edge,
                                         coup.Q_uv_dp_edge,
                                         coup.Q_vv_dp_edge,
                                         coup.dH_bcl_edge))
    pbl = face_n2q(g.psiq, fgf.pbprime_df_face_L)
    pbr = face_n2q(g.psiq, fgf.pbprime_df_face_R)
    bgf = (_catf(coup.btp_graduv_dpp_face.x, coup.btp_graduv_dpp_face.y)
           if static.use_visc else None)
    return fgf, Qe, pbl, pbr, bgf


def _nodal_laplacian_flat(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                          coup: CouplingFields, flat, qb_df: Tensor):
    """Nodal-family LDG barotropic viscosity (method_visc != 1) with the
    face pipeline batched over the flat face axis.

    Reference btp_create_laplacian (src/mod_laplacian_quad.F90:32-121).
    Returns (rhs_lap (2, nodal), graduv (4, nodal), gface_flat
    (4, 2, F, ngl)) — the latter two feed the graduvb averages."""
    fgf, _, _, _, bgf = flat
    ney, nex = g.wjac.shape[0], g.wjac.shape[1]
    ngl = g.wjac_df.shape[-1]
    Fx = ney * (nex + 1)

    Uk_u = qb_df[2] / qb_df[0]
    Uk_v = qb_df[3] / qb_df[0]
    gux, guy = grad_nodal(g, Uk_u)
    gvx, gvy = grad_nodal(g, Uk_v)
    graduv = torch.stack([gux, guy, gvx, gvy])

    xl, xr, yl, yr = extract_faces_stacked(graduv, bc,
                                           vec_pairs=((0, 1), (2, 3)))
    gl = _catf(xl, yl)                      # (4, F, ngl)
    gr = _catf(xr, yr)

    # volume (reference btp_compute_laplacian :357-390): note the MINUS sign
    qq = coup.pbprime_visc[None] * graduv + coup.btp_dpp_graduv
    lap_u = -scatter_volume_nodal(g, qq[0], qq[1])
    lap_v = -scatter_volume_nodal(g, qq[2], qq[3])

    # face flux (reference create_rhs_laplacian_flux :427-519): nodal-resolution
    # faces, psi = identity, flip-flop central flux; L gets +, R gets -
    fl = bgf[4, 0] * gl + bgf[:4, 0]
    fr = bgf[4, 1] * gr + bgf[:4, 1]
    qmean = 0.5 * (fl + fr)
    flux_qu = ((qmean[0] - fl[0] * fgf.nx_df)
               + (qmean[1] - fl[1] * fgf.ny_df))
    flux_qv = ((qmean[2] - fl[2] * fgf.nx_df)
               + (qmean[3] - fl[3] * fgf.ny_df))
    S = fgf.jac_df * torch.stack([flux_qu, flux_qv])   # (2, F, ngl)

    Sx = S[:, :Fx].reshape(2, ney, nex + 1, ngl)
    Sy = S[:, Fx:].reshape(2, ney + 1, nex, ngl)
    lap_u = scatter_face_x(lap_u, -Sx[0], bc)
    lap_u = scatter_face_y(lap_u, -Sy[0], bc)
    lap_v = scatter_face_x(lap_v, -Sx[1], bc)
    lap_v = scatter_face_y(lap_v, -Sy[1], bc)

    rhs_lap = static.visc_mlswe * g.massinv * torch.stack([lap_u, lap_v])
    gface_flat = torch.stack([gl, gr], dim=1)         # (4, 2, F, ngl)
    return rhs_lap, graduv, gface_flat


def _btp_faces_visc_flat(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                         coup: CouplingFields, flat, qb_df: Tensor, rhs: Tensor):
    """Face fluxes + static δ-form terms + massinv + viscosity — everything
    in a barotropic RHS evaluation except the volume stage (reference
    create_rhs_btp, src/mod_rhs_btp.F90:38-57) — with both face directions
    batched on one flat axis.

    Returns (rhs, inc (16, F, nq), graduv (4, nodal),
    gface_flat (4, 2, F, ngl))."""
    fgf, (Qe_uu, Qe_uv, Qe_vv, dHe), pbl, pbr, _ = flat
    ney, nex = g.wjac.shape[0], g.wjac.shape[1]
    ngl = g.wjac_df.shape[-1]
    Fx = ney * (nex + 1)
    F = Fx + (ney + 1) * nex

    xl, xr, yl, yr = extract_faces_stacked(qb_df, bc, vec_pairs=((2, 3),))
    qblq = face_n2q(g.psiq, _catf(xl, yl))    # (4, F, nq) one product
    qbrq = face_n2q(g.psiq, _catf(xr, yr))

    S, inc = _face_flux_core(fgf, Qe_uu, Qe_uv, Qe_vv, dHe, qblq, qbrq,
                             pbl, pbr, g.psiq)
    Sx = S[:, :Fx].reshape(3, ney, nex + 1, ngl)
    Sy = S[:, Fx:].reshape(3, ney + 1, nex, ngl)
    rhs = scatter_face_x(rhs, Sx, bc)
    rhs = scatter_face_y(rhs, Sy, bc)
    rhs = rhs + P.btp_rhs_ref          # static reference terms (δ-form)
    rhs = g.massinv * rhs

    if static.use_visc:
        rhs_visc, graduv, gface_flat = _nodal_laplacian_flat(
            static, P, g, bc, coup, flat, qb_df)
        rhs = torch.cat([rhs[:1], rhs[1:] + rhs_visc])
    else:
        opts = dict(dtype=qb_df.dtype, device=qb_df.device)
        graduv = torch.zeros((4,) + qb_df.shape[1:], **opts)
        gface_flat = torch.zeros((4, 2, F, ngl), **opts)

    return rhs, inc, graduv, gface_flat


def _averages_view(static, vol, nod, fxa, fya, gvx, gvy, graduvb) -> BtpAverages:
    """Build the BtpAverages NamedTuple from the stacked accumulators."""
    def face(fa, gv):
        return BtpFaceAvg(**dict(zip(_FACE_ORDER, fa)), gvL=gv[0], gvR=gv[1])

    return BtpAverages(**dict(zip(_VOL_ORDER, vol)),
                       **dict(zip(_NOD_ORDER, nod)),
                       graduvb=graduvb,
                       faces=Pair(face(fxa, gvx), face(fya, gvy)))


def build_vol_operators(static, g: DeviceGeom, P: Precomputed, cell=None):
    """Flat volume operator tables of the per-stage path (state-independent):
    the uniform-geometry ones under `static.uni_volume`, else the general.

    Everything here depends only on geometry and precomputed physics
    tables, so callers evaluate it once at model build and pass the result
    through `barotropic_solve(vol_ops=...)`. `cell`: see operators_uniform."""
    if static.uni_volume:
        return operators_uniform(g, P, static.flat_bottom, cell=cell)
    return operators_from_tables(g, P)


class FusedOps(NamedTuple):
    """State-independent operands of the fused path (built once per model)."""

    vol: BtpVolOpsUni     # kernel A, massinv folded, with the gradient when viscous
    upd: UpdateOps        # kernel U
    face_rows: tuple      # static_face_rows: (ftab rows 0-10, ntab) of kernel F
    mask: Tensor          # (2, E, npts) wall projection of (pbub, pbvb)


def build_fused_operators(static, g: DeviceGeom, P: Precomputed, bc: BCs,
                          cell=None) -> FusedOps:
    """The fused path's operator tables; callers evaluate them once at model
    build and pass the result through `barotropic_solve(tail_ops=...)`.
    `cell`: see ops/btp_volume_uni.operators_uniform. The wall masks are this
    block's: ones on the edges of a block that owns no wall."""
    ney, nex = g.wjac.shape[0], g.wjac.shape[1]
    ngl = g.wjac_df.shape[-1]
    mu_w, mv_w = wall_projection_masks((ney, nex, ngl, ngl), bc, g.wjac.dtype,
                                       g.wjac.device)
    return FusedOps(
        vol=operators_uniform(g, P, static.flat_bottom, fold_massinv=True,
                              with_grad=static.use_visc, cell=cell),
        upd=build_update_ops(static, P, g, cell=cell),
        face_rows=static_face_rows(P),
        mask=torch.stack([eflat(mu_w), eflat(mv_w)]))


def fused_traces(bc: BCs, ney: int, nex: int, ngl: int, qb: Tensor,
                 gv: Tensor | None):
    """Left/right face traces (8|4, F, ngl) of the flat state `qb`
    (4, E, npts) and, when viscous, of the velocity gradient `gv`
    (4, E, npts) on the flat face axis [x-faces ; y-faces]: the exchange
    between the volume and the face stage. Built from strided views of the
    edge nodes (the thin slabs, not the full fields); the wall mirrors of the
    momentum and gradient channels are applied here."""
    def slabs(qf):   # east, west, north, south: (C, ney, nex, ngl)
        q = qf.view(qf.shape[0], ney, nex, ngl, ngl)
        return q[..., :, -1], q[..., :, 0], q[..., -1, :], q[..., 0, :]

    if gv is None:
        slb, vec_pairs = slabs(qb), ((2, 3),)
    else:
        slb = tuple(torch.cat([sq, sg]) for sq, sg in zip(slabs(qb), slabs(gv)))
        vec_pairs = ((2, 3), (4, 5), (6, 7))
    xl, xr, yl, yr = extract_faces_from_slabs(*slb, bc, vec_pairs=vec_pairs)
    C = xl.shape[0]

    def pack(xt, yt):
        return torch.cat([xt.reshape(C, -1, ngl), yt.reshape(C, -1, ngl)], dim=1)

    return pack(xl, yl), pack(xr, yr)


def fused_edge_pack(bc: BCs, ney: int, nex: int, Sflat: Tensor,
                    negate: bool = False) -> Tensor:
    """(n, F, ngl) face values -> signed element edge stack (n, E, 4*ngl)
    ordered [W, E, S, N] (the update stage's edge slots): the exchange
    between the face and the update stage. The sign with which a face value
    lands on its two elements, and on a boundary element, is applied here
    (faces.face_views_x/y)."""
    n, ngl = Sflat.shape[0], Sflat.shape[-1]
    nfx = ney * (nex + 1)
    Sx = Sflat[:, :nfx].view(n, ney, nex + 1, ngl)
    Sy = Sflat[:, nfx:].view(n, ney + 1, nex, ngl)
    if negate:
        Sx, Sy = -Sx, -Sy
    Sw, Se = face_views_x(Sx, bc)
    Ss, Sn = face_views_y(Sy, bc)
    return torch.cat([v.reshape(n, ney * nex, ngl) for v in (Sw, Se, Ss, Sn)], dim=-1)


def _barotropic_solve_fused(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                            coup: CouplingFields, qb_df: Tensor,
                            qprime_df: Tensor, fops: FusedOps):
    """Whole-stage fused barotropic solve: three kernels per stage — volume
    (+gradient), all-faces flux, update — around a plain-PyTorch exchange
    that gathers the edge traces for the face stage and the face values for
    the update stage.

    Counterpart of hnumo_tpu/core/btp._barotropic_solve_fused. The state
    and every accumulator are carried FLAT (element- / face-major) across
    the whole sub-cycling; structured layouts are rebuilt once at the end.
    Kernel A under `static.volume_impl`, kernels F and U under
    `static.tail_impl` ("kernel": CUDA, "plain": plain PyTorch). The
    accumulators are allocated here and updated in place by the stages;
    `qb_df` is not mutated."""
    dtype, device = qb_df.dtype, qb_df.device
    opts = dict(dtype=dtype, device=device)
    ney, nex = g.wjac.shape[0], g.wjac.shape[1]
    nq, ngl = g.wjac.shape[-1], g.wjac_df.shape[-1]
    npts, nqq = ngl * ngl, nq * nq
    E = ney * nex
    use_visc = static.use_visc
    kstages = static.kstages

    volume = (btp_volume_uni_cuda if static.volume_impl == "kernel"
              else btp_volume_uni_plain)
    faces, update = ((btp_faces_cuda, btp_update_cuda) if static.tail_impl == "kernel"
                     else (btp_faces_plain, btp_update_plain))
    vol_kw = dict(grav=static.gravity, botfr=static.botfr, cd=static.cd_mlswe,
                  alpha_bot=static.alpha_bot)

    # constant over the whole solve
    tabs = build_face_tables(P, coup, g.psiq, use_visc, static_rows=fops.face_rows)
    nfx, nfy = tabs.nfx, tabs.nfy
    F = nfx + nfy
    coup_flat = torch.stack([eflat(c.contiguous()) for c in
                             (coup.Q_uu_dp, coup.Q_uv_dp, coup.Q_vv_dp, coup.dH_bcl)])
    qpln_flat = eflat(qprime_df[:, -1].contiguous())
    pbpv = bdg = ag = agr = None
    if use_visc:
        pbpv = eflat(coup.pbprime_visc.contiguous())[None]
        bdg = eflat(coup.btp_dpp_graduv.contiguous())
        ag = torch.zeros((8, F, ngl), **opts)
        agr = torch.zeros((4, E, npts), **opts)
    accv = torch.zeros((12, E, nqq), **opts)
    accn = torch.zeros((3, E, npts), **opts)
    af = torch.zeros((16, F, nq), **opts)

    # SSPRK tables as Python floats, made at build: no device read in a solve
    a, beta = static.ssprk_a, static.ssprk_beta

    qb1 = eflat(qb_df.contiguous())
    qb2 = torch.zeros_like(qb1)
    for _ in range(static.n_btp):
        qb0 = qb1            # register 0 of THIS sub-step
        for ik in range(kstages):
            # kernel A: volume RHS + volume/nodal averages (+ gradient)
            if use_visc:
                rhs, accv, accn, gv, agr = volume(
                    fops.vol, qb1, qpln_flat, accv, accn, coup_flat, agr, **vol_kw)
            else:
                rhs, accv, accn = volume(
                    fops.vol, qb1, qpln_flat, accv, accn, coup_flat, **vol_kw)
                gv = None

            # the exchange: traces of the [qb, graduv] channel stack
            trL, trR = fused_traces(bc, ney, nex, ngl, qb1, gv)

            # kernel F: all-faces flux + face averages
            S, Sv, af, ag = faces(tabs, trL, trR, af, ag, use_visc=use_visc)
            vedges = fused_edge_pack(bc, ney, nex, Sv, negate=True) if use_visc else None
            edges = fused_edge_pack(bc, ney, nex, S)

            # kernel U: edge placement + viscosity volume term + SSPRK combine
            w = (a[ik][0], a[ik][1], a[ik][2], static.dt_btp * beta[ik])
            qb1 = update(fops.upd, w, rhs, edges, vedges, qb0, qb1, qb2, gv,
                         pbpv, bdg, fops.mask, use_visc=use_visc)
            if kstages == 5 and ik == 1:
                # SSP(5,3) snapshots the stage-2 state into the third register
                qb2 = qb1

    n_inv = 1.0 / (kstages * static.n_btp)
    vol = (accv * n_inv).view(12, ney, nex, nq, nq)
    nod = (accn * n_inv).view(3, ney, nex, ngl, ngl)
    af = af * n_inv
    afx = af[:, :nfx].reshape(16, ney, nex + 1, nq)
    afy = af[:, nfx:].reshape(16, ney + 1, nex, nq)
    if use_visc:
        ag2 = (ag * n_inv).view(2, 4, F, ngl)
        agx = ag2[:, :, :nfx].reshape(2, 4, ney, nex + 1, ngl)
        agy = ag2[:, :, nfx:].reshape(2, 4, ney + 1, nex, ngl)
        agrad = (agr * n_inv).view(4, ney, nex, ngl, ngl)
    else:
        agx = torch.zeros((2, 4, ney, nex + 1, ngl), **opts)
        agy = torch.zeros((2, 4, ney + 1, nex, ngl), **opts)
        agrad = torch.zeros((4, ney, nex, ngl, ngl), **opts)
    qb = qb1.view(4, ney, nex, ngl, ngl)
    return qb, _averages_view(static, vol, nod, afx, afy, agx, agy, agrad)


def barotropic_solve(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                     coup: CouplingFields, qb_df: Tensor, qprime_df: Tensor,
                     vol_ops: BtpVolOperators | BtpVolOpsUni | None = None,
                     mega_ops: MegaStatic | None = None,
                     tail_ops: FusedOps | None = None):
    """SSPRK barotropic sub-cycling over N_btp steps x kstages stages.

    Reference ti_barotropic_ssprk_mlswe (src/mod_rk_mlswe.F90:19-151).
    With `static.mega` and `mega_ops` (ops/mega.build_mega_static) the whole
    solve is one call of ops/mega — the CUDA megakernel when
    static.mega_impl == "kernel", its plain version when "plain".
    Else with `static.fused_tail` the fused path runs
    (`_barotropic_solve_fused`; `tail_ops` from `build_fused_operators`,
    rebuilt here when None).
    Otherwise each stage is one fused volume stage — the CUDA kernel when
    static.volume_impl == "kernel", its plain version when "plain"; the
    uniform-geometry stage under `static.uni_volume` — which also updates
    the flat volume/nodal accumulators in place, followed by the face path
    in plain PyTorch (flat axis under `static.batched_faces`, else per
    direction) and the SSPRK combine, or under ti_method_btp == "lsrk" the
    2N-register update (lsrk_ref is the SSPRK combine on the LSRK tables).
    Returns (qb_df at t+dt, normalized BtpAverages); `qb_df` is not mutated.
    """
    if static.mega and mega_ops is not None:
        solve = (barotropic_solve_mega_cuda if static.mega_impl == "kernel"
                 else barotropic_solve_mega_plain)
        return solve(static, P, g, bc, coup, qb_df, qprime_df, mega_ops)
    if static.fused_tail:
        fops = (tail_ops if tail_ops is not None
                else build_fused_operators(static, g, P, bc))
        return _barotropic_solve_fused(static, P, g, bc, coup, qb_df, qprime_df, fops)

    dtype, device = qb_df.dtype, qb_df.device
    opts = dict(dtype=dtype, device=device)
    ney, nex = g.wjac.shape[0], g.wjac.shape[1]
    nq, ngl = g.wjac.shape[-1], g.wjac_df.shape[-1]
    E = ney * nex
    Fx = ney * (nex + 1)
    F = Fx + (ney + 1) * nex
    kstages, n_btp = static.kstages, static.n_btp
    batched = static.batched_faces
    lsrk = static.ti_method_btp == "lsrk"

    kernel = static.volume_impl == "kernel"
    if static.uni_volume:
        volume = btp_volume_uni_cuda if kernel else btp_volume_uni_plain
    else:
        volume = btp_volume_cuda if kernel else btp_volume_plain
    ops = vol_ops if vol_ops is not None else build_vol_operators(static, g, P)
    vol_kw = dict(grav=static.gravity, botfr=static.botfr, cd=static.cd_mlswe,
                  alpha_bot=static.alpha_bot)

    # fresh per solve: the volume stage mutates these two
    accv = torch.zeros((12, E, nq * nq), **opts)
    accn = torch.zeros((3, E, ngl * ngl), **opts)
    if batched:      # one flat face accumulator per family, both directions
        aff = torch.zeros((16, F, nq), **opts)
        agf = torch.zeros((2, 4, F, ngl), **opts)            # graduv L/R
    else:            # the structured per-direction view
        afx = torch.zeros((16, ney, nex + 1, nq), **opts)
        afy = torch.zeros((16, ney + 1, nex, nq), **opts)
        agx = torch.zeros((2, 4, ney, nex + 1, ngl), **opts)
        agy = torch.zeros((2, 4, ney + 1, nex, ngl), **opts)
    agrad = torch.zeros((4, ney, nex, ngl, ngl), **opts)  # graduvb nodal

    # SSPRK (or LSRK) tables as Python floats, made at build: no device read
    # in a solve
    a, beta = static.ssprk_a, static.ssprk_beta

    # constant over the whole solve: bottom-layer primes (nodal for the
    # uniform-geometry stage, which interpolates them itself, else at quad
    # points), the flattened coupling stack and the flat face bundle
    if static.uni_volume:
        qpln_flat = eflat(qprime_df[:, -1].contiguous())
    else:
        qplq_flat = eflat(interp_n2q(g, qprime_df[:, -1]).contiguous())
    coup_flat = torch.stack([eflat(coup.Q_uu_dp.contiguous()),
                             eflat(coup.Q_uv_dp.contiguous()),
                             eflat(coup.Q_vv_dp.contiguous()),
                             eflat(coup.dH_bcl.contiguous())])
    flat = _build_flat_faces(static, P, g, coup) if batched else None

    qb1 = qb_df
    qb2 = torch.zeros_like(qb_df)     # SSP: third register; lsrk: the dq register
    for _ in range(n_btp):
        qb0 = qb1            # register 0 of THIS sub-step
        for ik in range(kstages):
            # volume RHS + volume/nodal averages (nodal ones from the
            # pre-stage qb1, reference :90-92)
            qbf = eflat(qb1.contiguous())
            if static.uni_volume:     # rhs WITHOUT massinv: the face path applies it
                rhs_f, accv, accn = volume(ops, qbf, qpln_flat, accv, accn,
                                           coup_flat, **vol_kw)
            else:
                rhs_f, accv, accn = volume(ops, qbf, qplq_flat, coup_flat, accv,
                                           accn, **vol_kw)
            rhs = rhs_f.view(3, ney, nex, ngl, ngl)
            if batched:
                rhs, inc, graduv, gface_flat = _btp_faces_visc_flat(
                    static, P, g, bc, coup, flat, qb1, rhs)
                aff = aff + inc
                agf = agf + gface_flat.transpose(0, 1)
            else:
                rhs, inc_x, inc_y, graduv, gface = _btp_faces_visc(
                    static, P, g, bc, coup, qb1, qprime_df, rhs)
                afx = afx + inc_x
                afy = afy + inc_y
                agx = agx + gface.x.transpose(0, 1)
                agy = agy + gface.y.transpose(0, 1)
            agrad = agrad + graduv

            if lsrk:
                # 2N-register low-storage RK (Carpenter & Kennedy 1994):
                # dq = A_k dq + dt f(q); q += B_k dq. qb2 carries dq in its
                # thickness and momentum rows. (The reference's own LSRK
                # branch feeds these tables through its SSP update,
                # src/mod_rk_mlswe.F90:99-106, and diverges: that is
                # 'lsrk_ref', which takes the branch below.)
                dq = a[ik][0] * qb2[1:4] + static.dt_btp * rhs
                new234 = qb1[1:4] + beta[ik] * dq
                qb2 = torch.cat([torch.zeros_like(dq[:1]), dq])
            else:
                dtt = static.dt_btp * beta[ik]
                new234 = (a[ik][0] * qb0[1:4] + a[ik][1] * qb1[1:4]
                          + a[ik][2] * qb2[1:4] + dtt * rhs)
            pb = new234[0] + P.pbprime_df
            qu, qv = apply_wall_projection(new234[1], new234[2], bc)
            qb1 = torch.stack([pb, new234[0], qu, qv])
            if not lsrk and kstages == 5 and ik == 1:
                # SSP(5,3) snapshots the stage-2 state into the third register
                qb2 = qb1
        if lsrk:
            # the dq register restarts at zero every barotropic step, as in
            # the reference (A_0 = 0 already drops it from the first stage's
            # update; the reset also keeps a non-finite dq from carrying over)
            qb2 = torch.zeros_like(qb2)

    n_inv = 1.0 / (kstages * n_btp)
    vol = (accv * n_inv).view(12, ney, nex, nq, nq)
    nod = (accn * n_inv).view(3, ney, nex, ngl, ngl)
    agrad = agrad * n_inv
    if batched:
        aff, agf = aff * n_inv, agf * n_inv
        # split the flat face accumulators back to the structured view
        afx = aff[:, :Fx].reshape(16, ney, nex + 1, nq)
        afy = aff[:, Fx:].reshape(16, ney + 1, nex, nq)
        agx = agf[:, :, :Fx].reshape(2, 4, ney, nex + 1, ngl)
        agy = agf[:, :, Fx:].reshape(2, 4, ney + 1, nex, ngl)
    else:
        afx, afy, agx, agy = (acc * n_inv for acc in (afx, afy, agx, agy))
    return qb1, _averages_view(static, vol, nod, afx, afy, agx, agy, agrad)
