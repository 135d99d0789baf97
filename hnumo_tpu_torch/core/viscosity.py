"""Horizontal viscosity: LDG Laplacians, nodal and quad families.

Counterpart of hnumo_tpu/core/viscosity.py (reference
src/mod_laplacian_quad.F90). Two families x two levels:
  - nodal family (method_visc != 1): the barotropic Laplacian lives in
    core/btp (btp_nodal_laplacian, and its flat-axis form) beside the face
    pipelines it shares; bcl_create_laplacian (:227-248) here, integrating
    on the nodal grid and using the barotropic-average LDG gradients
    (graduvb_ave).
  - quad family (method_visc == 1): btp_create_laplacian_v2 (:125-223) +
    bcl_create_laplacian_v2 (:252-355), integrating on the over-integration
    grid with dp'-weighted velocity gradients.
The face flux is the Cockburn-Shu "flip-flop" with beta=0.5 (central); the
scalarized flux formula (q_mean1 - q_L1*nx) + (q_mean2 - q_L2*ny) is
replicated literally from the reference (:485-486, :690-691).
"""
from __future__ import annotations

import torch

from ..ops.bcl_visc import bcl_visc_cuda, bcl_visc_plain
from ..ops.dg import DeviceGeom, grad_n2q, scatter_volume
from .faces import BCs, apply_face_plus_minus, extract_faces_stacked, face_quad_scatter
from .types import CouplingFields, Pair, Precomputed


def _flipflop_face_quad(static, P: Precomputed, g: DeviceGeom, bc: BCs, fl_x, fr_x, fl_y, fr_y):
    """Face contribution at quad resolution for a 4-component LDG flux field.

    fl_*/fr_*: (4, ..., F, nq) one-sided flux values per direction.
    Returns per-direction scatter values (Su, Sv) to apply with sign +L/-R.
    Reference create_rhs_laplacian_flux_quad (src/mod_laplacian_quad.F90:644-722).
    """
    def one_dir(fl, fr, fg):
        qmean = 0.5 * (fl + fr)
        flux_qu = (qmean[0] - fl[0] * fg.nx) + (qmean[1] - fl[1] * fg.ny)
        flux_qv = (qmean[2] - fl[2] * fg.nx) + (qmean[3] - fl[3] * fg.ny)
        Su = face_quad_scatter(g.psiq, fg.jac, flux_qu)
        Sv = face_quad_scatter(g.psiq, fg.jac, flux_qv)
        return Su, Sv

    SxU, SxV = one_dir(fl_x, fr_x, P.faces.x)
    SyU, SyV = one_dir(fl_y, fr_y, P.faces.y)
    return SxU, SxV, SyU, SyV


def _quad_flux_faces(flux_q, bc: BCs):
    """Face traces of a (4, ..., quad) LDG flux field at quad resolution with
    the free-slip mirror applied pairwise ((1,2) and (3,4) as vectors).
    Reference src/mod_laplacian_quad.F90:158-211."""
    return extract_faces_stacked(flux_q, bc, vec_pairs=((0, 1), (2, 3)))


def _quad_laplacian(static, P: Precomputed, g: DeviceGeom, bc: BCs, flux_q):
    """-div of the LDG flux field flux_q (4, ..., quad) in weak form, volume
    and faces, times visc_mlswe * massinv: the part both quad-family
    Laplacians share."""
    fl_x, fr_x, fl_y, fr_y = _quad_flux_faces(flux_q, bc)
    rhs_u = -scatter_volume(g, Fx=flux_q[0], Fy=flux_q[1])
    rhs_v = -scatter_volume(g, Fx=flux_q[2], Fy=flux_q[3])
    S = _flipflop_face_quad(static, P, g, bc, fl_x, fr_x, fl_y, fr_y)
    rhs_u, rhs_v = apply_face_plus_minus(rhs_u, rhs_v, *S, bc)
    return static.visc_mlswe * g.massinv * torch.stack([rhs_u, rhs_v])


def btp_quad_laplacian(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                       coup: CouplingFields, qb_df, qprime_df):
    """Quad-family barotropic viscosity (method_visc == 1).

    Reference btp_create_laplacian_v2 (src/mod_laplacian_quad.F90:125-223).
    Returns (rhs_lap (2, nodal), graduv, gface) like the nodal family; the
    last two are zeros.
    """
    ub = qb_df[2] / qb_df[0]
    vb = qb_df[3] / qb_df[0]
    Uu = qprime_df[1] + ub[None]     # (L, nodal)
    Uv = qprime_df[2] + vb[None]
    gux, guy = grad_n2q(g, Uu)       # (L, quad)
    gvx, gvy = grad_n2q(g, Uv)
    w = coup.dpprime_visc_q
    flux_q = torch.stack([torch.sum(w * gux, 0), torch.sum(w * guy, 0),
                          torch.sum(w * gvx, 0), torch.sum(w * gvy, 0)])
    rhs_lap = _quad_laplacian(static, P, g, bc, flux_q)
    # the quad family does not feed the graduvb averages (reference only
    # accumulates them in the nodal family, src/mod_laplacian_quad.F90:54,112)
    opts = dict(dtype=qb_df.dtype, device=qb_df.device)
    graduv = torch.zeros((4,) + qb_df.shape[1:], **opts)
    gface = Pair(torch.zeros((4, 2) + P.faces.x.jac_df.shape, **opts),
                 torch.zeros((4, 2) + P.faces.y.jac_df.shape, **opts))
    return rhs_lap, graduv, gface


def bcl_quad_laplacian(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                       coup: CouplingFields, qprime_df, avg):
    """Quad-family baroclinic viscosity (method_visc == 1).

    Reference bcl_create_laplacian_v2 (src/mod_laplacian_quad.F90:252-355).
    Returns rhs_lap (2, L, nodal).
    """
    Uu = qprime_df[1] + avg.ub_df[None]
    Uv = qprime_df[2] + avg.vb_df[None]
    gux, guy = grad_n2q(g, Uu)
    gvx, gvy = grad_n2q(g, Uv)
    w = coup.dpprime_visc_q
    flux_q = torch.stack([w * gux, w * guy, w * gvx, w * gvy])  # (4, L, quad)
    return _quad_laplacian(static, P, g, bc, flux_q)


def bcl_nodal_laplacian(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                        coup: CouplingFields, avg):
    """Nodal-family baroclinic viscosity (method_visc != 1).

    Reference bcl_create_laplacian + bcl_compute_laplacian +
    bcl_create_rhs_laplacian_flux (src/mod_laplacian_quad.F90:227-248,
    392-425, 521-611). Consumes the barotropic-average LDG gradients.
    The body is ops/bcl_visc: its CUDA kernel under
    `static.flux_impl == "kernel"`, its plain version under "plain".
    Returns rhs_lap (2, L, nodal).
    """
    visc = bcl_visc_cuda if static.flux_impl == "kernel" else bcl_visc_plain
    return visc(static, P, g, bc, coup, avg)
