"""Horizontal viscosity: nodal-family LDG Laplacian of the layers.

Counterpart of hnumo_tpu/core/viscosity.py, nodal family only
(method_visc != 1; reference src/mod_laplacian_quad.F90:227-248): it
integrates on the nodal grid and uses the barotropic-average LDG gradients
(graduvb_ave). The quad family (method_visc == 1) is not ported yet.
The face flux is the Cockburn-Shu "flip-flop" with beta=0.5 (central); the
scalarized flux formula (q_mean1 - q_L1*nx) + (q_mean2 - q_L2*ny) is
replicated literally from the reference (:485-486, :690-691).
"""
from __future__ import annotations

import torch

from ..ops.dg import DeviceGeom, scatter_volume_nodal
from .faces import BCs, scatter_face_x, scatter_face_y
from .types import CouplingFields, Precomputed


def _apply_face_plus_minus(rhs_u, rhs_v, SxU, SxV, SyU, SyV, bc: BCs):
    """LDG face signs: L side +, R side - (reference :704-716)."""
    rhs_u = scatter_face_x(rhs_u, -SxU, bc)
    rhs_u = scatter_face_y(rhs_u, -SyU, bc)
    rhs_v = scatter_face_x(rhs_v, -SxV, bc)
    rhs_v = scatter_face_y(rhs_v, -SyV, bc)
    return rhs_u, rhs_v


def bcl_nodal_laplacian(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                        coup: CouplingFields, avg):
    """Nodal-family baroclinic viscosity (method_visc != 1).

    Reference bcl_create_laplacian + bcl_compute_laplacian +
    bcl_create_rhs_laplacian_flux (src/mod_laplacian_quad.F90:227-248,
    392-425, 521-611). Consumes the barotropic-average LDG gradients.
    Returns rhs_lap (2, L, nodal).
    """
    # volume: qq = dpprime_visc_k * graduvb_ave + dpp_graduv_k   (4, L, nodal)
    qq = coup.dpprime_visc[None] * avg.graduvb[:, None] + coup.dpp_graduv
    rhs_u = -scatter_volume_nodal(g, qq[0], qq[1])
    rhs_v = -scatter_volume_nodal(g, qq[2], qq[3])

    def face_dir(gdpp, gvavg, fg):
        # gdpp: (5, 2, L, F, ngl) layer coefficient faces;
        # gvavg L/R: (4, F, ngl) graduvb_face_ave
        fl = gdpp[4, 0] * gvavg[0][:, None] + gdpp[:4, 0]   # (4, L, F, ngl)
        fr = gdpp[4, 1] * gvavg[1][:, None] + gdpp[:4, 1]
        qmean = 0.5 * (fl + fr)
        flux_qu = (qmean[0] - fl[0] * fg.nx_df) + (qmean[1] - fl[1] * fg.ny_df)
        flux_qv = (qmean[2] - fl[2] * fg.nx_df) + (qmean[3] - fl[3] * fg.ny_df)
        return fg.jac_df * flux_qu, fg.jac_df * flux_qv

    SxU, SxV = face_dir(coup.graduv_dpp_face.x, (avg.faces.x.gvL, avg.faces.x.gvR), P.faces.x)
    SyU, SyV = face_dir(coup.graduv_dpp_face.y, (avg.faces.y.gvL, avg.faces.y.gvR), P.faces.y)
    rhs_u, rhs_v = _apply_face_plus_minus(rhs_u, rhs_v, SxU, SxV, SyU, SyV, bc)
    return static.visc_mlswe * g.massinv * torch.stack([rhs_u, rhs_v])
