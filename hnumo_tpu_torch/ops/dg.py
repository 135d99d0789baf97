"""Core DG tensor-product operators, as torch.einsum contractions.

Counterpart of hnumo_tpu/ops/dg.py (none of these is inside a Pallas
kernel there): every operation is a pair of small dense contractions
batched over all elements (and layers/variables).

Field layouts (see hnumo_tpu_torch.mesh.grid):
  nodal (..., nely, nelx, ngl_j, ngl_i), quad (..., nely, nelx, nq_j, nq_i).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor


class DeviceGeom(NamedTuple):
    """Geometry tables as tensors of the compute dtype on the stepping device."""

    psiq: Tensor      # (ngl, nq)
    dpsiq: Tensor     # (ngl, nq)
    dpsi: Tensor      # (ngl, ngl)
    ksiq_x: Tensor    # (nely, nelx, nq, nq)
    ksiq_y: Tensor
    etaq_x: Tensor
    etaq_y: Tensor
    wjac: Tensor
    ksi_x: Tensor     # (nely, nelx, ngl, ngl)
    ksi_y: Tensor
    eta_x: Tensor
    eta_y: Tensor
    wjac_df: Tensor
    massinv: Tensor
    jac_facex: Tensor   # (nely, nelx+1, nq)
    nx_x: Tensor
    ny_x: Tensor
    jac_facey: Tensor   # (nely+1, nelx, nq)
    nx_y: Tensor
    ny_y: Tensor
    jac_facex_df: Tensor
    jac_facey_df: Tensor
    nx_x_df: Tensor
    ny_x_df: Tensor
    nx_y_df: Tensor
    ny_y_df: Tensor


def device_geom(geom, dtype: torch.dtype, device) -> DeviceGeom:
    """Cast host Geometry tables (float64 NumPy) to contiguous tensors on
    `device` (a host table may be a strided view; the kernels take only
    contiguous operands)."""
    return DeviceGeom(**{
        name: torch.tensor(np.ascontiguousarray(getattr(geom, name)),
                           dtype=dtype, device=device)
        for name in DeviceGeom._fields})


# ---------------------------------------------------------------------------
# volume operators
# ---------------------------------------------------------------------------

def interp_n2q(g: DeviceGeom, u: Tensor) -> Tensor:
    """Interpolate nodal field to over-integration quad points.

    (..., ngl, ngl) -> (..., nq, nq). Reference: psih gather,
    src/Tensor_product.F90:71 applied in every volume kernel.
    """
    return torch.einsum("...ji,jJ,iI->...JI", u, g.psiq, g.psiq)


def grad_n2q(g: DeviceGeom, u: Tensor):
    """Physical-space gradient of a nodal field, evaluated at quad points.

    Returns (du/dx, du/dy), each (..., nq, nq).
    Reference: dpsidx/dpsidy tables, src/Tensor_product.F90:74-81.
    """
    d_ksi = torch.einsum("...ji,jJ,iI->...JI", u, g.psiq, g.dpsiq)
    d_eta = torch.einsum("...ji,jJ,iI->...JI", u, g.dpsiq, g.psiq)
    ux = d_ksi * g.ksiq_x + d_eta * g.etaq_x
    uy = d_ksi * g.ksiq_y + d_eta * g.etaq_y
    return ux, uy


def grad_nodal(g: DeviceGeom, u: Tensor):
    """Gradient of a nodal field at the nodal points themselves.

    Reference: compute_gradient_uv / dpsidx_df tables
    (src/mod_barotropic_terms.F90:411-443, src/Tensor_product.F90:89-124).
    """
    d_ksi = torch.einsum("...ji,iI->...jI", u, g.dpsi)
    d_eta = torch.einsum("...ji,jJ->...Ji", u, g.dpsi)
    ux = d_ksi * g.ksi_x + d_eta * g.eta_x
    uy = d_ksi * g.ksi_y + d_eta * g.eta_y
    return ux, uy


def scatter_volume(g: DeviceGeom, Fx=None, Fy=None, Fs=None) -> Tensor:
    """Weak-form volume integral: rhs_I = sum_q w_q (dpsi_I/dx Fx + dpsi_I/dy Fy + psi_I Fs).

    Any of Fx/Fy/Fs (quad fields) may be None. Returns a nodal field WITHOUT
    the inverse mass applied (matches reference volume kernels, e.g.
    src/mod_rhs_btp.F90:194-206).
    """
    out = None
    if Fx is not None or Fy is not None:
        fx = Fx if Fx is not None else 0.0
        fy = Fy if Fy is not None else 0.0
        a_ksi = g.wjac * (fx * g.ksiq_x + fy * g.ksiq_y)
        a_eta = g.wjac * (fx * g.etaq_x + fy * g.etaq_y)
        out = torch.einsum("...JI,jJ,iI->...ji", a_ksi, g.psiq, g.dpsiq)
        out = out + torch.einsum("...JI,jJ,iI->...ji", a_eta, g.dpsiq, g.psiq)
    if Fs is not None:
        s = torch.einsum("...JI,jJ,iI->...ji", g.wjac * Fs, g.psiq, g.psiq)
        out = s if out is None else out + s
    return out


def scatter_volume_nodal(g: DeviceGeom, Fx: Tensor, Fy: Tensor) -> Tensor:
    """Weak-form volume integral evaluated with the NODAL quadrature.

    rhs_I = sum_n w_n (dpsi_I/dx(x_n) Fx_n + dpsi_I/dy(x_n) Fy_n), used by the
    nodal-family LDG viscosity (reference btp_compute_laplacian,
    src/mod_laplacian_quad.F90:357-425, which integrates with wjac_df and the
    dpsidx_df tables).
    """
    a_ksi = g.wjac_df * (Fx * g.ksi_x + Fy * g.ksi_y)
    a_eta = g.wjac_df * (Fx * g.eta_x + Fy * g.eta_y)
    out = torch.einsum("...jI,iI->...ji", a_ksi, g.dpsi)
    out = out + torch.einsum("...Ji,jJ->...ji", a_eta, g.dpsi)
    return out


def project_q2n(g: DeviceGeom, f: Tensor) -> Tensor:
    """L2-project a quad field back to nodal dofs (with inverse lumped mass).

    Reference: interpolate_layer_from_quad_to_node_1d
    (src/mod_Tensorproduct.F90:166-215).
    """
    return g.massinv * torch.einsum("...JI,jJ,iI->...ji", g.wjac * f, g.psiq, g.psiq)
