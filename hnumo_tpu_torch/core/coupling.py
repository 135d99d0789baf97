"""Barotropic<->baroclinic coupling coefficient fields.

Counterpart of hnumo_tpu/core/coupling.py.
Reference: btp_bcl_coeffs_qdf (src/mod_barotropic_terms.F90:219-409).
Computed twice per baroclinic dt (predictor and corrector) and consumed by
every barotropic substep. The body is ops/bcl_coeffs (two CUDA kernels and
their plain version, in which all layer loops become vectorized cumsums /
reductions over the leading layer axis); the δ-form layer pressure stays
here.
"""
from __future__ import annotations

import torch

from ..ops import bcl_coeffs
from ..ops.dg import DeviceGeom
from .faces import BCs
from .types import CouplingFields, Precomputed


def delta_pressure_H(ddpp, P_ref, alpha):
    """δ-form layer pressure force (docs/float32.md).

    ddpp = dp' - dp'_ref (L, ...); P_ref = reference interface pressures
    (L+1, ...). Returns (pi_lower (L, ...), dH (L, ...)) with
    pi = p - P_ref (conditioned cumsum) and
    dH_k = H_k - H_ref_k = alpha_k*(Pl*pi_l - Pu*pi_u + (pi_l^2-pi_u^2)/2),
    exactly equal (in exact arithmetic) to the reference's
    H_k = 0.5*alpha_k*(p_lower^2 - p_upper^2) minus its static part.
    """
    pi_lower = torch.cumsum(ddpp, dim=0)
    pi_upper = pi_lower - ddpp
    al = alpha.reshape((-1,) + (1,) * (ddpp.ndim - 1))
    dH = al * (P_ref[1:] * pi_lower - P_ref[:-1] * pi_upper
               + 0.5 * (pi_lower**2 - pi_upper**2))
    return pi_lower, dH


def btp_bcl_coeffs(static, P: Precomputed, g: DeviceGeom, bc: BCs, qprime_df, qprime_faces,
                   dpprime_visc, dpprime_visc_q) -> CouplingFields:
    """The coupling coefficients of one baroclinic half-step. The body is
    ops/bcl_coeffs: its CUDA kernels under `static.impl == "kernel"`, its
    plain version under "plain". Operands: qprime_df (3, L, nodal) of (δdp',
    u', v'); qprime_faces, its nodal face traces (a tuple of 3 FaceLR of (L,
    F, ngl)); dpprime_visc (L, nodal), the viscosity's layer weight;
    dpprime_visc_q (L, quad), its quad-resolution copy or zeros, passed
    through."""
    coeffs = (bcl_coeffs.bcl_coeffs_cuda if static.impl == "kernel"
              else bcl_coeffs.bcl_coeffs_plain)
    return coeffs(static, P, g, bc, qprime_df, qprime_faces, dpprime_visc, dpprime_visc_q)
