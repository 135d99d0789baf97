"""NamedTuples of tensors: model state, precomputed tables, time averages.

Field for field the containers of hnumo_tpu/core/types.py, holding
torch.Tensor in place of the arrays of that package.
Shapes use the element-major layout of hnumo_tpu_torch.mesh.grid:
  nodal (ney, nex, ngl, ngl); quad (ney, nex, nq, nq)
  x-faces (ney, nex+1, n); y-faces (ney+1, nex, n)
Replaces the reference's ~60 module-level work arrays
(src/mod_variables.F90:51-107) with explicit functional state.
"""
from __future__ import annotations

from typing import NamedTuple

from torch import Tensor


class State(NamedTuple):
    """Prognostic model state (reference src/ti_rk_bcl.F90:11-17).

    PERTURBATION STORAGE of the thickness channels (docs/float32.md):
      q_df[0]      stores δΔp  = Δp  - Δp_ref   (Δp_ref = Precomputed.dpp_ref_df)
      qprime_df[0] stores δΔp' = Δp' - Δp_ref
    so that the f32 thickness signal is carried at full precision and the
    δ-form pressure kernels receive exact perturbations. Momentum channels
    and the barotropic pb (qb_df[0]) remain full variables; qb_df[1] is
    already the perturbation pb - pbprime by the reference's own design.
    """

    qb_df: Tensor      # (4, nodal): pb, pb'=pb-pbprime, pb*ub, pb*vb
    q_df: Tensor       # (3, nlayers, nodal): δdp, u*dp, v*dp
    qprime_df: Tensor  # (3, nlayers, nodal): δdp', u', v'
    t: Tensor          # model time (scalar)
    ok: Tensor         # bool: False once negative thickness detected


class Pair(NamedTuple):
    """Per-direction (x-faces, y-faces) pair of tensors or NamedTuples."""

    x: object
    y: object


class FaceDirGeom(NamedTuple):
    """Static per-direction face tables (tensors on the stepping device).

    Includes the linearized-Riemann wave-speed coefficient tables
    (reference compute_reference_edge_variables,
    src/mod_initial_mlswe.F90:355-401) and reference-state face values.
    """

    nx: Tensor            # (F, nq) outward-from-L normal
    ny: Tensor
    jac: Tensor           # (F, nq) w * surface jacobian
    nx_df: Tensor         # (F, ngl)
    ny_df: Tensor
    jac_df: Tensor
    coeff_pbpert_L: Tensor    # (F, nq)
    coeff_pbpert_R: Tensor
    coeff_pbub_LR: Tensor
    coeff_mass_pbub_L: Tensor
    coeff_mass_pbub_R: Tensor
    coeff_mass_pbpert_LR: Tensor
    pbprime_face_L: Tensor    # (F, nq) reference pb' one-sided values
    pbprime_face_R: Tensor
    one_over_pbprime_edge: Tensor  # (F, nq) = 1/pbprime_face_L
    pbprime_df_face_L: Tensor  # (F, ngl)
    pbprime_df_face_R: Tensor
    zbot_face_L: Tensor       # (F, nq)
    zbot_face_R: Tensor
    wall4: Tensor             # (F, 1) 1.0 on free-slip wall faces else 0.0
    # --- static reference-state (rest) tables for the f32 δ-formulation
    # (docs/float32.md); ref traces are continuous across faces, one table
    # serves both sides ---
    dpp_ref_face: Tensor      # (L, F, ngl) ref dp' nodal face trace
    dpp_ref_face_q: Tensor    # (L, F, nq)  = face_n2q of the above
    P_ref_edge: Tensor        # (L+1, F, nq) ref interface pressures
    Hk_ref_edge: Tensor       # (L, F, nq) ref per-layer hydrostatic H
    Hedge_ref: Tensor         # (F, nq) = sum_k Hk_ref_edge
    z_ref_face: Tensor        # (L+1, F, nq) ref interface elevations


class Precomputed(NamedTuple):
    """Static reference-state tables built at init (tensors on the stepping device).

    Mirrors mod_initial's MLSWE block (src/mod_initial.F90:42-51,128-182).
    """

    alpha: Tensor            # (nlayers,) reciprocal layer densities
    pbprime: Tensor          # quad
    pbprime_df: Tensor       # nodal
    one_over_pbprime: Tensor
    one_over_pbprime_df: Tensor
    zbot_df: Tensor
    zbot_quad: Tensor
    grad_zbot_quad: Tensor   # (2, quad)
    tau_wind: Tensor         # (2, quad)
    tau_wind_df: Tensor      # (2, nodal)
    coriolis_quad: Tensor
    coriolis_df: Tensor
    fdt2_bcl: Tensor         # 0.5*f*dt (nodal)
    a_bcl: Tensor            # semi-implicit Coriolis coefficients
    b_bcl: Tensor
    ssprk_a: Tensor          # (kstages, 3)
    ssprk_beta: Tensor       # (kstages,)
    # --- static reference-state (rest) tables, f32 δ-formulation
    # (docs/float32.md) ---
    dpp_ref_df: Tensor       # (L, nodal) ref dp'
    dpp_ref_q: Tensor        # (L, quad)
    sum_ref_residual: Tensor  # (nodal) sum_k dpp_ref_df - pbprime_df (fp)
    P_ref_q: Tensor          # (L+1, quad) ref interface pressures
    Hk_ref_q: Tensor         # (L, quad) ref per-layer H
    H_bcl_ref: Tensor        # (quad) = sum_k Hk_ref_q
    z_ref_df: Tensor         # (L+1, nodal) ref interface elevations
    gz_ref: Tensor           # (2, L+1, quad) ref interface gradients
    btp_rhs_ref: Tensor      # (3, nodal) static barotropic RHS vector
    bcl_rhs_ref: Tensor      # (2, L, nodal) static layer-momentum vector
    faces: Pair                   # Pair of FaceDirGeom


class BtpFaceAvg(NamedTuple):
    """Per-direction face time-average accumulators over barotropic substeps.

    All (F, nq). Reference src/mod_rk_mlswe.F90:45-78 and
    src/mod_rhs_btp.F90:296-318.

    PERTURBATION STORAGE (f32-safety; see docs/float32.md): quantities whose
    reference magnitude dwarfs their dynamic signal are stored as
    perturbations from the static reference state:
      dH   = H_face - H_face_ref          (vs reference H_face_ave)
      muL  = ope_L - 1, muR = ope_R - 1   (vs one_plus_eta_edge_ave L/R)
      mu2L = ope_L^2 - 1, mu2R            (vs ..._2_ave)
      mue2 = ope_edge^2 - 1               (vs one_plus_eta_edge_2_ave)
    Reconstruction (ope = 1 + mu, H = H_ref + dH) is exact in exact
    arithmetic, so f64 results are unchanged.
    """

    dH: Tensor
    QuU: Tensor   # Qu_face_ave(1) = quu
    QuV: Tensor   # Qu_face_ave(2) = quv
    QvU: Tensor   # Qv_face_ave(1) = qvu
    QvV: Tensor   # Qv_face_ave(2) = qvv
    muL: Tensor
    muR: Tensor
    mu2L: Tensor
    mu2R: Tensor
    fluxU: Tensor  # btp_mass_flux_face_ave(1)
    fluxV: Tensor
    mue2: Tensor
    ubL: Tensor
    ubR: Tensor
    vbL: Tensor
    vbR: Tensor
    gvL: Tensor    # graduvb_face_ave L (4, F, ngl) - nodal resolution
    gvR: Tensor


class BtpAverages(NamedTuple):
    """All barotropic time averages consumed by the baroclinic step.

    Perturbation storage (see BtpFaceAvg): dH = H - H_bcl_ref (quad),
    mu = ope - 1, mu2 = ope^2 - 1, mu2_df = ope_df^2 - 1.
    """

    dH: Tensor      # quad
    Qu: Tensor
    Qv: Tensor
    Quv: Tensor
    mu: Tensor
    mu2: Tensor
    ub: Tensor      # uvb_ave(1)
    vb: Tensor
    mfU: Tensor     # btp_mass_flux_ave
    mfV: Tensor
    tbU: Tensor     # tau_bot_ave
    tbV: Tensor
    mu2_df: Tensor  # nodal
    ub_df: Tensor
    vb_df: Tensor
    graduvb: Tensor  # (4, nodal) graduvb_ave (LDG aux for viscosity)
    faces: Pair           # Pair of BtpFaceAvg


class CouplingFields(NamedTuple):
    """Baroclinic coefficient fields consumed by barotropic substeps.

    Reference btp_bcl_coeffs_qdf (src/mod_barotropic_terms.F90:219-409).
    """

    Q_uu_dp: Tensor   # quad
    Q_uv_dp: Tensor
    Q_vv_dp: Tensor
    dH_bcl: Tensor    # H_bcl - H_bcl_ref (δ-form, docs/float32.md)
    Q_uu_dp_edge: Pair     # (F, nq) per direction
    Q_uv_dp_edge: Pair
    Q_vv_dp_edge: Pair
    dH_bcl_edge: Pair      # H_bcl_edge - Hedge_ref
    # viscosity coefficient fields (nodal-family LDG)
    dpp_graduv: Tensor       # (4, nlayers, nodal)
    btp_dpp_graduv: Tensor   # (4, nodal)
    pbprime_visc: Tensor     # (nodal)
    dpprime_visc: Tensor     # (nlayers, nodal)
    dpprime_visc_q: Tensor   # (nlayers, quad) [method_visc==1 family]
    graduv_dpp_face: Pair         # (5, 2=L/R, nlayers, F, ngl)
    btp_graduv_dpp_face: Pair     # (5, 2, F, ngl)
