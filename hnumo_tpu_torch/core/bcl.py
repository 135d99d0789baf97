"""Baroclinic (layer) RHS operators.

Counterpart of hnumo_tpu/core/bcl.py, with the vertical shear-stress
solve (rhs_layer_shear_stress, ad_mlswe > 0).
Reference: src/mod_create_rhs_mlswe.F90 (volume/flux kernels), src/mod_layer_terms.F90 (face extraction, velocity
splitting/recombination, consistency faces).

Layer axis is the leading batch axis (batched by broadcasting); the only
vertical couplings are cumsums (interface pressures/heights) and vertical
sums (consistency deficits), exactly as in the reference (SURVEY.md §2.9).
No function here mutates its arguments.
"""
from __future__ import annotations

import torch

from ..ops.bcl_flux import bcl_momentum_fluxes_cuda, bcl_momentum_fluxes_plain
from ..ops.bcl_mom_volume import bcl_mom_volume_cuda, bcl_mom_volume_plain
from ..ops.dg import DeviceGeom, interp_n2q, scatter_volume
from .faces import (BCs, extract_faces, extract_faces_multi, face_n2q,
                    face_quad_scatter,
                    scatter_face_x, scatter_face_y)
from .types import BtpAverages, Pair, Precomputed
from .viscosity import bcl_nodal_laplacian, bcl_quad_laplacian


def extract_qprime_faces(bc: BCs, qprime_df):
    """Nodal face traces of (dp', u', v') with BC mirrors.

    Reference extract_qprime_df_face (src/mod_layer_terms.F90:354-415):
    dp' copies across walls, (u', v') get the free-slip/no-slip mirror.
    Returns tuple of 3 FaceLR with layer leading axis.
    """
    return tuple(extract_faces_multi(qprime_df, bc, vec_pairs=((1, 2),)))


# ---------------------------------------------------------------------------
# layer mass
# ---------------------------------------------------------------------------

def layer_mass_rhs(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                   avg: BtpAverages, qprime_df, qprime_faces):
    """Mass advection RHS per layer + layer mass-flux sums for consistency.

    Reference layer_mass_rhs = create_layers_volume_mass (+ flux)
    (src/mod_create_rhs_mlswe.F90:53-78, 822-877, 922-1034).
    Returns (dp_advec (L, nodal), slmf (2, quad), slmf_face Pair of (2, F, nq)).
    """
    qp = interp_n2q(g, qprime_df)                 # (3, L, quad); qp[0] = δdp'
    dp = (P.dpp_ref_q + qp[0]) * (1.0 + avg.mu[None])
    udp = (qp[1] + avg.ub[None]) * dp
    vdp = (qp[2] + avg.vb[None]) * dp
    slmf = torch.stack([torch.sum(udp, 0), torch.sum(vdp, 0)])

    dp_advec = scatter_volume(g, Fx=udp, Fy=vdp)  # (L, nodal)

    fdp, fu, fv = qprime_faces

    def flux_dir(dL, dR, uL, uR, vL, vR, ubL, ubR, vbL, vbR, muL, muR, fg):
        dLq, dRq = face_n2q(g.psiq, dL), face_n2q(g.psiq, dR)   # (L, F, nq)
        uLq, uRq = face_n2q(g.psiq, uL), face_n2q(g.psiq, uR)
        vLq, vRq = face_n2q(g.psiq, vL), face_n2q(g.psiq, vR)
        uu = 0.5 * ((uLq + ubL[None]) + (uRq + ubR[None]))
        vv = 0.5 * ((vLq + vbL[None]) + (vRq + vbR[None]))
        dpl = (1.0 + muL[None]) * (fg.dpp_ref_face_q + dLq)   # traces carry δdp'
        dpr = (1.0 + muR[None]) * (fg.dpp_ref_face_q + dRq)
        feu = torch.where(uu * fg.nx[None] > 0.0, uu * dpl, uu * dpr)
        fev = torch.where(vv * fg.ny[None] > 0.0, vv * dpl, vv * dpr)
        slmf_face = torch.stack([torch.sum(feu, 0), torch.sum(fev, 0)])
        S = face_quad_scatter(g.psiq, fg.jac, fg.nx[None] * feu + fg.ny[None] * fev)
        return S, slmf_face

    ax, ay = avg.faces.x, avg.faces.y
    Sx, slmf_x = flux_dir(fdp.xl, fdp.xr, fu.xl, fu.xr, fv.xl, fv.xr,
                          ax.ubL, ax.ubR, ax.vbL, ax.vbR, ax.muL, ax.muR, P.faces.x)
    Sy, slmf_y = flux_dir(fdp.yl, fdp.yr, fu.yl, fu.yr, fv.yl, fv.yr,
                          ay.ubL, ay.ubR, ay.vbL, ay.vbR, ay.muL, ay.muR, P.faces.y)
    dp_advec = scatter_face_x(dp_advec, Sx, bc)
    dp_advec = scatter_face_y(dp_advec, Sy, bc)
    dp_advec = g.massinv * dp_advec
    return dp_advec, slmf, Pair(slmf_x, slmf_y)


def apply_consistency(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                      avg: BtpAverages, q_df, slmf, slmf_face: Pair):
    """Flux-adjustment mass consistency (Higdon 2015).

    Reference apply_consistency (src/mod_splitting.F90:324-366) =
    evaluate_consistency_face (src/mod_layer_terms.F90:57-137) +
    consistency_mass_rhs (src/mod_create_rhs_mlswe.F90:80-101, 879-920,
    1036-1115). Returns updated q_df.
    """
    # one_plus_eta - 1 from δ sums (exact at reference; docs/float32.md)
    eta_t = (torch.sum(q_df[0], dim=0) + P.sum_ref_residual) * P.one_over_pbprime_df
    # δdp' = (δdp - ref·η̃)/(1+η̃)
    dpprime_df = (q_df[0] - P.dpp_ref_df * eta_t[None]) / (1.0 + eta_t)[None]

    # volume part (weight needs the FULL dp')
    dpq = P.dpp_ref_q + interp_n2q(g, dpprime_df)          # (L, quad)
    weight = dpq / P.pbprime[None]
    udp = weight * (avg.mfU - slmf[0])[None]
    vdp = weight * (avg.mfV - slmf[1])[None]
    dp_advec = scatter_volume(g, Fx=udp, Fy=vdp)

    # face part: mass_deficit_mass_face upwinded by its own sign
    fdp, _ = extract_faces(dpprime_df, bc)                 # scalar copy at walls

    def face_dir(dL, dR, slmf_f, fa, fg):
        # traces carry δdp'; the weights need the full dp'
        dLq = fg.dpp_ref_face_q + face_n2q(g.psiq, dL)          # (L, F, nq)
        dRq = fg.dpp_ref_face_q + face_n2q(g.psiq, dR)
        wL = dLq / fg.pbprime_face_L[None]
        wR = dRq / fg.pbprime_face_R[None]
        defU = (fa.fluxU - slmf_f[0])[None]
        defV = (fa.fluxV - slmf_f[1])[None]
        # deficit faces per side (reference :118-130)
        dfUL, dfUR = wL * defU, wR * defU
        dfVL, dfVR = wL * defV, wR * defV
        feu = torch.where(dfUL * fg.nx[None] > 0.0, dfUL, dfUR)
        fev = torch.where(dfVL * fg.ny[None] > 0.0, dfVL, dfVR)
        return face_quad_scatter(g.psiq, fg.jac, fg.nx[None] * feu + fg.ny[None] * fev)

    Sx = face_dir(fdp.xl, fdp.xr, slmf_face.x, avg.faces.x, P.faces.x)
    Sy = face_dir(fdp.yl, fdp.yr, slmf_face.y, avg.faces.y, P.faces.y)
    dp_advec = scatter_face_x(dp_advec, Sx, bc)
    dp_advec = scatter_face_y(dp_advec, Sy, bc)

    return torch.cat([(q_df[0] + static.dt * g.massinv * dp_advec)[None], q_df[1:]])


# ---------------------------------------------------------------------------
# layer momentum
# ---------------------------------------------------------------------------

def layer_momentum_volume(static, P: Precomputed, g: DeviceGeom,
                          avg: BtpAverages, qprime_df, q_df):
    """Layer momentum volume kernel.

    Reference create_rhs_dynamics_volume_layers
    (src/mod_create_rhs_mlswe.F90:281-456): pressure force from interface
    pressures, momentum-flux consistency weighting against the barotropic
    time averages, wind/bottom-stress vertical distribution, interface-slope
    source p*grad(z). The body is ops/bcl_mom_volume: its CUDA kernel under
    `static.impl == "kernel"`, its plain version under "plain".
    Returns rhs_mom (2, L, nodal) without massinv.
    """
    volume = bcl_mom_volume_cuda if static.impl == "kernel" else bcl_mom_volume_plain
    return volume(static, P, g, avg, qprime_df, q_df)


def layer_momentum_fluxes(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                          avg: BtpAverages, qprime_faces, rhs_mom):
    """Layer momentum face fluxes: upwind advective flux with consistency
    weighting + Higdon layer-overlap H_face reconstruction.

    Reference Apply_layers_fluxes (src/mod_create_rhs_mlswe.F90:458-820).
    The per-face work of both directions is ops/bcl_flux: its CUDA kernel
    under `static.impl == "kernel"`, its plain version under "plain";
    the scatter into the elements' edges is here.
    """
    fluxes = (bcl_momentum_fluxes_cuda if static.impl == "kernel"
              else bcl_momentum_fluxes_plain)
    (SuLx, SuRx, SvLx, SvRx), (SuLy, SuRy, SvLy, SvRy) = fluxes(
        g.psiq, P.alpha, static.gravity, qprime_faces, avg.faces, P.faces)

    rhs_u, rhs_v = rhs_mom[0], rhs_mom[1]
    rhs_u = scatter_face_x(rhs_u, SuLx, bc, S_right=SuRx)
    rhs_u = scatter_face_y(rhs_u, SuLy, bc, S_right=SuRy)
    rhs_v = scatter_face_x(rhs_v, SvLx, bc, S_right=SvRx)
    rhs_v = scatter_face_y(rhs_v, SvLy, bc, S_right=SvRy)
    return torch.stack([rhs_u, rhs_v])


def layer_momentum_rhs(static, P, g, bc, avg, coup, qprime_df, q_df, qprime_faces):
    """Full layer momentum RHS = volume + fluxes, massinv, + viscosity.

    Reference layer_momentum_rhs (src/mod_create_rhs_mlswe.F90:28-51) with
    the rhs_momentum viscosity dispatch (src/mod_splitting.F90:289-322).
    """
    if static.use_visc:
        if static.method_visc == 1:
            rhs_visc = bcl_quad_laplacian(static, P, g, bc, coup, qprime_df, avg)
        else:
            rhs_visc = bcl_nodal_laplacian(static, P, g, bc, coup, avg)
    else:
        rhs_visc = 0.0

    rhs_mom = layer_momentum_volume(static, P, g, avg, qprime_df, q_df)
    rhs_mom = layer_momentum_fluxes(static, P, g, bc, avg, qprime_faces, rhs_mom)
    # static reference terms dropped by the δ-form kernels (docs/float32.md)
    rhs_mom = rhs_mom + P.bcl_rhs_ref
    return g.massinv * rhs_mom + rhs_visc


# ---------------------------------------------------------------------------
# vertical shear stress (implicit tridiagonal solve)
# ---------------------------------------------------------------------------

def rhs_layer_shear_stress(static, P: Precomputed, g: DeviceGeom, q_df):
    """Implicit vertical shear-stress forcing via a per-column Thomas solve.

    Reference rhs_layer_shear_stress (src/mod_create_rhs_mlswe.F90:146-279),
    including its asymmetric sub/super-diagonal scaling (a=-coeff vs
    c=-gravity*dt*coeff, :210-221) which is replicated verbatim.
    Returns rhs_stress (2, L, nodal) WITHOUT massinv (applied by caller).
    """
    grav = static.gravity
    L = static.nlayers
    dp = P.dpp_ref_q + interp_n2q(g, q_df[0])   # q_df[0] carries δdp
    udp = interp_n2q(g, q_df[1])
    vdp = interp_n2q(g, q_df[2])

    a1 = P.alpha[0]
    coeff = torch.maximum(torch.sqrt(0.5 * P.coriolis_quad * static.ad_mlswe) / a1,
                          static.ad_mlswe / (a1 * static.max_shear_dz))
    coeff1 = grav * static.dt * coeff

    # tridiagonal system per quad column (Thomas over layers, unrolled)
    a = [-coeff] * L
    b = [dp[k] + 2.0 * coeff1 for k in range(L)]
    c = [-coeff1] * L
    b[0] = dp[0] + coeff1
    b[L - 1] = dp[L - 1] + coeff1
    r_u = [udp[k] / dp[k] for k in range(L)]
    r_v = [vdp[k] / dp[k] for k in range(L)]
    for k in range(1, L):
        mult = a[k] / b[k - 1]
        b[k] = b[k] - mult * c[k - 1]
        r_u[k] = r_u[k] - mult * r_u[k - 1]
        r_v[k] = r_v[k] - mult * r_v[k - 1]
    u = [None] * L
    v = [None] * L
    u[L - 1] = r_u[L - 1] / b[L - 1]
    v[L - 1] = r_v[L - 1] / b[L - 1]
    for k in range(L - 2, -1, -1):
        u[k] = (r_u[k] - c[k] * u[k + 1]) / b[k]
        v[k] = (r_v[k] - c[k] * v[k + 1]) / b[k]

    # interface stresses tau_k = coeff*(u_{k-1}-u_k); layer forcing
    # g*(tau_k - tau_{k+1}) (reference :246-259)
    zero = torch.zeros_like(dp[0])
    tau_u = [zero] + [coeff * (u[k - 1] - u[k]) for k in range(1, L)] + [zero]
    tau_v = [zero] + [coeff * (v[k - 1] - v[k]) for k in range(1, L)] + [zero]
    F_u = torch.stack([grav * (tau_u[k] - tau_u[k + 1]) for k in range(L)])
    F_v = torch.stack([grav * (tau_v[k] - tau_v[k + 1]) for k in range(L)])

    rhs_u = scatter_volume(g, Fs=F_u)
    rhs_v = scatter_volume(g, Fs=F_v)
    return torch.stack([rhs_u, rhs_v])


# ---------------------------------------------------------------------------
# velocity splitting / recombination
# ---------------------------------------------------------------------------

def extract_velocity(P, q_df, qb_df):
    """Layer velocities adjusted so their mass-weighted vertical mean equals
    the barotropic velocity (reference extract_velocity,
    src/mod_layer_terms.F90:272-320). Returns (u, v) per layer (L, nodal)."""
    dp = P.dpp_ref_df + q_df[0]
    u = q_df[1] / dp
    v = q_df[2] / dp
    ubar = torch.sum(u * dp, 0) / qb_df[0]
    vbar = torch.sum(v * dp, 0) / qb_df[0]
    ok = qb_df[0] > 0.0
    u = torch.where(ok[None], u - ubar[None] + (qb_df[2] / qb_df[0])[None], 0.0)
    v = torch.where(ok[None], v - vbar[None] + (qb_df[3] / qb_df[0])[None], 0.0)
    return u, v


def velocity_df(P, q_df, qb_df):
    """Velocity smoothing of momentum (reference velocity_df,
    src/mod_layer_terms.F90:139-196). Returns a new q_df."""
    u, v = extract_velocity(P, q_df, qb_df)
    dp = P.dpp_ref_df + q_df[0]
    return torch.stack([q_df[0], u * dp, v * dp])


def evaluate_bcl(static, P: Precomputed, bc: BCs, q_df, qprime_df, qb_df):
    """Recompute primes + momentum smoothing + face extraction after the
    predictor (reference evaluate_bcl, src/mod_layer_terms.F90:198-238).
    Returns (q_df, qprime_df, qprime_faces)."""
    u, v = extract_velocity(P, q_df, qb_df)
    dp = P.dpp_ref_df + q_df[0]
    q_df = torch.stack([q_df[0], u * dp, v * dp])
    eta_t = (torch.sum(q_df[0], 0) + P.sum_ref_residual) * P.one_over_pbprime_df
    u, v = extract_velocity(P, q_df, qb_df)
    qprime_df = torch.stack([
        (q_df[0] - P.dpp_ref_df * eta_t[None]) / (1.0 + eta_t)[None],
        u - (qb_df[2] / qb_df[0])[None],
        v - (qb_df[3] / qb_df[0])[None],
    ])
    qprime_faces = extract_qprime_faces(bc, qprime_df)
    return q_df, qprime_df, qprime_faces


def evaluate_bcl_v1(P, q_df, qprime_df, qb_df):
    """Corrector variant: update velocities/primes only, thickness prime kept
    (reference evaluate_bcl_v1, src/mod_layer_terms.F90:240-270)."""
    u, v = extract_velocity(P, q_df, qb_df)
    dp = P.dpp_ref_df + q_df[0]
    q_df = torch.stack([q_df[0], u * dp, v * dp])
    u, v = extract_velocity(P, q_df, qb_df)
    qprime_df = torch.stack([qprime_df[0],
                             u - (qb_df[2] / qb_df[0])[None],
                             v - (qb_df[3] / qb_df[0])[None]])
    return q_df, qprime_df
