"""Baroclinic (layer) RHS operators.

Counterpart of hnumo_tpu/core/bcl.py; the vertical shear-stress solve
(rhs_layer_shear_stress, ad_mlswe > 0) is not ported yet.
Reference: src/mod_create_rhs_mlswe.F90 (volume/flux kernels), src/mod_layer_terms.F90 (face extraction, velocity
splitting/recombination, consistency faces).

Layer axis is the leading batch axis (batched by broadcasting); the only
vertical couplings are cumsums (interface pressures/heights) and vertical
sums (consistency deficits), exactly as in the reference (SURVEY.md §2.9).
No function here mutates its arguments.
"""
from __future__ import annotations

import torch

from ..ops.dg import DeviceGeom, grad_n2q, interp_n2q, scatter_volume
from .faces import (BCs, extract_faces, extract_faces_multi, face_n2q,
                    face_quad_scatter,
                    scatter_face_x, scatter_face_y)
from .types import BtpAverages, Pair, Precomputed
from .viscosity import bcl_nodal_laplacian

_EPS1 = 1.0e-20  # reference eps1, prevents division by zero (:309)


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
    source p*grad(z). Returns rhs_mom (2, L, nodal) without massinv.

    Note: the reference's wind/bottom-stress distribution accumulates
    `pprime_temp(k+1)=pprime_temp(k)+qp(k)` where `qp` holds the LAST
    layer's (dp',u',v') 3-vector (:380-382) — an indexing slip that is
    inert for all shipped gated cases (zero wind/bottom stress there). We
    implement the documented intent: cumulative prime pressure
    pprime_temp = cumsum_k dp'_k.
    """
    grav = static.gravity
    alpha = P.alpha
    L = static.nlayers
    al = alpha.reshape((L,) + (1,) * (qprime_df.ndim - 2))

    # ---- δ-form (docs/float32.md): interface-elevation perturbation ζ ----
    # sq_ope_df - 1 in conditioned form; sq_ope_df = sqrt(ope_df^2)
    s_df = avg.mu2_df / (1.0 + torch.sqrt(1.0 + avg.mu2_df))
    sq_ope_df = 1.0 + s_df
    ddpp_df = qprime_df[0]                                  # stored as δdp'
    # δdz = (α/g)(sq_ope·dp' - dp'_ref), conditioned; ζ[L] = 0 (static zbot)
    ddz = (al / grav) * (s_df[None] * P.dpp_ref_df + sq_ope_df[None] * ddpp_df)
    rev = torch.flip(torch.cumsum(torch.flip(ddz, (0,)), dim=0), (0,))
    zeta = torch.cat([rev, torch.zeros_like(rev[:1])], dim=0)  # (L+1, nodal)
    gze_x, gze_y = grad_n2q(g, zeta)                        # ζ gradients (L+1, quad)
    gz_x = P.gz_ref[0] + gze_x                              # full interface gradients
    gz_y = P.gz_ref[1] + gze_y

    qp = interp_n2q(g, qprime_df)                           # (3, L, quad)
    udp_q = interp_n2q(g, q_df[1])                          # (L, quad)
    vdp_q = interp_n2q(g, q_df[2])
    temp_uu = torch.abs(udp_q) + _EPS1
    temp_vv = torch.abs(vdp_q) + _EPS1

    # π = p_tmp - P_ref, conditioned cumsum (p_tmp = cumsum sq_ope*dp')
    s_q = avg.mu2 / (1.0 + torch.sqrt(1.0 + avg.mu2))
    sq_ope = 1.0 + s_q
    ddpp_q = qp[0]                                          # δ at quad
    dinc = s_q[None] * P.dpp_ref_q + sq_ope[None] * ddpp_q
    pi_l = torch.cumsum(dinc, dim=0)
    pi_u = pi_l - dinc
    alq = alpha.reshape((L,) + (1,) * (pi_l.ndim - 1))
    dH_tmp = alq * (P.P_ref_q[1:] * pi_l - P.P_ref_q[:-1] * pi_u
                    + 0.5 * (pi_l**2 - pi_u**2))            # H_tmp - Hk_ref

    dp = (P.dpp_ref_q + qp[0]) * (1.0 + avg.mu[None])
    u = qp[1] + avg.ub[None]
    v = qp[2] + avg.vb[None]
    u_udp = dp * u * u
    v_vdp = dp * v * v
    uv_dp = dp * u * v

    # momentum-flux consistency weighting (reference :370-390)
    uu_def = avg.Qu - torch.sum(u_udp, 0)
    uv_def = avg.Quv - torch.sum(uv_dp, 0)
    vv_def = avg.Qv - torch.sum(v_vdp, 0)
    wu = temp_uu / torch.sum(temp_uu, 0)[None]
    wv = temp_vv / torch.sum(temp_vv, 0)[None]
    var_uu = u_udp + wu * uu_def[None]
    var_uv = uv_dp + wu * uv_def[None]     # u_vdp(1,:)
    var_vu = uv_dp + wv * uv_def[None]     # u_vdp(2,:)
    var_vv = v_vdp + wv * vv_def[None]

    # pressure-force weight (reference :412-417): weight-1 in δ-form
    sum_dH = torch.sum(dH_tmp, 0)
    sumH_full = P.H_bcl_ref + sum_dH
    w1 = torch.where(sumH_full > 0.0, (avg.dH - sum_dH) / sumH_full, 0.0)
    # Hq - Hk_ref = dH_tmp + (Hk_ref + dH_tmp)*(weight-1)
    dHq = dH_tmp + (P.Hk_ref_q + dH_tmp) * w1[None]

    # wind/bottom stress vertical distribution (reference :424-431)
    dpp_full = P.dpp_ref_q + qp[0]
    if static.compat_reference_stress:
        # verbatim reference slip (src/mod_create_rhs_mlswe.F90:380-382):
        # pprime_temp(k+1) = pprime_temp(k) + qp(k) where qp still holds the
        # LAST layer's (dp', u', v') 3-vector from the preceding loop, so the
        # k-th increment is component k of (dp'_L, u'_L, v'_L) — full dp'
        # for k=1, the raw velocity primes for k=2,3 (L<=3 enforced at init)
        comps = torch.stack([dpp_full[-1]] + [qp[c][-1] for c in (1, 2)][:L - 1])
        pp_lower = torch.cumsum(comps[:L], dim=0)
        pp_upper = pp_lower - comps[:L]
    else:
        # documented intent: cumulative prime pressure sum_j<=k dp'_j
        pp_lower = torch.cumsum(dpp_full, dim=0)
        pp_upper = pp_lower - dpp_full
    Ps, Pb = static.Pstress, static.Pbstress
    temp1 = (torch.clamp(pp_lower, max=Ps) - torch.clamp(pp_upper, max=Ps)) / Ps
    tau_u = temp1 * P.tau_wind[0][None]
    tau_v = temp1 * P.tau_wind[1][None]
    tempbot = (torch.clamp(P.pbprime[None] - pp_lower, max=Pb)
               - torch.clamp(P.pbprime[None] - pp_upper, max=Pb)) / Pb

    # interface-slope source, dynamic part only (static P_ref·gz_ref in
    # P.bcl_rhs_ref):  p·gz - P_ref·gz_ref = P_ref·gζ + π·gz
    source_x = grav * (tau_u - tempbot * avg.tbU[None]
                       + P.P_ref_q[:-1] * gze_x[:-1] + pi_u * gz_x[:-1]
                       - P.P_ref_q[1:] * gze_x[1:] - pi_l * gz_x[1:])
    source_y = grav * (tau_v - tempbot * avg.tbV[None]
                       + P.P_ref_q[:-1] * gze_y[:-1] + pi_u * gz_y[:-1]
                       - P.P_ref_q[1:] * gze_y[1:] - pi_l * gz_y[1:])

    rhs_u = scatter_volume(g, Fx=dHq + var_uu, Fy=var_uv, Fs=source_x)
    rhs_v = scatter_volume(g, Fx=var_vu, Fy=dHq + var_vv, Fs=source_y)
    return torch.stack([rhs_u, rhs_v])


def layer_momentum_fluxes(static, P: Precomputed, g: DeviceGeom, bc: BCs,
                          avg: BtpAverages, qprime_faces, rhs_mom):
    """Layer momentum face fluxes: upwind advective flux with consistency
    weighting + Higdon layer-overlap H_face reconstruction.

    Reference Apply_layers_fluxes (src/mod_create_rhs_mlswe.F90:458-820).
    """
    grav = static.gravity
    L = static.nlayers
    alpha = P.alpha
    fdp, fu, fv = qprime_faces

    def one_dir(dL, dR, uL, uR, vL, vR, fa, fg):
        al = alpha.reshape((L, 1, 1, 1))
        dLq, dRq = face_n2q(g.psiq, dL), face_n2q(g.psiq, dR)   # (L, F, nq)
        uLq, uRq = face_n2q(g.psiq, uL), face_n2q(g.psiq, uR)
        vLq, vRq = face_n2q(g.psiq, vL), face_n2q(g.psiq, vR)
        nx, ny = fg.nx[None], fg.ny[None]

        dpl = (1.0 + fa.muL[None]) * (fg.dpp_ref_face_q + dLq)
        dpr = (1.0 + fa.muR[None]) * (fg.dpp_ref_face_q + dRq)
        ul = uLq + fa.ubL[None]
        ur = uRq + fa.ubR[None]
        vl = vLq + fa.vbL[None]
        vr = vRq + fa.vbR[None]
        uu = 0.5 * (ul + ur)
        vv = 0.5 * (vl + vr)
        udpl, udpr = ul * dpl, ur * dpr
        vdpl, vdpr = vl * dpl, vr * dpr

        # upwind advective fluxes (reference :547-560)
        udp_flux1 = torch.where(uu * nx > 0.0, uu * udpl, uu * udpr)
        vdp_flux1 = torch.where(uu * nx > 0.0, uu * vdpl, uu * vdpr)
        udp_flux2 = torch.where(vv * ny > 0.0, vv * udpl, vv * udpr)
        vdp_flux2 = torch.where(vv * ny > 0.0, vv * vdpl, vv * vdpr)

        # flux-deficit consistency weighting (reference :564-625)
        uu_def = fa.QuU - torch.sum(udp_flux1, 0)
        uv_def = fa.QuV - torch.sum(udp_flux2, 0)
        vu_def = fa.QvU - torch.sum(vdp_flux1, 0)
        vv_def = fa.QvV - torch.sum(vdp_flux2, 0)
        wl_u = torch.abs(udpl) / torch.sum(torch.abs(udpl) + _EPS1, 0)[None]
        wr_u = torch.abs(udpr) / torch.sum(torch.abs(udpr) + _EPS1, 0)[None]
        wl_v = torch.abs(vdpl) / torch.sum(torch.abs(vdpl) + _EPS1, 0)[None]
        wr_v = torch.abs(vdpr) / torch.sum(torch.abs(vdpr) + _EPS1, 0)[None]
        udp_flux1 = udp_flux1 + torch.where((uu_def * fg.nx)[None] > 0.0, wl_u, wr_u) * uu_def[None]
        udp_flux2 = udp_flux2 + torch.where((uv_def * fg.ny)[None] > 0.0, wl_u, wr_u) * uv_def[None]
        vdp_flux1 = vdp_flux1 + torch.where((vu_def * fg.nx)[None] > 0.0, wl_v, wr_v) * vu_def[None]
        vdp_flux2 = vdp_flux2 + torch.where((vv_def * fg.ny)[None] > 0.0, wl_v, wr_v) * vv_def[None]

        # ---- H_face: Higdon layer-overlap reconstruction (:627-707) ------
        # δ-form throughout (docs/float32.md): every quantity below is the
        # perturbation of the reference expression from its static value;
        # at the exact reference state every term is exactly zero in fp
        # arithmetic, so no static bias enters. The static reference face
        # flux (±n·Hk_ref_edge) lives in P.bcl_rhs_ref.
        a_g = (alpha / grav).reshape((L, 1, 1, 1))
        g_a = (grav / alpha).reshape((L, 1, 1, 1))
        Pe = fg.P_ref_edge                       # (L+1, F, nq) ref pressures
        Zr = fg.z_ref_face                       # (L+1, F, nq) ref elevations
        dref = fg.dpp_ref_face_q                 # (L, F, nq) ref dp'

        # conditioned (ope - 1) factors:  sqrt(1+mu2) - 1
        s_l = (fa.mu2L / (1.0 + torch.sqrt(1.0 + fa.mu2L)))[None]
        s_r = (fa.mu2R / (1.0 + torch.sqrt(1.0 + fa.mu2R)))[None]
        s_e = (fa.mue2 / (1.0 + torch.sqrt(1.0 + fa.mue2)))[None]

        ddL = dLq                                # traces carry δdp' already
        ddR = dRq

        def pi_int(s_fac, dd):
            """Interface-pressure perturbation π = p - P_ref for the cumsum
            p = [0, cumsum((1+s)·d)]; conditioned increments."""
            inc = s_fac * dref + (1.0 + s_fac) * dd
            cs = torch.cumsum(inc, 0)
            return torch.cat([torch.zeros_like(cs[:1]), cs], 0)  # (L+1,F,nq)

        def zeta_int(s_fac, dd):
            """Interface-elevation perturbation ζ = z - z_ref (ζ[L]=0)."""
            dthick = a_g * (s_fac * dref + (1.0 + s_fac) * dd)
            rev = torch.flip(torch.cumsum(torch.flip(dthick, (0,)), 0), (0,))
            return torch.cat([rev, torch.zeros_like(rev[:1])], 0)

        piF_L, piF_R = pi_int(s_l, ddL), pi_int(s_r, ddR)
        piE_L, piE_R = pi_int(s_e, ddL), pi_int(s_e, ddR)
        zF_L, zF_R = zeta_int(s_l, ddL), zeta_int(s_r, ddR)
        zE_L, zE_R = zeta_int(s_e, ddL), zeta_int(s_e, ddR)

        def dH_int(pi):
            """δ of the hydrostatic ½α(p[k+1]²-p[k]²) given interface π."""
            return al * (Pe[1:] * pi[1:] - Pe[:-1] * pi[:-1]
                         + 0.5 * (pi[1:] ** 2 - pi[:-1] ** 2))

        dH_plus = dH_int(piE_L)                  # own-side δH (L side)
        dH_minus = dH_int(piE_R)

        Dz_ref = Zr[:-1] - Zr[1:]                # (L, F, nq) ref layer heights
        Vref = Pe[1:] + Pe[:-1]                  # (L, F, nq)
        onehot = torch.arange(L, device=dLq.device).reshape((L, 1, 1, 1))

        def overlap_dH(pi_src, zeta_src, zeta_tgt):
            """δ of the layer-intersection H-from-source (:668-684).

            Loops over source layers kt accumulating into target-sized
            (L, F, nq) arrays — O(L) memory instead of materializing the
            full (L, L, F, nq) pair tensor (VERDICT r1 item 6; the
            reference's nlayers² per-point loop, :662-707, has the same
            O(L²) work but O(1) storage). The intersection length
            min(tops) - max(bots) equals the MINIMUM of the four pairwise
            (top_i - bot_j) differences; each candidate is computed as
            (exact reference-table part) + (ζ perturbation), and the
            perturbed overlap length dz - Dz_ref_overlap is carried through
            the branch select, so no eps·|z_ref| cancellation noise ever
            forms (docs/float32.md).
            """
            zt_u, zt_l = zeta_tgt[:-1], zeta_tgt[1:]     # target k (L, F, nq)
            R2, p2 = Dz_ref, zt_u - zt_l

            def take_min(Ra, pa, Rb, pb):
                a_lt = (Ra + pa) < (Rb + pb)
                return torch.where(a_lt, Ra, Rb), torch.where(a_lt, pa, pb)

            tot = torch.zeros_like(zt_u)
            for kt in range(L):
                ga_s = grav / alpha[kt]
                al_s = alpha[kt]
                zs_u, zs_l = zeta_src[kt], zeta_src[kt + 1]   # (F, nq)
                # 4 candidates (ref part, ζ part): s/t tops minus s/t bots
                R1 = Dz_ref[kt].expand(R2.shape)
                p1 = (zs_u - zs_l).expand(R2.shape)
                R3 = Zr[kt] - Zr[1:]
                p3 = zs_u - zt_l
                R4 = Zr[:-1] - Zr[kt + 1]
                p4 = zt_u - zs_l

                Rm, pm = take_min(*take_min(R1, p1, R2, p2),
                                  *take_min(R3, p3, R4, p4))
                Dzov = torch.minimum(torch.minimum(R1, R2), torch.minimum(R3, R4))
                ddz_ov = pm + (Rm - Dzov)        # dz - Dzov, conditioned
                mask = (Dzov + ddz_ov) > 0.0

                # u - U with U = ga·max(Dzov, 0) (>0 only on-diagonal)
                umU = ga_s * (ddz_ov + torch.clamp(Dzov, max=0.0))
                U = torch.where(Dzov > 0.0, ga_s * Dzov, 0.0)
                # π at the (clamped) bottom of the intersection, source side:
                # z_bot - z_low_src = relu(-A_bot), A_bot conditioned
                A_bot = (Zr[kt + 1] - Zr[1:]) + (zs_l - zt_l)
                pi_bot = pi_src[kt + 1] - ga_s * torch.clamp(-A_bot, min=0.0)
                # v = p_bot + p_top anchored per pair: diagonal vs V_ref (so
                # U·(v-V) is exact), off-diagonal vs 2·P_ref[kt+1] (U=0 there)
                vmV = 2.0 * pi_bot - umU
                v = torch.where(onehot == kt, Vref, 2.0 * Pe[kt + 1]) + vmV
                contrib = 0.5 * al_s * (umU * v + U * vmV)
                # mask=False: contribution is 0, so δ = -ref piece (diag only)
                tot = tot + torch.where(mask, contrib, -0.5 * al_s * U * Vref)
            return tot                           # (L, F, nq)

        dHfL = 0.5 * (dH_plus + overlap_dH(piE_R, zE_R, zE_L))
        dHfR = 0.5 * (dH_minus + overlap_dH(piE_L, zE_L, zE_R))

        # wall faces (er==-4): one-sided hydrostatic H (:710-719)
        wall = fg.wall4[None]
        dHfL = torch.where(wall > 0.5, dH_int(piF_L), dHfL)
        dHfR = torch.where(wall > 0.5, dH_int(piF_R), dHfR)

        # interface corrections at interior faces (:721-738):
        # Hc = ½α[(pf+pinc)² - pf²] = ½α·pinc·(2pf + pinc); pinc = (g/α)(ζf-ζe)
        # is already perturbation-sized (zero at reference).
        if L > 1:
            def corr(piF, zF, zE):
                p_inc = g_a[:-1] * (zF[1:L] - zE[1:L])
                pf_full = Pe[1:L] + piF[1:L]
                Hc = 0.5 * al[:-1] * p_inc * (2.0 * pf_full + p_inc)
                zpad = torch.zeros_like(Hc[:1])
                return (torch.cat([-Hc, zpad], 0)
                        + torch.cat([zpad, Hc], 0))

            dHfL = torch.where(wall > 0.5, dHfL, dHfL + corr(piF_L, zF_L, zE_L))
            dHfR = torch.where(wall > 0.5, dHfR, dHfR + corr(piF_R, zF_R, zE_R))

        # match the vertical sum to the barotropic average (:759-773):
        # (weight-1) in δ-form against the shared Hedge_ref
        sdL = torch.sum(dHfL, 0)
        sL_full = fg.Hedge_ref + sdL
        w1L = torch.where(sL_full > 0.0, (fa.dH - sdL) / sL_full, 0.0)
        dHfL = dHfL + (fg.Hk_ref_edge + dHfL) * w1L[None]
        sdR = torch.sum(dHfR, 0)
        sR_full = fg.Hedge_ref + sdR
        w1R = torch.where(sR_full > 0.0, (fa.dH - sdR) / sR_full, 0.0)
        dHfR = dHfR + (fg.Hk_ref_edge + dHfR) * w1R[None]

        flux_x = nx * udp_flux1 + ny * udp_flux2
        flux_y = nx * vdp_flux1 + ny * vdp_flux2
        SuL = face_quad_scatter(g.psiq, fg.jac, nx * dHfL + flux_x)
        SuR = face_quad_scatter(g.psiq, fg.jac, nx * dHfR + flux_x)
        SvL = face_quad_scatter(g.psiq, fg.jac, ny * dHfL + flux_y)
        SvR = face_quad_scatter(g.psiq, fg.jac, ny * dHfR + flux_y)
        return SuL, SuR, SvL, SvR

    SuLx, SuRx, SvLx, SvRx = one_dir(fdp.xl, fdp.xr, fu.xl, fu.xr, fv.xl, fv.xr,
                                     avg.faces.x, P.faces.x)
    SuLy, SuRy, SvLy, SvRy = one_dir(fdp.yl, fdp.yr, fu.yl, fu.yr, fv.yl, fv.yr,
                                     avg.faces.y, P.faces.y)

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
        # nodal LDG family only (init.check_ported refuses method_visc == 1)
        rhs_visc = bcl_nodal_laplacian(static, P, g, bc, coup, avg)
    else:
        rhs_visc = 0.0

    rhs_mom = layer_momentum_volume(static, P, g, avg, qprime_df, q_df)
    rhs_mom = layer_momentum_fluxes(static, P, g, bc, avg, qprime_faces, rhs_mom)
    # static reference terms dropped by the δ-form kernels (docs/float32.md)
    rhs_mom = rhs_mom + P.bcl_rhs_ref
    return g.massinv * rhs_mom + rhs_visc


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
