"""Barotropic<->baroclinic coupling coefficient fields.

Counterpart of hnumo_tpu/core/coupling.py.
Reference: btp_bcl_coeffs_qdf (src/mod_barotropic_terms.F90:219-409).
Computed twice per baroclinic dt (predictor and corrector) and consumed by
every barotropic substep. All layer loops become vectorized cumsums /
reductions over the leading layer axis.
"""
from __future__ import annotations

import torch

from ..ops.dg import DeviceGeom, grad_nodal, interp_n2q
from .faces import BCs, extract_faces_multi, face_n2q
from .types import CouplingFields, Pair, Precomputed


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


def btp_bcl_coeffs(
    static,
    P: Precomputed,
    g: DeviceGeom,
    bc: BCs,
    qprime_df,        # (3, L, nodal)
    qprime_faces,     # tuple of 3 FaceLR (dp', u', v') nodal traces per layer
    dpprime_visc,     # (L, nodal)
    dpprime_visc_q,   # (L, quad) or zeros
) -> CouplingFields:
    nlayers = static.nlayers
    alpha = P.alpha

    # ---- volume quad-point coefficients (reference :265-283) ----
    qp = interp_n2q(g, qprime_df)          # (3, L, quad); qp[0] = δdp'
    ddpp, up, vp = qp[0], qp[1], qp[2]
    dpp = P.dpp_ref_q + ddpp               # full dp' for the advective sums
    Q_uu_dp = torch.sum(up * up * dpp, dim=0)
    Q_uv_dp = torch.sum(vp * up * dpp, dim=0)
    Q_vv_dp = torch.sum(vp * vp * dpp, dim=0)
    _, dHk = delta_pressure_H(ddpp, P.P_ref_q, alpha)
    dH_bcl = torch.sum(dHk, dim=0)

    # ---- edge coefficients (reference :306-337), δ-form ----
    fdp, fu, fv = qprime_faces

    def edge_dir(dL, dR, uL, uR, vL, vR, fg):
        # traces (L, F, ngl) -> quad (L, F, nq); thickness traces carry δdp'
        ddLq, ddRq = face_n2q(g.psiq, dL), face_n2q(g.psiq, dR)
        dLq = fg.dpp_ref_face_q + ddLq
        dRq = fg.dpp_ref_face_q + ddRq
        uLq, uRq = face_n2q(g.psiq, uL), face_n2q(g.psiq, uR)
        vLq, vRq = face_n2q(g.psiq, vL), face_n2q(g.psiq, vR)
        quu = torch.sum(0.5 * (uLq * uLq * dLq + uRq * uRq * dRq), dim=0)
        quv = torch.sum(0.5 * (vLq * uLq * dLq + vRq * uRq * dRq), dim=0)
        qvv = torch.sum(0.5 * (vLq * vLq * dLq + vRq * vRq * dRq), dim=0)
        _, dHL = delta_pressure_H(ddLq, fg.P_ref_edge, alpha)
        _, dHR = delta_pressure_H(ddRq, fg.P_ref_edge, alpha)
        dHedge = torch.sum(0.5 * (dHL + dHR), dim=0)
        return quu, quv, qvv, dHedge

    xquu, xquv, xqvv, xH = edge_dir(fdp.xl, fdp.xr, fu.xl, fu.xr, fv.xl, fv.xr,
                                    P.faces.x)
    yquu, yquv, yqvv, yH = edge_dir(fdp.yl, fdp.yr, fu.yl, fu.yr, fv.yl, fv.yr,
                                    P.faces.y)

    # ---- viscosity coefficient fields (reference :287-304,339-407) ----
    if static.use_visc:
        # nodal gradients of (u'_k, v'_k) per layer
        gux, guy = grad_nodal(g, qprime_df[1])   # (L, nodal)
        gvx, gvy = grad_nodal(g, qprime_df[2])
        graduv = torch.stack([gux, guy, gvx, gvy], dim=0)      # (4, L, nodal)
        dpp_graduv = dpprime_visc[None] * graduv              # (4, L, nodal)
        btp_dpp_graduv = torch.sum(dpp_graduv, dim=1)          # (4, nodal)
        pbprime_visc = torch.sum(dpprime_visc, dim=0)

        # face traces of dpp_graduv (vector mirror on (1,2) and (3,4) pairs at
        # free-slip walls) + dpprime_visc (scalar copy)
        f5 = extract_faces_multi(
            torch.cat([dpp_graduv, dpprime_visc[None]], dim=0), bc,
            vec_pairs=((0, 1), (2, 3)))

        def stack_dir(sel_l, sel_r):
            L = torch.stack([sel_l(f) for f in f5])
            R = torch.stack([sel_r(f) for f in f5])
            return torch.stack([L, R], dim=1)   # (5, 2, L, F, ngl)

        gface_x = stack_dir(lambda f: f.xl, lambda f: f.xr)
        gface_y = stack_dir(lambda f: f.yl, lambda f: f.yr)
        btp_gface_x = torch.sum(gface_x, dim=2)
        btp_gface_y = torch.sum(gface_y, dim=2)
    else:
        z_nod = torch.zeros_like(qprime_df[0, 0])
        opts = dict(dtype=z_nod.dtype, device=z_nod.device)
        dpp_graduv = torch.zeros((4,) + qprime_df.shape[1:], **opts)
        btp_dpp_graduv = torch.zeros((4,) + z_nod.shape, **opts)
        pbprime_visc = z_nod
        gface_x = torch.zeros((5, 2) + fdp.xl.shape, **opts)
        gface_y = torch.zeros((5, 2) + fdp.yl.shape, **opts)
        btp_gface_x = torch.sum(gface_x, dim=2)
        btp_gface_y = torch.sum(gface_y, dim=2)

    return CouplingFields(
        Q_uu_dp=Q_uu_dp, Q_uv_dp=Q_uv_dp, Q_vv_dp=Q_vv_dp, dH_bcl=dH_bcl,
        Q_uu_dp_edge=Pair(xquu, yquu), Q_uv_dp_edge=Pair(xquv, yquv),
        Q_vv_dp_edge=Pair(xqvv, yqvv), dH_bcl_edge=Pair(xH, yH),
        dpp_graduv=dpp_graduv, btp_dpp_graduv=btp_dpp_graduv,
        pbprime_visc=pbprime_visc, dpprime_visc=dpprime_visc,
        dpprime_visc_q=dpprime_visc_q,
        graduv_dpp_face=Pair(gface_x, gface_y),
        btp_graduv_dpp_face=Pair(btp_gface_x, btp_gface_y),
    )
