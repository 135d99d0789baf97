"""Baroclinic predictor-corrector step with barotropic sub-cycling.

Counterpart of hnumo_tpu/core/stepper.py.
Reference: src/ti_rk_bcl.F90:9-87 (outer step), src/mod_splitting.F90
(thickness/momentum/momentum_mass substeps). One call = one baroclinic dt.

The negative-thickness abort (reference src/mod_splitting.F90:74-77) is
carried as a boolean `ok` tensor in the state and read by Model.run between
steps, so the step itself never waits for the device (under a domain
decomposition the flag is and-reduced over the blocks, one all-reduce per
thickness update). The caller's State is
never mutated: every update builds new tensors.
"""
from __future__ import annotations

import torch

from ..ops.dg import DeviceGeom, interp_n2q
from ..spans import span
from .bcl import (apply_consistency, evaluate_bcl, evaluate_bcl_v1,
                  extract_qprime_faces, layer_mass_rhs, layer_momentum_rhs,
                  rhs_layer_shear_stress, velocity_df)
from .btp import barotropic_solve
from .coupling import btp_bcl_coeffs
from .faces import BCs, all_shards_and, apply_wall_projection
from .types import Precomputed, State


def _coriolis_rotation(P: Precomputed, q_df_temp_u, q_df_temp_v, q_df):
    """Semi-implicit Coriolis rotation (reference src/mod_splitting.F90:167-173).

    tempu = qu* + (f dt/2) qv^n ; tempv = qv* - (f dt/2) qu^n
    qu^{n+1} = a*tempu + b*tempv ; qv^{n+1} = -b*tempu + a*tempv
    """
    tempu = q_df_temp_u + P.fdt2_bcl[None] * q_df[2]
    tempv = q_df_temp_v - P.fdt2_bcl[None] * q_df[1]
    qu = P.a_bcl[None] * tempu + P.b_bcl[None] * tempv
    qv = -P.b_bcl[None] * tempu + P.a_bcl[None] * tempv
    return qu, qv


def _momentum_update(static, P, g, bc, avg, coup, q_df, qprime_df, qprime_faces, qb_df):
    """Shared momentum update of momentum()/momentum_mass()
    (reference src/mod_splitting.F90:128-175, 239-282). `qb_df`: the
    barotropic state the shear-stress branch smooths the velocities
    against. Returns a new q_df with updated momentum (thickness
    untouched)."""
    rhs_mom = layer_momentum_rhs(static, P, g, bc, avg, coup,
                                 qprime_df, q_df, qprime_faces)
    qu_t = q_df[1] + static.dt * rhs_mom[0]
    qv_t = q_df[2] + static.dt * rhs_mom[1]

    if static.ad_mlswe > 0.0:
        # rotate, smooth velocities, implicit shear solve (reference :140-163)
        qu3, qv3 = _coriolis_rotation(P, qu_t, qv_t, q_df)
        q_df3 = velocity_df(P, torch.stack([q_df[0], qu3, qv3]), qb_df)
        rhs_stress = rhs_layer_shear_stress(static, P, g, q_df3)
        qu_t = qu_t + static.dt * (g.massinv[None] * rhs_stress[0])
        qv_t = qv_t + static.dt * (g.massinv[None] * rhs_stress[1])

    qu, qv = _coriolis_rotation(P, qu_t, qv_t, q_df)
    qu, qv = apply_wall_projection(qu, qv, bc)
    return torch.stack([q_df[0], qu, qv])


def _thickness_update(static, P, g, bc, avg, q_df, qprime_df, qprime_faces):
    """Mass update + negative-thickness check + consistency
    (reference thickness/momentum_mass mass part,
    src/mod_splitting.F90:55-87, 220-235). Returns (new q_df, ok)."""
    dp_advec, slmf, slmf_face = layer_mass_rhs(
        static, P, g, bc, avg, qprime_df, qprime_faces)
    q_df = torch.cat([(q_df[0] + static.dt * dp_advec)[None], q_df[1:]])
    # q_df[0] stores δdp; the abort checks the FULL thickness (reference
    # src/mod_splitting.F90:74-77), on every block of a decomposition
    ok = all_shards_and(torch.all(P.dpp_ref_df + q_df[0] >= 0.0), bc)
    q_df = apply_consistency(static, P, g, bc, avg, q_df, slmf, slmf_face)
    return q_df, ok


def ti_rk_bcl(static, P: Precomputed, g: DeviceGeom, bc: BCs, state: State,
              vol_ops=None, mega_ops=None, tail_ops=None) -> State:
    """One baroclinic time step (reference src/ti_rk_bcl.F90:9-87).

    `vol_ops`: optional precomputed volume operator tables
    (btp.build_vol_operators) — Model builds them once; None rebuilds them
    in each barotropic solve. `mega_ops`: the megakernel's static operands
    (ops/mega.build_mega_static), which Model builds when `static.mega`;
    with them both barotropic solves take the whole-solve path. `tail_ops`:
    the fused path's operator tables (btp.build_fused_operators), which
    Model builds when `static.fused_tail`; None rebuilds them per solve."""
    q_df, qb_df, qprime_df = state.q_df, state.qb_df, state.qprime_df
    # the quad-resolution viscosity weight belongs to the quad LDG family
    # (method_visc == 1); the nodal family never reads it
    zq = torch.zeros(qprime_df.shape[1:-2] + g.wjac.shape[-2:],
                     dtype=qprime_df.dtype, device=qprime_df.device)

    # ==================== predictor =====================================
    with span("hnumo.bcl.predictor"):
        with span("hnumo.bcl.faces"):
            qprime_faces = extract_qprime_faces(bc, qprime_df)

        dpprime_visc = qprime_df[0]
        dpprime_visc_q = interp_n2q(g, dpprime_visc) if static.method_visc == 1 else zq
        with span("hnumo.coupling"):
            coup = btp_bcl_coeffs(static, P, g, bc, qprime_df, qprime_faces,
                                  dpprime_visc, dpprime_visc_q)
        with span("hnumo.btp.solve"):
            qbp_df, avg = barotropic_solve(static, P, g, bc, coup, qb_df, qprime_df,
                                           vol_ops=vol_ops, mega_ops=mega_ops,
                                           tail_ops=tail_ops)

        # momentum_mass (predictor): mass + momentum + recombination
        with span("hnumo.bcl.thickness"):
            q_df2, ok1 = _thickness_update(static, P, g, bc, avg, q_df, qprime_df,
                                           qprime_faces)
        with span("hnumo.bcl.momentum"):
            q_df2 = _momentum_update(static, P, g, bc, avg, coup,
                                     q_df2, qprime_df, qprime_faces, qbp_df)
        with span("hnumo.bcl.evaluate"):
            q_df2, qprime_df2, qprime_faces2 = evaluate_bcl(static, P, bc, q_df2, qprime_df,
                                                            qbp_df)

    # ==================== corrector =====================================
    with span("hnumo.bcl.corrector"):
        qprime_half = 0.5 * (qprime_df2 + qprime_df)
        qprime_faces_half = tuple(
            type(f2)(*[0.5 * (a + b) for a, b in zip(f1, f2)])
            for f1, f2 in zip(qprime_faces, qprime_faces2)
        )
        dpprime_visc = P.dpp_ref_df + qprime_half[0]
        dpprime_visc_q = interp_n2q(g, dpprime_visc) if static.method_visc == 1 else zq
        with span("hnumo.coupling"):
            coup = btp_bcl_coeffs(static, P, g, bc, qprime_half, qprime_faces_half,
                                  dpprime_visc, dpprime_visc_q)
        with span("hnumo.btp.solve"):
            qb_new, avg = barotropic_solve(static, P, g, bc, coup, qb_df,
                                           qprime_half, vol_ops=vol_ops,
                                           mega_ops=mega_ops, tail_ops=tail_ops)

        # thickness (corrector) with averaged primes
        with span("hnumo.bcl.thickness"):
            q_df, ok2 = _thickness_update(static, P, g, bc, avg, q_df,
                                          qprime_half, qprime_faces_half)

        # store dp' dofs; average thickness primes for the momentum corrector
        # (reference src/ti_rk_bcl.F90:73-85); δ-forms throughout
        eta_t = (torch.sum(q_df[0], 0) + P.sum_ref_residual) * P.one_over_pbprime_df
        dpprime_new = (q_df[0] - P.dpp_ref_df * eta_t[None]) / (1.0 + eta_t)[None]
        with span("hnumo.bcl.faces"):
            dpprime_faces_new = extract_qprime_faces(bc, torch.stack(
                [dpprime_new, qprime_half[1], qprime_half[2]]))[0]

        qprime_mom = torch.stack([0.5 * (qprime_df[0] + dpprime_new),
                                  qprime_half[1], qprime_half[2]])
        fdp_half = type(qprime_faces[0])(*[
            0.5 * (a + b) for a, b in zip(qprime_faces[0], dpprime_faces_new)])
        qprime_faces_mom = (fdp_half, qprime_faces_half[1], qprime_faces_half[2])

        with span("hnumo.bcl.momentum"):
            q_df = _momentum_update(static, P, g, bc, avg, coup,
                                    q_df, qprime_mom, qprime_faces_mom, qb_new)
        with span("hnumo.bcl.evaluate"):
            q_df, qprime_mom = evaluate_bcl_v1(P, q_df, qprime_mom, qb_new)

        qprime_out = torch.stack([dpprime_new, qprime_mom[1], qprime_mom[2]])
        t = state.t + static.dt
        ok = torch.logical_and(state.ok, torch.logical_and(ok1, ok2))

    return State(qb_df=qb_new, q_df=q_df, qprime_df=qprime_out, t=t, ok=ok)
