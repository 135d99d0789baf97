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
from ..ops.bcl_mass import bcl_mass_cuda, bcl_mass_plain
from ..ops.bcl_mom_update import bcl_mom_update_cuda, bcl_mom_update_plain
from .bcl import extract_qprime_faces, layer_momentum_terms
from .btp import barotropic_solve
from .coupling import btp_bcl_coeffs
from .faces import BCs, all_shards_and
from .types import Precomputed, State


def _momentum_update(static, P, g, bc, avg, coup, q_df, qprime_df, qprime_faces, qb_df,
                     dpprime=None):
    """Shared momentum update of momentum()/momentum_mass()
    (reference src/mod_splitting.F90:128-175, 239-282) and the recombination
    after it: evaluate_bcl in the predictor (`dpprime` None: the thickness
    prime from eta_t), evaluate_bcl_v1 in the corrector (the thickness prime
    `dpprime` kept), without the new primes' face traces. `qb_df`: the new
    barotropic state the velocities are smoothed against. The layer
    momentum's three terms are core/bcl's; the rest is ops/bcl_mom_update:
    its CUDA kernel under `static.impl == "kernel"`, its plain version under
    "plain". Returns (new q_df, new qprime_df); the thickness is untouched."""
    terms = layer_momentum_terms(static, P, g, bc, avg, coup, qprime_df, q_df, qprime_faces)
    update = bcl_mom_update_cuda if static.impl == "kernel" else bcl_mom_update_plain
    return update(static, P, g, bc, q_df, *terms, qb_df, dpprime)


def _thickness_update(static, P, g, bc, avg, q_df, qprime_df, qprime_faces):
    """Mass update + negative-thickness check + consistency
    (reference thickness/momentum_mass mass part,
    src/mod_splitting.F90:55-87, 220-235). The body is ops/bcl_mass: its
    CUDA kernels under `static.impl == "kernel"`, its plain version under
    "plain". Returns (new q_df, ok)."""
    update = bcl_mass_cuda if static.impl == "kernel" else bcl_mass_plain
    q_df, ok = update(static, P, g, bc, avg, q_df, qprime_df, qprime_faces)
    # the abort checks the FULL thickness (reference src/mod_splitting.F90:74-77)
    # on every block of a decomposition
    return q_df, all_shards_and(ok, bc)


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
            _, qprime_df2 = _momentum_update(static, P, g, bc, avg, coup, q_df2, qprime_df,
                                             qprime_faces, qbp_df)

    # ==================== corrector =====================================
    with span("hnumo.bcl.corrector"):
        qprime_half = 0.5 * (qprime_df2 + qprime_df)
        # a trace is a copy or a mirror of a node, so the traces of the
        # averaged primes are the average of the two primes' traces, bit for bit
        with span("hnumo.bcl.faces"):
            qprime_faces_half = extract_qprime_faces(bc, qprime_half)
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

        # the new primes keep dpprime_new (evaluate_bcl_v1)
        with span("hnumo.bcl.momentum"):
            q_df, qprime_out = _momentum_update(static, P, g, bc, avg, coup, q_df, qprime_mom,
                                                qprime_faces_mom, qb_new, dpprime=dpprime_new)
        t = state.t + static.dt
        ok = torch.logical_and(state.ok, torch.logical_and(ok1, ok2))

    return State(qb_df=qb_new, q_df=q_df, qprime_df=qprime_out, t=t, ok=ok)
