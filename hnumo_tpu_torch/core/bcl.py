"""Baroclinic (layer) RHS operators.

Counterpart of hnumo_tpu/core/bcl.py, with the vertical shear-stress
solve (rhs_layer_shear_stress, ad_mlswe > 0).
Reference: src/mod_create_rhs_mlswe.F90 (volume/flux kernels),
src/mod_layer_terms.F90 (face extraction). The layer mass update and the
mass consistency are ops/bcl_mass (core/stepper._thickness_update); the sum
of the momentum terms, the momentum update and the velocity
splitting/recombination (evaluate_bcl) are ops/bcl_mom_update
(core/stepper._momentum_update).

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
from .faces import BCs, extract_faces_multi
from .types import BtpAverages, Precomputed
from .viscosity import bcl_nodal_laplacian, bcl_quad_laplacian


def extract_qprime_faces(bc: BCs, qprime_df):
    """Nodal face traces of (dp', u', v') with BC mirrors.

    Reference extract_qprime_df_face (src/mod_layer_terms.F90:354-415):
    dp' copies across walls, (u', v') get the free-slip/no-slip mirror.
    Returns tuple of 3 FaceLR with layer leading axis.
    """
    return tuple(extract_faces_multi(qprime_df, bc, vec_pairs=((1, 2),)))


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


def layer_momentum_face_values(static, P: Precomputed, g: DeviceGeom, avg: BtpAverages,
                               qprime_faces):
    """Layer momentum face fluxes: upwind advective flux with consistency
    weighting + Higdon layer-overlap H_face reconstruction.

    Reference Apply_layers_fluxes (src/mod_create_rhs_mlswe.F90:458-820).
    The per-face work of both directions is ops/bcl_flux: its CUDA kernel
    under `static.impl == "kernel"`, its plain version under "plain".
    Returns the faces' scatter values, a Pair of (SuL, SuR, SvL, SvR) per
    direction, each (L, F, ngl); ops/bcl_mom_update scatters them into the
    elements' edges.
    """
    fluxes = (bcl_momentum_fluxes_cuda if static.impl == "kernel"
              else bcl_momentum_fluxes_plain)
    return fluxes(g.psiq, P.alpha, static.gravity, qprime_faces, avg.faces, P.faces)


def layer_momentum_terms(static, P, g, bc, avg, coup, qprime_df, q_df, qprime_faces):
    """The layer momentum RHS's three terms: the volume term (2, L, nodal),
    the face fluxes' values (layer_momentum_face_values) and the viscosity
    (2, L, nodal), or 0.0 without it. ops/bcl_mom_update adds them up.

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

    rhs_vol = layer_momentum_volume(static, P, g, avg, qprime_df, q_df)
    faces = layer_momentum_face_values(static, P, g, avg, qprime_faces)
    return rhs_vol, faces, rhs_visc


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
