"""The layer-momentum volume term of the baroclinic step: one CUDA kernel
and its plain version.

The body of core/bcl.layer_momentum_volume (reference
create_rhs_dynamics_volume_layers, src/mod_create_rhs_mlswe.F90:281-456):
the δ-form interface elevation ζ and its gradient, the interpolation of the
primes and of the layer momenta to the quad points, the conditioned
interface-pressure cumsum π and the layer δH, the momentum-flux consistency
weights against the barotropic averages, the pressure-force weight, the
wind and bottom-stress distribution, the interface-slope source, and the
weak-form integral of the two momentum components. Returns rhs_mom (2, L,
nodal) without massinv.

No TPU kernel of the JAX package covers this function: there XLA fuses it.
In plain PyTorch it is ~190 small operations a call, launch-bound on the
card; the kernel does the same work in one launch.

  bcl_mom_volume_cuda   csrc/bcl_mom_volume.cu, f32 and f64, CUDA tensors only
  bcl_mom_volume_plain  the same function in torch ops, any device; the CPU
      tests, `device="cpu"` models and the kernel's yardstick on the card
Both take (static, P, g, avg, qprime_df, q_df) as core/bcl does. Neither
falls back to the other; neither mutates its operands.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library
from .bcl_flux import EPS1
from .dg import grad_n2q, interp_n2q, scatter_volume

# the most layers a column carries (csrc/bcl_mom_volume.cu, LMAX): up to 4
# in registers, more in local memory
MAX_LAYERS = 64
# the most quadrature points an element side (csrc/bcl_mom_volume.cu,
# MAX_NQ): one thread a point of the element, 17 x 17 for p=8
MAX_NQ = 17


def bcl_mom_volume_plain(static, P, g, avg, qprime_df, q_df):
    """Layer momentum volume term in plain torch ops (any device).

    Note: the reference's wind/bottom-stress distribution accumulates
    `pprime_temp(k+1)=pprime_temp(k)+qp(k)` where `qp` holds the LAST
    layer's (dp',u',v') 3-vector (:380-382) — an indexing slip that is
    inert for all shipped gated cases (zero wind/bottom stress there). We
    implement the documented intent: cumulative prime pressure
    pprime_temp = cumsum_k dp'_k.
    """
    bcl_mom_volume_plain.calls += 1
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
    temp_uu = torch.abs(udp_q) + EPS1
    temp_vv = torch.abs(vdp_q) + EPS1

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


bcl_mom_volume_plain.calls = 0


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

# the kernel's operands in its order (csrc/bcl_mom_volume.cu), each with its
# shape in terms of L, the nodal (ly, lx, ngl, ngl) and quad (ly, lx, nq, nq)
# element shapes
OPERANDS = (
    ("qprime_df", (3, "L", "N")), ("q_df", (3, "L", "N")), ("P.dpp_ref_df", ("L", "N")),
    ("avg.mu2_df", ("N",)),
    *((f"avg.{n}", ("Q",)) for n in ("mu2", "mu", "ub", "vb", "Qu", "Quv", "Qv", "dH",
                                      "tbU", "tbV")),
    ("P.H_bcl_ref", ("Q",)), ("P.pbprime", ("Q",)), ("P.tau_wind", (2, "Q")),
    ("P.dpp_ref_q", ("L", "Q")), ("P.Hk_ref_q", ("L", "Q")), ("P.P_ref_q", ("L+1", "Q")),
    ("P.gz_ref", (2, "L+1", "Q")),
    *((f"g.{n}", ("Q",)) for n in ("ksiq_x", "ksiq_y", "etaq_x", "etaq_y", "wjac")),
    ("P.alpha", ("L",)), ("g.psiq", ("ngl", "nq")), ("g.dpsiq", ("ngl", "nq")),
)


def _library() -> ctypes.CDLL:
    lib = load_library("bcl_mom_volume")
    if not getattr(lib, "_hnumo_declared", False):
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.bcl_mom_volume_launch.argtypes = [I] * 6 + [P, P, D, D, D, P]
        lib.bcl_mom_volume_launch.restype = I
        lib.bcl_mom_volume_elements_per_block.argtypes = [I] * 3
        lib.bcl_mom_volume_elements_per_block.restype = I
        lib.bcl_mom_volume_error_string.argtypes = [I]
        lib.bcl_mom_volume_error_string.restype = ctypes.c_char_p
        lib.bcl_mom_volume_operand_count.argtypes = []
        lib.bcl_mom_volume_operand_count.restype = I
        if lib.bcl_mom_volume_operand_count() != len(OPERANDS):
            raise RuntimeError(f"csrc/bcl_mom_volume.cu takes "
                               f"{lib.bcl_mom_volume_operand_count()} operands, "
                               f"ops/bcl_mom_volume.OPERANDS names {len(OPERANDS)}")
        lib._hnumo_declared = True
    return lib


def _operands(static, P, g, avg, qprime_df, q_df):
    """[(name, tensor)] in the kernel's order, each checked for its shape."""
    scope = {"P": P, "g": g, "avg": avg}
    L = P.alpha.shape[0]
    ngl, nq = g.psiq.shape
    lylx = tuple(qprime_df.shape[2:4])
    dims = {"L": (L,), "L+1": (L + 1,), "N": (*lylx, ngl, ngl), "Q": (*lylx, nq, nq),
            "ngl": (ngl,), "nq": (nq,)}
    out = []
    for name, spec in OPERANDS:
        if "." in name:
            head, field = name.split(".")
            t = getattr(scope[head], field)
        else:
            t = {"qprime_df": qprime_df, "q_df": q_df}[name]
        shape = tuple(d for s in spec for d in (dims[s] if isinstance(s, str) else (s,)))
        if tuple(t.shape) != shape:
            raise ValueError(f"bcl_mom_volume_cuda: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        out.append((name, t))
    return out


def bcl_mom_volume_cuda(static, P, g, avg, qprime_df, q_df):
    """The layer momentum volume term as one CUDA kernel launch
    (csrc/bcl_mom_volume.cu).

    Same operands and result as `bcl_mom_volume_plain`; float32 or float64
    CUDA tensors, all of one dtype on one device, contiguous, at most
    MAX_LAYERS layers (at most 3 under `compat_reference_stress`) and MAX_NQ
    quadrature points an element side. Launches on the current stream and
    does not synchronise. Raises on operands the kernel does not take and on
    a refused launch; builds the kernel at the first call.
    `bcl_mom_volume_cuda.launches` counts the launches made."""
    dtype = g.psiq.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"bcl_mom_volume_cuda takes float32/float64, got {dtype}")
    L = P.alpha.shape[0]
    ngl, nq = g.psiq.shape
    if L != static.nlayers:
        raise ValueError(f"bcl_mom_volume_cuda: P.alpha has {L} layers, static.nlayers "
                         f"is {static.nlayers}")
    if L > MAX_LAYERS:
        raise ValueError(f"bcl_mom_volume_cuda takes at most {MAX_LAYERS} layers, got {L}")
    if static.compat_reference_stress and L > 3:
        raise ValueError("bcl_mom_volume_cuda: compat_reference_stress takes at most 3 "
                         f"layers, got {L}")
    if nq > MAX_NQ:
        raise ValueError(f"bcl_mom_volume_cuda takes at most {MAX_NQ} quadrature points "
                         f"an element side, got {nq}")
    named = _operands(static, P, g, avg, qprime_df, q_df)
    for name, t in named:
        if t.device != g.psiq.device or t.dtype != dtype:
            raise ValueError(f"bcl_mom_volume_cuda: {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {g.psiq.device}")
        if not t.is_contiguous():
            raise ValueError(f"bcl_mom_volume_cuda: {name} is not contiguous")
    if g.psiq.device.type != "cuda":
        raise ValueError(
            f"bcl_mom_volume_cuda takes CUDA tensors, got {g.psiq.device}; use "
            "bcl_mom_volume_plain (impl='plain') on other devices")
    ly, lx = qprime_df.shape[2:4]
    out = torch.empty((2, L, ly, lx, ngl, ngl), dtype=dtype, device=g.psiq.device)
    lib = _library()
    is_double = int(dtype == torch.float64)
    if lib.bcl_mom_volume_elements_per_block(is_double, ngl, nq) < 1:
        raise ValueError(f"bcl_mom_volume_cuda: one element at ngl={ngl}, nq={nq} needs "
                         "more shared memory than a block has")
    ptrs = (ctypes.c_void_p * len(named))(*(t.data_ptr() for _, t in named))
    with torch.cuda.device(g.psiq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bcl_mom_volume_launch(
            is_double, L, ngl, nq, ly * lx, int(bool(static.compat_reference_stress)), ptrs,
            out.data_ptr(), float(static.gravity), float(static.Pstress),
            float(static.Pbstress), stream)
    if err != 0:
        raise RuntimeError(f"bcl_mom_volume kernel launch failed: CUDA error {err} "
                           f"({lib.bcl_mom_volume_error_string(err).decode()})")
    bcl_mom_volume_cuda.launches += 1
    return out


bcl_mom_volume_cuda.launches = 0
