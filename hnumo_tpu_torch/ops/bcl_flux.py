"""The layer-momentum face fluxes of the baroclinic step, both face
directions: one CUDA kernel and its plain version.

The per-face body of core/bcl.layer_momentum_fluxes (reference
Apply_layers_fluxes, src/mod_create_rhs_mlswe.F90:458-820): the face
interpolation of the (δdp', u', v') traces, the upwind advective fluxes with
their flux-deficit consistency weighting, the Higdon layer-overlap H_face
reconstruction in δ-form (docs/float32.md), the wall and interface
corrections, the match of the vertical sum against the barotropic average,
and the face-quadrature scatter to the face nodes. The scatter into the
elements' edges stays with the caller (core/faces.scatter_face_x/_y).

No TPU kernel of the JAX package covers this function: there XLA fuses it.
In plain PyTorch it is ~1,100 small operations a call, launch-bound on the
card; the kernel does the same work in one launch for both directions.

Each direction's operands, all with the structured face axes F.. of that
direction ((ly, lx+1) for x, (ly+1, lx) for y):
  traces  (δdp' L/R, u' L/R, v' L/R)       (L, F.., ngl)   `qprime_faces`
  FACE_AVG fields of core/types.BtpFaceAvg  (F.., nq)       `avg_faces`
  FACE_GEOM fields of core/types.FaceDirGeom                `geom_faces`
and the outputs (SuL, SuR, SvL, SvR), each (L, F.., ngl): the side-specific
scatter values of u- and v-momentum.

  bcl_momentum_fluxes_cuda   csrc/bcl_flux.cu, f32 and f64, CUDA tensors only
  bcl_momentum_fluxes_plain  the same function in torch ops, any device; the
      CPU tests, `device="cpu"` models and the kernel's yardstick on the card
Neither falls back to the other; neither mutates its operands.
"""
from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from ..core.faces import face_n2q, face_quad_scatter
from ..core.types import Pair
from ._build import load_library

EPS1 = 1.0e-20  # reference eps1, prevents division by zero (:309)

# the most layers a column carries (csrc/bcl_flux.cu, LMAX): up to 4 in
# registers, more in local memory
MAX_LAYERS = 64
# the most quadrature points a face: one thread each (csrc/bcl_flux.cu, MAX_THREADS)
MAX_NQ = 128

# the kernel's operand order within a direction (csrc/bcl_flux.cu)
FACE_AVG = ("dH", "QuU", "QuV", "QvU", "QvV", "muL", "muR", "mu2L", "mu2R", "mue2",
            "ubL", "ubR", "vbL", "vbR")
FACE_GEOM = ("nx", "ny", "jac", "Hedge_ref", "wall4", "dpp_ref_face_q", "Hk_ref_edge",
             "P_ref_edge", "z_ref_face")


def _one_dir(psiq, alpha, grav, dL, dR, uL, uR, vL, vR, fa, fg):
    """One direction's (SuL, SuR, SvL, SvR), each (L, F.., ngl)."""
    L = alpha.shape[0]
    al = alpha.reshape((L, 1, 1, 1))
    dLq, dRq = face_n2q(psiq, dL), face_n2q(psiq, dR)   # (L, F, nq)
    uLq, uRq = face_n2q(psiq, uL), face_n2q(psiq, uR)
    vLq, vRq = face_n2q(psiq, vL), face_n2q(psiq, vR)
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
    wl_u = torch.abs(udpl) / torch.sum(torch.abs(udpl) + EPS1, 0)[None]
    wr_u = torch.abs(udpr) / torch.sum(torch.abs(udpr) + EPS1, 0)[None]
    wl_v = torch.abs(vdpl) / torch.sum(torch.abs(vdpl) + EPS1, 0)[None]
    wr_v = torch.abs(vdpr) / torch.sum(torch.abs(vdpr) + EPS1, 0)[None]
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
    SuL = face_quad_scatter(psiq, fg.jac, nx * dHfL + flux_x)
    SuR = face_quad_scatter(psiq, fg.jac, nx * dHfR + flux_x)
    SvL = face_quad_scatter(psiq, fg.jac, ny * dHfL + flux_y)
    SvR = face_quad_scatter(psiq, fg.jac, ny * dHfR + flux_y)
    return SuL, SuR, SvL, SvR


def _direction_traces(qprime_faces, d: str):
    """The six trace tensors of direction `d` ("x" | "y") in the kernel's
    order: δdp' L, R, u' L, R, v' L, R."""
    return tuple(getattr(tr, d + side) for tr in qprime_faces for side in "lr")


def bcl_momentum_fluxes_plain(psiq: Tensor, alpha: Tensor, grav: float, qprime_faces,
                              avg_faces: Pair, geom_faces: Pair) -> Pair:
    """Both directions' face scatter values in plain torch ops (any device).

    psiq: (ngl, nq); alpha: (L,); grav: the gravity as a Python float;
    qprime_faces: the three core/faces.FaceLR of (δdp', u', v') that
    core/bcl.extract_qprime_faces returns; avg_faces: Pair of BtpFaceAvg;
    geom_faces: Pair of FaceDirGeom. Returns Pair((SuL, SuR, SvL, SvR) of
    the x-faces, the same of the y-faces), each (L, F.., ngl)."""
    out = Pair(*(_one_dir(psiq, alpha, grav, *_direction_traces(qprime_faces, d),
                          getattr(avg_faces, d), getattr(geom_faces, d))
                 for d in "xy"))
    bcl_momentum_fluxes_plain.calls += 1
    return out


bcl_momentum_fluxes_plain.calls = 0


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _direction_operands(qprime_faces, avg, geom, d: str, L: int, ngl: int, nq: int):
    """Direction `d`'s operands in the kernel's order, each checked for its
    shape against the first trace's face axes; returns ([(name, tensor)],
    face axes)."""
    traces = _direction_traces(qprime_faces, d)
    faces = tuple(traces[0].shape[1:-1])
    want = [(f"qprime_faces {d}-trace {i}", t, (L, *faces, ngl))
            for i, t in enumerate(traces)]
    want += [(f"avg_faces.{d}.{n}", getattr(avg, n), (*faces, nq)) for n in FACE_AVG]
    rows = {"wall4": (*faces, 1), "dpp_ref_face_q": (L, *faces, nq),
            "Hk_ref_edge": (L, *faces, nq), "P_ref_edge": (L + 1, *faces, nq),
            "z_ref_face": (L + 1, *faces, nq)}
    want += [(f"geom_faces.{d}.{n}", getattr(geom, n), rows.get(n, (*faces, nq)))
             for n in FACE_GEOM]
    for name, t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"bcl_momentum_fluxes_cuda: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    return [(name, t) for name, t, _ in want], faces


def _library() -> ctypes.CDLL:
    lib = load_library("bcl_flux")
    if not getattr(lib, "_hnumo_declared", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.bcl_flux_launch.argtypes = [I] * 6 + [P, P, P, ctypes.c_double, P]
        lib.bcl_flux_launch.restype = I
        lib.bcl_flux_faces_per_block.argtypes = [I] * 4
        lib.bcl_flux_faces_per_block.restype = I
        lib.bcl_flux_error_string.argtypes = [I]
        lib.bcl_flux_error_string.restype = ctypes.c_char_p
        lib._hnumo_declared = True
    return lib


def bcl_momentum_fluxes_cuda(psiq: Tensor, alpha: Tensor, grav: float, qprime_faces,
                             avg_faces: Pair, geom_faces: Pair) -> Pair:
    """Both directions' face scatter values as one CUDA kernel launch
    (csrc/bcl_flux.cu).

    Same operands and result as `bcl_momentum_fluxes_plain`; float32 or
    float64 CUDA tensors, all of one dtype on one device, contiguous, at
    most MAX_LAYERS layers and MAX_NQ quadrature points a face, and one
    face's traces and integrands within a block's shared memory. Launches on
    the current stream and does not synchronise. Raises on operands the
    kernel does not take and on a refused launch; builds the kernel at the
    first call. `bcl_momentum_fluxes_cuda.launches` counts the launches made."""
    if psiq.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"bcl_momentum_fluxes_cuda takes float32/float64, got {psiq.dtype}")
    ngl, nq = psiq.shape
    L = alpha.shape[0]
    if L > MAX_LAYERS:
        raise ValueError(f"bcl_momentum_fluxes_cuda takes at most {MAX_LAYERS} layers, "
                         f"got {L}")
    if nq > MAX_NQ:
        raise ValueError(f"bcl_momentum_fluxes_cuda takes at most {MAX_NQ} quadrature "
                         f"points a face, got {nq}")
    operands = {d: _direction_operands(qprime_faces, getattr(avg_faces, d),
                                       getattr(geom_faces, d), d, L, ngl, nq)
                for d in "xy"}
    named = [("psiq", psiq), ("alpha", alpha)]
    named += [op for d in "xy" for op in operands[d][0]]
    for name, t in named:
        if t.device != psiq.device or t.dtype != psiq.dtype:
            raise ValueError(f"bcl_momentum_fluxes_cuda: {name} is {t.dtype} on {t.device}, "
                             f"expected {psiq.dtype} on {psiq.device}")
        if not t.is_contiguous():
            raise ValueError(f"bcl_momentum_fluxes_cuda: {name} is not contiguous")
    if psiq.device.type != "cuda":
        raise ValueError(
            f"bcl_momentum_fluxes_cuda takes CUDA tensors, got {psiq.device}; use "
            "bcl_momentum_fluxes_plain (impl='plain') on other devices")
    ptrs, counts, outs = [], [], []
    for d in "xy":
        ops, faces = operands[d]
        out = torch.empty((4, L, *faces, ngl), dtype=psiq.dtype, device=psiq.device)
        ptrs += [t.data_ptr() for _, t in ops] + [o.data_ptr() for o in out]
        counts.append(faces[0] * faces[1])
        outs.append(tuple(out))
    lib = _library()
    is_double = int(psiq.dtype == torch.float64)
    if lib.bcl_flux_faces_per_block(is_double, L, ngl, nq) < 1:
        raise ValueError(f"bcl_momentum_fluxes_cuda: one face of {L} layers at ngl={ngl}, "
                         f"nq={nq} needs more shared memory than a block has")
    with torch.cuda.device(psiq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bcl_flux_launch(
            is_double, L, ngl, nq, counts[0], counts[1],
            (ctypes.c_void_p * len(ptrs))(*ptrs), alpha.data_ptr(), psiq.data_ptr(),
            float(grav), stream)
    if err != 0:
        raise RuntimeError(f"bcl_flux kernel launch failed: CUDA error {err} "
                           f"({lib.bcl_flux_error_string(err).decode()})")
    bcl_momentum_fluxes_cuda.launches += 1
    return Pair(*outs)


bcl_momentum_fluxes_cuda.launches = 0
