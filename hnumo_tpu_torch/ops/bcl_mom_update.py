"""The end of each baroclinic half-step: one CUDA kernel and its plain version.

The tail of core/stepper._momentum_update after the layer momentum's three
terms (reference momentum and momentum_mass, momentum part,
src/mod_splitting.F90:128-175, 239-282): the four edge scatters of the face
fluxes' values, the static reference terms, the inverse mass, the viscosity,
q + dt * rhs, the semi-implicit Coriolis rotation and the wall projection;
then the velocity smoothing and the new primes of evaluate_bcl (the
predictor, reference src/mod_layer_terms.F90:198-238) or evaluate_bcl_v1
(the corrector, :240-270), without the face extraction of the new primes:
the corrector extracts the traces of the predictor's primes averaged with
the old ones, and a decomposition's halo exchange stays there. Returns (the
new q_df, the new qprime_df).

No TPU kernel of the JAX package covers these functions: there XLA fuses
them. In plain PyTorch they are ~100-110 small operations a half-step,
launch-bound on the card; every step of them is pointwise in (element, node)
but the vertical sums of extract_velocity and of η_t, so the kernel does
the same work in one launch, one thread a node, the layers streamed. With
the vertical shear stress (ad_mlswe > 0) the kernel runs in two launches,
before and after the plain shear solve, which couples the layers of a quad
point's column through a tridiagonal solve.

  bcl_mom_update_cuda   csrc/bcl_mom_update.cu, f32 and f64, CUDA tensors only
  bcl_mom_update_plain  the same function in torch ops, any device; the CPU
      tests, `device="cpu"` models and the kernel's yardstick on the card
Both take (static, P, g, bc, q_df, rhs_vol, faces, rhs_visc, qb_df, dpprime):
the q_df of the thickness update, the volume term (2, L, nodal), the face
fluxes' values (core/bcl.layer_momentum_face_values: a Pair of (SuL, SuR,
SvL, SvR) per direction), the viscosity (2, L, nodal) or 0.0, the new
barotropic state, and the thickness prime the corrector keeps (None in the
predictor, which recomputes it from η_t). Neither falls back to the other;
neither mutates its operands.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.bcl import rhs_layer_shear_stress
from ..core.faces import BCs, _edge_masks, apply_wall_projection, scatter_face_x, scatter_face_y
from ..core.types import Pair, Precomputed
from ._build import load_library
from .bcl_mass import _field

# the most layers a column carries (csrc/bcl_mom_update.cu, LMAX; as ops/bcl_flux)
MAX_LAYERS = 64


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def scatter_face_values(rhs_vol, faces: Pair, bc: BCs):
    """The face fluxes' values scattered into the elements' edges of the
    volume term: the L side of a face takes -SuL, its R side +SuR
    (core/faces.scatter_face_x / _y). Returns rhs (2, L, nodal)."""
    (SuLx, SuRx, SvLx, SvRx), (SuLy, SuRy, SvLy, SvRy) = faces
    rhs_u, rhs_v = rhs_vol[0], rhs_vol[1]
    rhs_u = scatter_face_x(rhs_u, SuLx, bc, S_right=SuRx)
    rhs_u = scatter_face_y(rhs_u, SuLy, bc, S_right=SuRy)
    rhs_v = scatter_face_x(rhs_v, SvLx, bc, S_right=SvRx)
    rhs_v = scatter_face_y(rhs_v, SvLy, bc, S_right=SvRy)
    return torch.stack([rhs_u, rhs_v])


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


def shear_stress_update(static, P, g, q_df, qu_t, qv_t, qb_df):
    """The vertical shear stress of ad_mlswe > 0 on the updated momenta (qu_t,
    qv_t): rotate, smooth the velocities, the implicit shear solve
    (reference src/mod_splitting.F90:140-163). Returns the new (qu_t, qv_t)."""
    qu3, qv3 = _coriolis_rotation(P, qu_t, qv_t, q_df)
    q_df3 = velocity_df(P, torch.stack([q_df[0], qu3, qv3]), qb_df)
    rhs_stress = rhs_layer_shear_stress(static, P, g, q_df3)
    qu_t = qu_t + static.dt * (g.massinv[None] * rhs_stress[0])
    qv_t = qv_t + static.dt * (g.massinv[None] * rhs_stress[1])
    return qu_t, qv_t


def evaluate_bcl(P: Precomputed, q_df, qb_df):
    """Recompute primes + momentum smoothing after the predictor (reference
    evaluate_bcl, src/mod_layer_terms.F90:198-238), without the face
    extraction of the new primes. Returns (q_df, qprime_df)."""
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
    return q_df, qprime_df


def evaluate_bcl_v1(P, q_df, dpprime, qb_df):
    """Corrector variant: update velocities/primes only, the thickness prime
    `dpprime` kept (reference evaluate_bcl_v1, src/mod_layer_terms.F90:240-270).
    Returns (q_df, qprime_df)."""
    u, v = extract_velocity(P, q_df, qb_df)
    dp = P.dpp_ref_df + q_df[0]
    q_df = torch.stack([q_df[0], u * dp, v * dp])
    u, v = extract_velocity(P, q_df, qb_df)
    qprime_df = torch.stack([dpprime,
                             u - (qb_df[2] / qb_df[0])[None],
                             v - (qb_df[3] / qb_df[0])[None]])
    return q_df, qprime_df


def bcl_mom_update_plain(static, P, g, bc, q_df, rhs_vol, faces, rhs_visc, qb_df,
                         dpprime=None):
    """The end of a half-step in plain torch ops (any device). Returns (the new
    q_df, the new qprime_df)."""
    bcl_mom_update_plain.calls += 1
    rhs_mom = scatter_face_values(rhs_vol, faces, bc)
    # static reference terms dropped by the δ-form kernels (docs/float32.md)
    rhs_mom = rhs_mom + P.bcl_rhs_ref
    rhs_mom = g.massinv * rhs_mom + rhs_visc
    qu_t = q_df[1] + static.dt * rhs_mom[0]
    qv_t = q_df[2] + static.dt * rhs_mom[1]
    if static.ad_mlswe > 0.0:
        qu_t, qv_t = shear_stress_update(static, P, g, q_df, qu_t, qv_t, qb_df)
    qu, qv = _coriolis_rotation(P, qu_t, qv_t, q_df)
    qu, qv = apply_wall_projection(qu, qv, bc)
    q_df = torch.stack([q_df[0], qu, qv])
    if dpprime is None:
        return evaluate_bcl(P, q_df, qb_df)
    return evaluate_bcl_v1(P, q_df, dpprime, qb_df)


bcl_mom_update_plain.calls = 0


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

# the kernel's operands in its order (csrc/bcl_mom_update.cu), each with its
# shape in terms of L, the nodal element shape N (ly, lx, ngl, ngl) and the
# face shape of a direction, x (ly, lx+1) or y (ly+1, lx); "faces.{d}.{c}" is
# the face fluxes' value c (0 SuL, 1 SuR, 2 SvL, 3 SvR) on the faces of
# direction d. rhs_visc (without viscosity) and dpprime (in the predictor)
# may be None
OPERANDS = (
    ("q_df", (3, "L", "N")), ("rhs_vol", (2, "L", "N")), ("P.bcl_rhs_ref", (2, "L", "N")),
    ("rhs_visc", (2, "L", "N")), ("g.massinv", ("N",)),
    *((f"P.{n}", ("N",)) for n in ("fdt2_bcl", "a_bcl", "b_bcl")),
    ("P.dpp_ref_df", ("L", "N")), ("P.sum_ref_residual", ("N",)),
    ("P.one_over_pbprime_df", ("N",)), ("qb_df", (4, "N")), ("dpprime", ("L", "N")),
    *((f"faces.{d}.{c}", ("L", d, "ngl")) for d in "xy" for c in range(4)),
)
OPTIONAL = ("rhs_visc", "dpprime")
# the kernel's launches (csrc/bcl_mom_update.cu, MODE_*): the whole end of the
# half-step; with the shear stress, its first part (to q + dt * rhs) and,
# after the plain shear solve, the rest from the rotation on
WHOLE, FIRST, REST = 0, 1, 2


def _library() -> ctypes.CDLL:
    lib = load_library("bcl_mom_update")
    if not getattr(lib, "_hnumo_declared", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.bcl_mom_update_launch.argtypes = [I] * 11 + [P, ctypes.c_double, P]
        lib.bcl_mom_update_launch.restype = I
        lib.bcl_mom_update_error_string.argtypes = [I]
        lib.bcl_mom_update_error_string.restype = ctypes.c_char_p
        lib.bcl_mom_update_operand_count.argtypes = []
        lib.bcl_mom_update_operand_count.restype = I
        if lib.bcl_mom_update_operand_count() != len(OPERANDS):
            raise RuntimeError(f"csrc/bcl_mom_update.cu takes "
                               f"{lib.bcl_mom_update_operand_count()} operands, "
                               f"ops/bcl_mom_update.OPERANDS names {len(OPERANDS)}")
        lib._hnumo_declared = True
    return lib


def _operands(P, g, q_df, rhs_vol, faces, rhs_visc, qb_df, dpprime):
    """[(name, tensor or None)] in the kernel's order, each checked for its
    shape, dtype, device and contiguity against q_df."""
    dtype, device = q_df.dtype, q_df.device
    L, ly, lx, ngl = q_df.shape[1:5]
    dims = {"L": (L,), "N": (ly, lx, ngl, ngl), "ngl": (ngl,), "x": (ly, lx + 1),
            "y": (ly + 1, lx)}
    scope = {"P": P, "g": g, "q_df": q_df, "rhs_vol": rhs_vol, "faces": faces,
             "rhs_visc": rhs_visc, "qb_df": qb_df, "dpprime": dpprime}
    named = []
    for name, spec in OPERANDS:
        t = _field(scope, name)
        if t is None and name in OPTIONAL:
            named.append((name, None))
            continue
        shape = tuple(n for s in spec for n in (dims[s] if isinstance(s, str) else (s,)))
        if tuple(t.shape) != shape:
            raise ValueError(f"bcl_mom_update_cuda: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"bcl_mom_update_cuda: {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"bcl_mom_update_cuda: {name} is not contiguous")
        named.append((name, t))
    return named


def wall_bits(bc: BCs) -> tuple:
    """(the block's first x-face is a domain wall whose L side is its first
    element, the same of its first y-face (core/faces.scatter_face_x / _y),
    the wall projection's zeroed components (core/faces.apply_wall_projection)
    as bits: 1 u and 2 v at the west edge, 4 u and 8 v at the east, 16 u and
    32 v at the south, 64 u and 128 v at the north)."""
    wfirst, elast = _edge_masks(bc.ax)
    sfirst, nlast = _edge_masks(bc.ay)
    bits = 0
    for shift, code, owner, normal in ((0, bc.west, wfirst, 1), (2, bc.east, elast, 1),
                                       (4, bc.south, sfirst, 2), (6, bc.north, nlast, 2)):
        if owner and code == 4:
            bits |= normal << shift
        elif owner and code in (2, 5):
            bits |= 3 << shift
    xwall = int(not bc.x_periodic and wfirst)
    ywall = int(not bc.y_periodic and sfirst)
    return xwall, ywall, bits


def _launch(lib, mode, static, bc, named, extra, stream):
    """One launch in `mode` (WHOLE, FIRST or REST) on the checked operands
    `named` and the extra pointers `extra` (the two outputs, then qu_t and
    qv_t); raises on a refused launch."""
    q_df = named[0][1]
    L, ly, lx, ngl = q_df.shape[1:5]
    d = dict(named)
    xwall, ywall, bits = wall_bits(bc)
    ptrs = [None if t is None else t.data_ptr() for _, t in named] + extra
    err = lib.bcl_mom_update_launch(
        mode, int(q_df.dtype == torch.float64), L, ngl, ly, lx, xwall, ywall, bits,
        int(d["rhs_visc"] is not None), int(d["dpprime"] is not None),
        (ctypes.c_void_p * len(ptrs))(*ptrs), float(static.dt), stream)
    if err != 0:
        raise RuntimeError(f"bcl_mom_update kernel launch (mode {mode}) failed: CUDA error "
                           f"{err} ({lib.bcl_mom_update_error_string(err).decode()})")
    bcl_mom_update_cuda.launches += 1


def bcl_mom_update_cuda(static, P, g, bc, q_df, rhs_vol, faces, rhs_visc, qb_df,
                        dpprime=None):
    """The end of a half-step as one CUDA kernel launch (csrc/bcl_mom_update.cu),
    or, with the shear stress (ad_mlswe > 0), as two with the plain shear
    solve between them.

    Same operands and result as `bcl_mom_update_plain` (`rhs_visc` a tensor
    or 0.0, `dpprime` a tensor or None); float32 or float64 CUDA tensors,
    all of one dtype on one device, contiguous, at most MAX_LAYERS layers.
    Launches on the current stream and does not synchronise. Raises on
    operands the kernel does not take and on a refused launch; builds the
    kernel at the first call. `bcl_mom_update_cuda.launches` counts the
    launches made, one a call, two with the shear stress."""
    dtype = q_df.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"bcl_mom_update_cuda takes float32/float64, got {dtype}")
    L = q_df.shape[1]
    if L != static.nlayers:
        raise ValueError(f"bcl_mom_update_cuda: q_df has {L} layers, static.nlayers is "
                         f"{static.nlayers}")
    if L > MAX_LAYERS:
        raise ValueError(f"bcl_mom_update_cuda takes at most {MAX_LAYERS} layers, got {L}")
    if not isinstance(rhs_visc, torch.Tensor):
        if rhs_visc != 0.0:
            raise ValueError(f"bcl_mom_update_cuda: rhs_visc is {rhs_visc!r}, expected a "
                             "tensor or 0.0")
        rhs_visc = None
    named = _operands(P, g, q_df, rhs_vol, faces, rhs_visc, qb_df, dpprime)
    if q_df.device.type != "cuda":
        raise ValueError(
            f"bcl_mom_update_cuda takes CUDA tensors, got {q_df.device}; use "
            "bcl_mom_update_plain (impl='plain') on other devices")
    lib = _library()
    q_new, qprime_new = torch.empty_like(q_df), torch.empty_like(q_df)
    outs = [q_new.data_ptr(), qprime_new.data_ptr()]
    with torch.cuda.device(q_df.device):
        stream = torch.cuda.current_stream().cuda_stream
        if static.ad_mlswe > 0.0:
            qt = torch.empty_like(rhs_vol)
            _launch(lib, FIRST, static, bc, named, outs + [qt[0].data_ptr(),
                                                           qt[1].data_ptr()], stream)
            qu_t, qv_t = shear_stress_update(static, P, g, q_df, qt[0], qt[1], qb_df)
            if not (qu_t.is_contiguous() and qv_t.is_contiguous()):
                raise ValueError("bcl_mom_update_cuda: the shear solve's momenta are not "
                                 "contiguous")
            _launch(lib, REST, static, bc, named, outs + [qu_t.data_ptr(), qv_t.data_ptr()],
                    stream)
        else:
            _launch(lib, WHOLE, static, bc, named, outs + [None, None], stream)
    return q_new, qprime_new


bcl_mom_update_cuda.launches = 0
