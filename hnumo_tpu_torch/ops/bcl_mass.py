"""The thickness update of the baroclinic step: two CUDA kernels and their
plain version.

The body of core/stepper._thickness_update (reference thickness and
momentum_mass, mass part, src/mod_splitting.F90:55-87, 220-235): the layer
mass update (layer_mass_rhs: the interpolated mass fluxes, their weak-form
integral, the upwind face fluxes and their scatter into the elements' edges,
the inverse mass), the negative-thickness check on the full thickness
(src/mod_splitting.F90:74-77), and the flux-adjustment mass consistency
(apply_consistency, Higdon 2015). Returns the new q_df and this block's
`ok`; the caller and-reduces `ok` over the blocks of a decomposition.

No TPU kernel of the JAX package covers these functions: there XLA fuses
them. In plain PyTorch they are ~255 small operations a call, launch-bound on
the card; the kernels do the same work in two launches, the mass update and
the check (stage 0) and the consistency (stage 1), with the new δdp' face
traces built between them by core/faces.extract_faces, as the plain version
builds them: a decomposition's halo exchange stays there, outside the kernels.

  bcl_mass_cuda   csrc/bcl_mass.cu, f32 and f64, CUDA tensors only
  bcl_mass_plain  the same function in torch ops, any device; the CPU tests,
      `device="cpu"` models and the kernels' yardstick on the card
Both take (static, P, g, bc, avg, q_df, qprime_df, qprime_faces) as
core/stepper does. Neither falls back to the other; neither mutates its
operands.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.faces import (BCs, _edge_masks, extract_faces, face_n2q, face_quad_scatter,
                          scatter_face_x, scatter_face_y)
from ..core.types import BtpAverages, Pair, Precomputed
from ._build import load_library
from .dg import DeviceGeom, interp_n2q, scatter_volume

# the most layers a column carries (csrc/bcl_mass.cu, LMAX; as ops/bcl_flux)
MAX_LAYERS = 64
# the most quadrature points an element side (csrc/bcl_mass.cu, MAX_NQ): one
# thread a point of the element, 17 x 17 for p=8
MAX_NQ = 17


# ---------------------------------------------------------------------------
# the plain version
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


def bcl_mass_plain(static, P, g, bc, avg, q_df, qprime_df, qprime_faces):
    """The thickness update in plain torch ops (any device): mass update,
    negative-thickness check, consistency. Returns (new q_df, this block's
    ok)."""
    bcl_mass_plain.calls += 1
    dp_advec, slmf, slmf_face = layer_mass_rhs(
        static, P, g, bc, avg, qprime_df, qprime_faces)
    q_df = torch.cat([(q_df[0] + static.dt * dp_advec)[None], q_df[1:]])
    # q_df[0] stores δdp; the abort checks the FULL thickness (reference
    # src/mod_splitting.F90:74-77)
    ok = torch.all(P.dpp_ref_df + q_df[0] >= 0.0)
    q_df = apply_consistency(static, P, g, bc, avg, q_df, slmf, slmf_face)
    return q_df, ok


bcl_mass_plain.calls = 0


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

# the kernels' operands in their order (csrc/bcl_mass.cu), each with its shape
# in terms of L, the nodal (ly, lx, ngl, ngl) and quad (ly, lx, nq, nq)
# element shapes N and Q, and the face shape of a direction, x (ly, lx+1) or
# y (ly+1, lx): the element operands, then those of the x-faces, then those of
# the y-faces. "qprime_faces.{c}.{d}l" is the L-side trace of channel c
# (0 δdp', 1 u', 2 v') on the faces of direction d
ELEMENT_OPERANDS = (
    ("qprime_df", (3, "L", "N")), ("q_df", (3, "L", "N")), ("P.dpp_ref_df", ("L", "N")),
    ("P.sum_ref_residual", ("N",)), ("P.one_over_pbprime_df", ("N",)), ("g.massinv", ("N",)),
    ("P.dpp_ref_q", ("L", "Q")), ("P.pbprime", ("Q",)),
    *((f"avg.{n}", ("Q",)) for n in ("mu", "ub", "vb", "mfU", "mfV")),
    *((f"g.{n}", ("Q",)) for n in ("ksiq_x", "ksiq_y", "etaq_x", "etaq_y", "wjac")),
    ("g.psiq", ("ngl", "nq")), ("g.dpsiq", ("ngl", "nq")),
)


def face_operands(d: str) -> tuple:
    """The operands of the faces of direction `d` ("x" | "y"), in the kernels' order."""
    return (
        *((f"qprime_faces.{c}.{d}{s}", ("L", d, "ngl")) for c in range(3) for s in "lr"),
        *((f"avg.faces.{d}.{n}", (d, "nq"))
          for n in ("ubL", "ubR", "vbL", "vbR", "muL", "muR", "fluxU", "fluxV")),
        *((f"P.faces.{d}.{n}", (d, "nq"))
          for n in ("nx", "ny", "jac", "pbprime_face_L", "pbprime_face_R")),
        (f"P.faces.{d}.dpp_ref_face_q", ("L", d, "nq")),
    )


OPERANDS = ELEMENT_OPERANDS + face_operands("x") + face_operands("y")


def _library() -> ctypes.CDLL:
    lib = load_library("bcl_mass")
    if not getattr(lib, "_hnumo_declared", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.bcl_mass_launch.argtypes = [I] * 9 + [P, ctypes.c_double, P]
        lib.bcl_mass_launch.restype = I
        lib.bcl_mass_elements_per_block.argtypes = [I] * 3
        lib.bcl_mass_elements_per_block.restype = I
        lib.bcl_mass_error_string.argtypes = [I]
        lib.bcl_mass_error_string.restype = ctypes.c_char_p
        lib.bcl_mass_operand_count.argtypes = []
        lib.bcl_mass_operand_count.restype = I
        if lib.bcl_mass_operand_count() != len(OPERANDS):
            raise RuntimeError(f"csrc/bcl_mass.cu takes {lib.bcl_mass_operand_count()} "
                               f"operands, ops/bcl_mass.OPERANDS names {len(OPERANDS)}")
        lib._hnumo_declared = True
    return lib


def _field(scope, name):
    head, *path = name.split(".")
    t = scope[head]
    for p in path:
        t = t[int(p)] if p.isdigit() else getattr(t, p)
    return t


def _operands(P, g, avg, q_df, qprime_df, qprime_faces):
    """[(name, tensor)] in the kernels' order, each checked for its shape,
    dtype, device and contiguity against g.psiq."""
    dtype, device = g.psiq.dtype, g.psiq.device
    L = P.dpp_ref_df.shape[0]
    ngl, nq = g.psiq.shape
    ly, lx = qprime_df.shape[2:4]
    dims = {"L": (L,), "N": (ly, lx, ngl, ngl), "Q": (ly, lx, nq, nq), "ngl": (ngl,),
            "nq": (nq,), "x": (ly, lx + 1), "y": (ly + 1, lx)}
    scope = {"P": P, "g": g, "avg": avg, "q_df": q_df, "qprime_df": qprime_df,
             "qprime_faces": qprime_faces}
    named = []
    for name, spec in OPERANDS:
        t = _field(scope, name)
        shape = tuple(n for s in spec for n in (dims[s] if isinstance(s, str) else (s,)))
        if tuple(t.shape) != shape:
            raise ValueError(f"bcl_mass_cuda: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"bcl_mass_cuda: {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"bcl_mass_cuda: {name} is not contiguous")
        named.append((name, t))
    return named


def _launch(lib, stage, static, bc, ptrs, shape, stream):
    """One launch of `stage`; raises on a refused launch."""
    is_double, L, ngl, nq, ly, lx = shape
    # the first face of each direction is a domain wall whose interior
    # element is its L side (core/faces.scatter_face_x / _y)
    wall_w = int(not bc.x_periodic and _edge_masks(bc.ax)[0])
    wall_s = int(not bc.y_periodic and _edge_masks(bc.ay)[0])
    err = lib.bcl_mass_launch(stage, is_double, L, ngl, nq, ly, lx, wall_w, wall_s,
                              (ctypes.c_void_p * len(ptrs))(*ptrs), float(static.dt), stream)
    if err != 0:
        raise RuntimeError(f"bcl_mass kernel launch (stage {stage}) failed: CUDA error {err} "
                           f"({lib.bcl_mass_error_string(err).decode()})")


def _buffers(lib, g, named):
    """The kernels' outputs and scratch for the checked operands `named`:
    (their tensors: new q_df, the new δdp', the layer sums at the quad points
    and at the x- and y-faces, the `ok` flag of each stage-0 block; the
    pointer list of both launches less the four δdp' traces; the launches'
    sizes). The tensors must live until both launches are enqueued."""
    q_df = dict(named)["q_df"]
    dtype, device = q_df.dtype, q_df.device
    L, ly, lx = q_df.shape[1:4]
    ngl, nq = g.psiq.shape
    is_double = int(dtype == torch.float64)
    epb = lib.bcl_mass_elements_per_block(is_double, ngl, nq)
    if epb < 1:
        raise ValueError(f"bcl_mass_cuda: one element at ngl={ngl}, nq={nq} needs more "
                         "shared memory than a block has")

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    bufs = (torch.empty_like(q_df), empty(L, ly, lx, ngl, ngl), empty(2, ly, lx, nq, nq),
            empty(2, ly, lx + 1, nq), empty(2, ly + 1, lx, nq),
            torch.empty((ly * lx + epb - 1) // epb, dtype=torch.bool, device=device))
    ptrs = [t.data_ptr() for _, t in named] + [t.data_ptr() for t in bufs]
    return bufs, ptrs, (is_double, L, ngl, nq, ly, lx)


def _run(lib, static, P, g, bc, named, stream):
    """The two launches and the δdp' traces between them, on the checked
    operands `named`; returns (new q_df, ok)."""
    bufs, ptrs, shape = _buffers(lib, g, named)
    out, dpp, flags = bufs[0], bufs[1], bufs[-1]
    _launch(lib, 0, static, bc, ptrs + [None] * 4, shape, stream)
    fdp, _ = extract_faces(dpp, bc)                          # scalar copy at walls
    traces = (fdp.xl, fdp.xr, fdp.yl, fdp.yr)
    if not all(t.is_contiguous() for t in traces):
        raise ValueError("bcl_mass_cuda: a δdp' trace of extract_faces is not contiguous")
    _launch(lib, 1, static, bc, ptrs + [t.data_ptr() for t in traces], shape, stream)
    bcl_mass_cuda.launches += 2
    return out, torch.all(flags)


def bcl_mass_cuda(static, P, g, bc, avg, q_df, qprime_df, qprime_faces):
    """The thickness update as two CUDA kernel launches (csrc/bcl_mass.cu)
    with core/faces.extract_faces between them.

    Same operands and result as `bcl_mass_plain`; float32 or float64 CUDA
    tensors, all of one dtype on one device, contiguous, at most MAX_LAYERS
    layers and MAX_NQ quadrature points an element side. Launches on the
    current stream and does not synchronise. Raises on operands the kernels
    do not take and on a refused launch; builds the kernels at the first
    call. `bcl_mass_cuda.launches` counts the launches made, two a call."""
    dtype = g.psiq.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"bcl_mass_cuda takes float32/float64, got {dtype}")
    L = P.dpp_ref_df.shape[0]
    nq = g.psiq.shape[1]
    if L != static.nlayers:
        raise ValueError(f"bcl_mass_cuda: P.dpp_ref_df has {L} layers, static.nlayers is "
                         f"{static.nlayers}")
    if L > MAX_LAYERS:
        raise ValueError(f"bcl_mass_cuda takes at most {MAX_LAYERS} layers, got {L}")
    if nq > MAX_NQ:
        raise ValueError(f"bcl_mass_cuda takes at most {MAX_NQ} quadrature points an "
                         f"element side, got {nq}")
    named = _operands(P, g, avg, q_df, qprime_df, qprime_faces)
    if g.psiq.device.type != "cuda":
        raise ValueError(
            f"bcl_mass_cuda takes CUDA tensors, got {g.psiq.device}; use "
            "bcl_mass_plain (impl='plain') on other devices")
    lib = _library()
    with torch.cuda.device(g.psiq.device):
        return _run(lib, static, P, g, bc, named, torch.cuda.current_stream().cuda_stream)


bcl_mass_cuda.launches = 0
