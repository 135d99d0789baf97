"""The barotropic-baroclinic coupling coefficients: two CUDA kernels and their
plain version.

The body of core/coupling.btp_bcl_coeffs (reference btp_bcl_coeffs_qdf,
src/mod_barotropic_terms.F90:219-409): the volume quad-point coefficients
(the advective sums Q_uu_dp, Q_uv_dp, Q_vv_dp and the δ-form pressure
dH_bcl), the edge coefficients of both face directions, and, with
viscosity, the nodal-family viscosity coefficient fields (dpp_graduv, its
layer sums, pbprime_visc, their face traces and the traces' layer sums).
Returns the CouplingFields that every barotropic substep reads.

No TPU kernel of the JAX package covers this function: there XLA fuses it.
In plain PyTorch it is ~200 small operations a call, launch-bound on the
card; the kernels do the same work in two launches, the element work (stage
0) and the face work (stage 1), with the viscous face traces built between
them by core/faces.extract_faces_stacked, as the plain version builds them:
a decomposition's halo exchange stays there, outside the kernels.

  bcl_coeffs_cuda   csrc/bcl_coeffs.cu, f32 and f64, CUDA tensors only
  bcl_coeffs_plain  the same function in torch ops, any device; the CPU tests,
      `device="cpu"` models and the kernels' yardstick on the card
Both take (static, P, g, bc, qprime_df, qprime_faces, dpprime_visc,
dpprime_visc_q) as core/coupling does. Neither falls back to the other;
neither mutates its operands.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import coupling
from ..core.faces import BCs, extract_faces_multi, extract_faces_stacked, face_n2q
from ..core.types import CouplingFields, Pair, Precomputed
from ._build import load_library
from .dg import DeviceGeom, grad_nodal, interp_n2q

# the most layers a column carries (csrc/bcl_coeffs.cu, LMAX; as ops/bcl_flux)
MAX_LAYERS = 64
# the most quadrature points an element side (csrc/bcl_coeffs.cu, MAX_NQ): one
# thread a point of the element, 17 x 17 for p=8
MAX_NQ = 17
# the viscous stack's channel pairs that mirror as vectors at walls: the
# gradients of u' and of v'; channel 4, dpprime_visc, copies
VEC_PAIRS = ((0, 1), (2, 3))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def bcl_coeffs_plain(
    static,
    P: Precomputed,
    g: DeviceGeom,
    bc: BCs,
    qprime_df,        # (3, L, nodal)
    qprime_faces,     # tuple of 3 FaceLR (dp', u', v') nodal traces per layer
    dpprime_visc,     # (L, nodal)
    dpprime_visc_q,   # (L, quad) or zeros
) -> CouplingFields:
    """The coupling coefficients in plain torch ops (any device)."""
    bcl_coeffs_plain.calls += 1
    delta_pressure_H = coupling.delta_pressure_H
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
            vec_pairs=VEC_PAIRS)

        def stack_dir(sel_l, sel_r):
            L = torch.stack([sel_l(f) for f in f5])
            R = torch.stack([sel_r(f) for f in f5])
            return torch.stack([L, R], dim=1)   # (5, 2, L, F, ngl)

        gface_x = stack_dir(lambda f: f.xl, lambda f: f.xr)
        gface_y = stack_dir(lambda f: f.yl, lambda f: f.yr)
        btp_gface_x = torch.sum(gface_x, dim=2)
        btp_gface_y = torch.sum(gface_y, dim=2)
    else:
        (dpp_graduv, btp_dpp_graduv, pbprime_visc, gface_x, gface_y, btp_gface_x,
         btp_gface_y) = _no_visc(qprime_df, fdp)

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


bcl_coeffs_plain.calls = 0


def _no_visc(qprime_df, fdp):
    """The viscosity fields without viscosity, all zero: (dpp_graduv,
    btp_dpp_graduv, pbprime_visc, graduv_dpp_face x, y, btp_graduv_dpp_face
    x, y)."""
    z_nod = torch.zeros_like(qprime_df[0, 0])
    opts = dict(dtype=z_nod.dtype, device=z_nod.device)
    gface_x = torch.zeros((5, 2) + fdp.xl.shape, **opts)
    gface_y = torch.zeros((5, 2) + fdp.yl.shape, **opts)
    return (torch.zeros((4,) + qprime_df.shape[1:], **opts),
            torch.zeros((4,) + z_nod.shape, **opts), z_nod, gface_x, gface_y,
            torch.sum(gface_x, dim=2), torch.sum(gface_y, dim=2))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

# the kernels' operands in their order (csrc/bcl_coeffs.cu), each with its
# shape in terms of L, the nodal (ly, lx, ngl, ngl) and quad (ly, lx, nq, nq)
# element shapes N and Q, and the face shape of a direction, x (ly, lx+1) or
# y (ly+1, lx): the element operands, then those of the x-faces, then those of
# the y-faces. "qprime_faces.{c}.{d}l" is the L-side trace of channel c
# (0 δdp', 1 u', 2 v') on the faces of direction d
ELEMENT_OPERANDS = (
    ("qprime_df", (3, "L", "N")), ("dpprime_visc", ("L", "N")),
    ("P.dpp_ref_q", ("L", "Q")), ("P.P_ref_q", ("L+1", "Q")), ("P.alpha", ("L",)),
    *((f"g.{n}", ("N",)) for n in ("ksi_x", "ksi_y", "eta_x", "eta_y")),
    ("g.psiq", ("ngl", "nq")), ("g.dpsi", ("ngl", "ngl")),
)


def face_operands(d: str) -> tuple:
    """The operands of the faces of direction `d` ("x" | "y"), in the kernels' order."""
    return (
        *((f"qprime_faces.{c}.{d}{s}", ("L", d, "ngl")) for c in range(3) for s in "lr"),
        (f"P.faces.{d}.dpp_ref_face_q", ("L", d, "nq")),
        (f"P.faces.{d}.P_ref_edge", ("L+1", d, "nq")),
    )


OPERANDS = ELEMENT_OPERANDS + face_operands("x") + face_operands("y")


def _library() -> ctypes.CDLL:
    lib = load_library("bcl_coeffs")
    if not getattr(lib, "_hnumo_declared", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.bcl_coeffs_launch.argtypes = [I] * 8 + [P, P]
        lib.bcl_coeffs_launch.restype = I
        lib.bcl_coeffs_error_string.argtypes = [I]
        lib.bcl_coeffs_error_string.restype = ctypes.c_char_p
        lib.bcl_coeffs_operand_count.argtypes = []
        lib.bcl_coeffs_operand_count.restype = I
        if lib.bcl_coeffs_operand_count() != len(OPERANDS):
            raise RuntimeError(f"csrc/bcl_coeffs.cu takes {lib.bcl_coeffs_operand_count()} "
                               f"operands, ops/bcl_coeffs.OPERANDS names {len(OPERANDS)}")
        lib._hnumo_declared = True
    return lib


def _field(scope, name):
    head, *path = name.split(".")
    t = scope[head]
    for p in path:
        t = t[int(p)] if p.isdigit() else getattr(t, p)
    return t


def _operands(P, g, qprime_df, qprime_faces, dpprime_visc):
    """[(name, tensor)] in the kernels' order, each checked for its shape,
    dtype, device and contiguity against g.psiq."""
    dtype, device = g.psiq.dtype, g.psiq.device
    L = P.dpp_ref_q.shape[0]
    ngl, nq = g.psiq.shape
    ly, lx = qprime_df.shape[2:4]
    dims = {"L": (L,), "L+1": (L + 1,), "N": (ly, lx, ngl, ngl), "Q": (ly, lx, nq, nq),
            "ngl": (ngl,), "nq": (nq,), "x": (ly, lx + 1), "y": (ly + 1, lx)}
    scope = {"P": P, "g": g, "qprime_df": qprime_df, "qprime_faces": qprime_faces,
             "dpprime_visc": dpprime_visc}
    named = []
    for name, spec in OPERANDS:
        t = _field(scope, name)
        shape = tuple(n for s in spec for n in (dims[s] if isinstance(s, str) else (s,)))
        if tuple(t.shape) != shape:
            raise ValueError(f"bcl_coeffs_cuda: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"bcl_coeffs_cuda: {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"bcl_coeffs_cuda: {name} is not contiguous")
        named.append((name, t))
    return named


def _launch(lib, stage, shape, visc, ptrs, stream):
    """One launch of `stage`; raises on a refused launch."""
    err = lib.bcl_coeffs_launch(stage, *shape, int(visc),
                                (ctypes.c_void_p * len(ptrs))(*ptrs), stream)
    if err != 0:
        raise RuntimeError(f"bcl_coeffs kernel launch (stage {stage}) failed: CUDA error "
                           f"{err} ({lib.bcl_coeffs_error_string(err).decode()})")


# the kernels' outputs (_buffers' keys), in the order their pointers follow
# OPERANDS' (csrc/bcl_coeffs.cu, xVol ... xGsumY)
OUTPUTS = ("vol", "nod", "nsum", "edge_x", "edge_y", "gface_x", "gface_y", "gsum_x", "gsum_y")


def _buffers(g, named, visc):
    """The kernels' outputs for the checked operands `named`: (the volume
    coefficients (4, quad); the viscous stack (5, L, nodal) and its layer sums
    (5, nodal); the edge coefficients (4, F, nq), the viscous face traces (5,
    2, L, F, ngl) and their layer sums (5, 2, F, ngl) of each direction), the
    viscous ones None without viscosity; and the launches' sizes."""
    qp = dict(named)["qprime_df"]
    dtype, device = qp.dtype, qp.device
    L, ly, lx = qp.shape[1:4]
    ngl, nq = g.psiq.shape

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    fx, fy = (ly, lx + 1), (ly + 1, lx)
    bufs = dict(vol=empty(4, ly, lx, nq, nq), edge_x=empty(4, *fx, nq),
                edge_y=empty(4, *fy, nq))
    if visc:
        bufs.update(nod=empty(5, L, ly, lx, ngl, ngl), nsum=empty(5, ly, lx, ngl, ngl),
                    gface_x=empty(5, 2, L, *fx, ngl), gface_y=empty(5, 2, L, *fy, ngl),
                    gsum_x=empty(5, 2, *fx, ngl), gsum_y=empty(5, 2, *fy, ngl))
    shape = (int(dtype == torch.float64), L, ngl, nq, ly, lx)
    return bufs, shape


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run(lib, static, bc, g, named, stream):
    """The two launches and the viscous traces between them, on the checked
    operands `named`; returns the CouplingFields' tensors that the kernels
    write."""
    visc = static.use_visc
    b, shape = _buffers(g, named, visc)
    ptrs = [t.data_ptr() for _, t in named] + [_ptr(b.get(k)) for k in OUTPUTS]
    _launch(lib, 0, shape, visc, ptrs + [None] * 4, stream)
    traces = [None] * 4
    if visc:
        # vector mirrors on (0, 1) and (2, 3) at walls, dpprime_visc copies
        traces = extract_faces_stacked(b["nod"], bc, vec_pairs=VEC_PAIRS)
        if not all(t.is_contiguous() for t in traces):
            raise ValueError("bcl_coeffs_cuda: a viscous trace of extract_faces_stacked is "
                             "not contiguous")
    _launch(lib, 1, shape, visc, ptrs + [_ptr(t) for t in traces], stream)
    bcl_coeffs_cuda.launches += 2
    return b


def bcl_coeffs_cuda(static, P, g, bc, qprime_df, qprime_faces, dpprime_visc,
                    dpprime_visc_q) -> CouplingFields:
    """The coupling coefficients as two CUDA kernel launches
    (csrc/bcl_coeffs.cu) with core/faces.extract_faces_stacked of the viscous
    stack between them.

    Same operands and result as `bcl_coeffs_plain` (the same shapes, dtypes
    and contiguous layouts; `dpprime_visc` and `dpprime_visc_q` passed
    through); float32 or float64 CUDA tensors, all of one dtype on one
    device, contiguous, at most MAX_LAYERS layers and MAX_NQ quadrature
    points an element side. Launches on the current stream and does not
    synchronise. Raises on operands the kernels do not take and on a refused
    launch; builds the kernels at the first call. `bcl_coeffs_cuda.launches`
    counts the launches made, two a call."""
    dtype = g.psiq.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"bcl_coeffs_cuda takes float32/float64, got {dtype}")
    L = P.dpp_ref_q.shape[0]
    nq = g.psiq.shape[1]
    if L != static.nlayers:
        raise ValueError(f"bcl_coeffs_cuda: P.dpp_ref_q has {L} layers, static.nlayers is "
                         f"{static.nlayers}")
    if L > MAX_LAYERS:
        raise ValueError(f"bcl_coeffs_cuda takes at most {MAX_LAYERS} layers, got {L}")
    if nq > MAX_NQ:
        raise ValueError(f"bcl_coeffs_cuda takes at most {MAX_NQ} quadrature points an "
                         f"element side, got {nq}")
    named = _operands(P, g, qprime_df, qprime_faces, dpprime_visc)
    if g.psiq.device.type != "cuda":
        raise ValueError(
            f"bcl_coeffs_cuda takes CUDA tensors, got {g.psiq.device}; use "
            "bcl_coeffs_plain (impl='plain') on other devices")
    lib = _library()
    with torch.cuda.device(g.psiq.device):
        b = _run(lib, static, bc, g, named, torch.cuda.current_stream().cuda_stream)
    vol, ex, ey = b["vol"], b["edge_x"], b["edge_y"]
    if static.use_visc:
        nod, nsum = b["nod"], b["nsum"]
        visc = (nod[:4], nsum[:4], nsum[4], b["gface_x"], b["gface_y"], b["gsum_x"],
                b["gsum_y"])
    else:
        visc = _no_visc(qprime_df, qprime_faces[0])
    dpp_graduv, btp_dpp_graduv, pbprime_visc, gface_x, gface_y, bgx, bgy = visc
    return CouplingFields(
        Q_uu_dp=vol[0], Q_uv_dp=vol[1], Q_vv_dp=vol[2], dH_bcl=vol[3],
        Q_uu_dp_edge=Pair(ex[0], ey[0]), Q_uv_dp_edge=Pair(ex[1], ey[1]),
        Q_vv_dp_edge=Pair(ex[2], ey[2]), dH_bcl_edge=Pair(ex[3], ey[3]),
        dpp_graduv=dpp_graduv, btp_dpp_graduv=btp_dpp_graduv,
        pbprime_visc=pbprime_visc, dpprime_visc=dpprime_visc,
        dpprime_visc_q=dpprime_visc_q,
        graduv_dpp_face=Pair(gface_x, gface_y),
        btp_graduv_dpp_face=Pair(bgx, bgy),
    )


bcl_coeffs_cuda.launches = 0
