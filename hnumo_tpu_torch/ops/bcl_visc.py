"""The nodal-family baroclinic viscosity: one CUDA kernel and its plain
version.

The body of core/viscosity.bcl_nodal_laplacian (reference
bcl_create_laplacian + bcl_compute_laplacian + bcl_create_rhs_laplacian_flux,
src/mod_laplacian_quad.F90:227-248, 392-425, 521-611): the LDG flux
dpprime_visc * graduvb_ave + dpp_graduv and its weak-form divergence on the
nodal quadrature, the flip-flop face flux of both directions from the
two-sided face arrays, the ± scatter into the elements' edges, and
visc_mlswe * massinv. Returns rhs_lap (2, L, nodal).

No TPU kernel of the JAX package covers this function: there XLA fuses it.
In plain PyTorch it is ~100 small operations a call, launch-bound on the
card; the kernel does the same work in one launch.

  bcl_visc_cuda   csrc/bcl_visc.cu, f32 and f64, CUDA tensors only
  bcl_visc_plain  the same function in torch ops, any device; the CPU tests,
      `device="cpu"` models and the kernel's yardstick on the card
Both take (static, P, g, bc, coup, avg) as core/viscosity does. Neither
falls back to the other; neither mutates its operands.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.faces import _edge_masks, apply_face_plus_minus
from ._build import load_library
from .dg import scatter_volume_nodal

# the most nodes an element side (csrc/bcl_visc.cu, MAX_NGL): one thread a
# node of an element, 32 x 32 in a block
MAX_NGL = 32


def bcl_visc_plain(static, P, g, bc, coup, avg):
    """Nodal-family baroclinic viscosity in plain torch ops (any device)."""
    bcl_visc_plain.calls += 1
    # volume: qq = dpprime_visc_k * graduvb_ave + dpp_graduv_k   (4, L, nodal)
    qq = coup.dpprime_visc[None] * avg.graduvb[:, None] + coup.dpp_graduv
    rhs_u = -scatter_volume_nodal(g, qq[0], qq[1])
    rhs_v = -scatter_volume_nodal(g, qq[2], qq[3])

    def face_dir(gdpp, gvavg, fg):
        # gdpp: (5, 2, L, F, ngl) layer coefficient faces;
        # gvavg L/R: (4, F, ngl) graduvb_face_ave
        fl = gdpp[4, 0] * gvavg[0][:, None] + gdpp[:4, 0]   # (4, L, F, ngl)
        fr = gdpp[4, 1] * gvavg[1][:, None] + gdpp[:4, 1]
        qmean = 0.5 * (fl + fr)
        flux_qu = (qmean[0] - fl[0] * fg.nx_df) + (qmean[1] - fl[1] * fg.ny_df)
        flux_qv = (qmean[2] - fl[2] * fg.nx_df) + (qmean[3] - fl[3] * fg.ny_df)
        return fg.jac_df * flux_qu, fg.jac_df * flux_qv

    SxU, SxV = face_dir(coup.graduv_dpp_face.x, (avg.faces.x.gvL, avg.faces.x.gvR), P.faces.x)
    SyU, SyV = face_dir(coup.graduv_dpp_face.y, (avg.faces.y.gvL, avg.faces.y.gvR), P.faces.y)
    rhs_u, rhs_v = apply_face_plus_minus(rhs_u, rhs_v, SxU, SxV, SyU, SyV, bc)
    return static.visc_mlswe * g.massinv * torch.stack([rhs_u, rhs_v])


bcl_visc_plain.calls = 0


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

# the kernel's operands in its order (csrc/bcl_visc.cu), each with its shape
# in terms of L, the nodal element shape N (ly, lx, ngl, ngl) and the face
# shape F.. of a direction ((ly, lx+1) for x, (ly+1, lx) for y). The face
# averages gvL / gvR need only each channel contiguous: on the flat face
# paths they are views of one accumulator of both directions
OPERANDS = (
    ("coup.dpprime_visc", ("L", "N")), ("avg.graduvb", (4, "N")),
    ("coup.dpp_graduv", (4, "L", "N")),
    *((f"g.{n}", ("N",)) for n in ("ksi_x", "ksi_y", "eta_x", "eta_y", "wjac_df", "massinv")),
    ("g.dpsi", ("ngl", "ngl")),
    *(op for d in "xy" for op in (
        (f"coup.graduv_dpp_face.{d}", (5, 2, "L", d, "ngl")),
        (f"avg.faces.{d}.gvL", (4, d, "ngl")), (f"avg.faces.{d}.gvR", (4, d, "ngl")),
        *((f"P.faces.{d}.{n}", (d, "ngl")) for n in ("nx_df", "ny_df", "jac_df")))),
)
# the operands whose channels may lie apart
CHANNEL_STRIDED = ("avg.faces.x.gvL", "avg.faces.x.gvR", "avg.faces.y.gvL", "avg.faces.y.gvR")


def _library() -> ctypes.CDLL:
    lib = load_library("bcl_visc")
    if not getattr(lib, "_hnumo_declared", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.bcl_visc_launch.argtypes = [I] * 7 + [P, P, P, ctypes.c_double, P]
        lib.bcl_visc_launch.restype = I
        lib.bcl_visc_error_string.argtypes = [I]
        lib.bcl_visc_error_string.restype = ctypes.c_char_p
        lib.bcl_visc_operand_count.argtypes = []
        lib.bcl_visc_operand_count.restype = I
        if lib.bcl_visc_operand_count() != len(OPERANDS):
            raise RuntimeError(f"csrc/bcl_visc.cu takes {lib.bcl_visc_operand_count()} "
                               f"operands, ops/bcl_visc.OPERANDS names {len(OPERANDS)}")
        lib._hnumo_declared = True
    return lib


def _field(scope, name):
    head, *path = name.split(".")
    t = scope[head]
    for p in path:
        t = getattr(t, p)
    return t


def _channels_contiguous(t) -> bool:
    """Each t[c] is contiguous (the channels themselves may lie apart)."""
    return t.shape[0] == 0 or t[0].is_contiguous()


def bcl_visc_cuda(static, P, g, bc, coup, avg):
    """The nodal-family baroclinic viscosity as one CUDA kernel launch
    (csrc/bcl_visc.cu).

    Same operands and result as `bcl_visc_plain`; float32 or float64 CUDA
    tensors, all of one dtype on one device, contiguous (gvL and gvR: each
    channel contiguous), at most MAX_NGL nodes an element side. Launches on
    the current stream and does not synchronise. Raises on operands the
    kernel does not take and on a refused launch; builds the kernel at the
    first call. `bcl_visc_cuda.launches` counts the launches made."""
    dtype = g.dpsi.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"bcl_visc_cuda takes float32/float64, got {dtype}")
    ngl = g.dpsi.shape[0]
    if ngl > MAX_NGL:
        raise ValueError(f"bcl_visc_cuda takes at most {MAX_NGL} nodes an element side, "
                         f"got {ngl}")
    L = coup.dpprime_visc.shape[0]
    ly, lx = coup.dpprime_visc.shape[1:3]
    dims = {"L": (L,), "N": (ly, lx, ngl, ngl), "ngl": (ngl,), "x": (ly, lx + 1),
            "y": (ly + 1, lx)}
    scope = {"P": P, "g": g, "coup": coup, "avg": avg}
    named = []
    for name, spec in OPERANDS:
        t = _field(scope, name)
        shape = tuple(d for s in spec for d in (dims[s] if isinstance(s, str) else (s,)))
        if tuple(t.shape) != shape:
            raise ValueError(f"bcl_visc_cuda: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != g.dpsi.device or t.dtype != dtype:
            raise ValueError(f"bcl_visc_cuda: {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {g.dpsi.device}")
        if not (_channels_contiguous(t) if name in CHANNEL_STRIDED else t.is_contiguous()):
            raise ValueError(f"bcl_visc_cuda: {name} is not contiguous")
        named.append((name, t))
    if g.dpsi.device.type != "cuda":
        raise ValueError(
            f"bcl_visc_cuda takes CUDA tensors, got {g.dpsi.device}; use "
            "bcl_visc_plain (flux_impl='plain') on other devices")
    # the first face of each direction is a domain wall whose interior
    # element is its L side (core/faces.scatter_face_x / _y)
    wall_w = int(not bc.x_periodic and _edge_masks(bc.ax)[0])
    wall_s = int(not bc.y_periodic and _edge_masks(bc.ay)[0])
    strides = (ctypes.c_longlong * 4)(*(_field(scope, n).stride(0) for n in CHANNEL_STRIDED))
    out = torch.empty((2, L, ly, lx, ngl, ngl), dtype=dtype, device=g.dpsi.device)
    lib = _library()
    ptrs = (ctypes.c_void_p * len(named))(*(t.data_ptr() for _, t in named))
    with torch.cuda.device(g.dpsi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bcl_visc_launch(int(dtype == torch.float64), L, ngl, ly, lx, wall_w, wall_s,
                                  ptrs, strides, out.data_ptr(), float(static.visc_mlswe),
                                  stream)
    if err != 0:
        raise RuntimeError(f"bcl_visc kernel launch failed: CUDA error {err} "
                           f"({lib.bcl_visc_error_string(err).decode()})")
    bcl_visc_cuda.launches += 1
    return out


bcl_visc_cuda.launches = 0
