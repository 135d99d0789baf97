"""The least time the card could take for one launch of each of the port's
five barotropic kernels, from the shapes of a configuration.

A frozen copy of the counts of hnumo_tpu_torch/tools/_measure.py
(`volume_bound`, `mega_bound`, `fused_bounds`): every operand read once and
every result written once over the HBM rate, against the flops (2 per
multiply-add of the loops, plus the pointwise blocks counted by hand from
the kernels' sources) over the float32 peak. The peaks are the published
ones of one H100 SXM (NVIDIA data sheet), at its full 700 W.
"""
from __future__ import annotations

import math
from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# the five kernels, by the symbol a trace or a graph node names them with
KERNEL_SYMBOLS = {"btp_volume": "btp_volume_kernel", "btp_mega": "btp_mega_kernel",
                  "btp_volume_uni": "btp_volume_uni_kernel", "btp_faces": "btp_faces_kernel",
                  "btp_update": "btp_update_kernel"}

# test cases whose bottom is flat (grad z_bot == 0): the uniform-geometry
# kernels then read 6 rows of pressure tables, not 8
FLAT_BOTTOM_CASES = ("double_gyre", "double-gyre", "bump")


class Shape(NamedTuple):
    ngl: int          # nodes per element side
    nq: int           # quadrature points per element side
    nelx: int
    nely: int
    nsub: int         # barotropic stages of one solve (N_btp * kstages)
    visc: bool        # horizontal viscosity on
    flat_bottom: bool
    itemsize: int     # bytes of one value


def shape_of(cfg: dict) -> Shape:
    """The shapes of a configuration's `config` (Config fields), whole grid."""
    nop = cfg["nopx"]
    nq = 2 * nop + 1 if cfg.get("dg_integ_exact", True) else 2 * nop - 1
    n_btp = math.ceil(cfg["dt"] / cfg["dt_btp"])
    return Shape(ngl=nop + 1, nq=nq, nelx=cfg["nelx"], nely=cfg["nely"],
                 nsub=n_btp * cfg.get("kstages", 5),
                 visc=cfg.get("visc_mlswe", 0.0) != 0.0,
                 flat_bottom=cfg["test_case"] in FLAT_BOTTOM_CASES,
                 itemsize=8 if cfg.get("dtype", "float64") == "float64" else 4)


def _bound(nbytes, flops) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": nbytes, "flops": flops}


def volume_bound(s: Shape) -> dict:
    """One launch of the general volume kernel (one stage)."""
    npts, nqq = s.ngl * s.ngl, s.nq * s.nq
    E = s.nelx * s.nely
    nbytes = s.itemsize * (E * (14 * npts + 44 * nqq) + 3 * npts * nqq)
    flops = E * (2 * 12 * npts * nqq + 110 * nqq + 8 * npts)
    return _bound(nbytes, flops)


def mega_bound(s: Shape) -> dict:
    """One launch of the whole-solve megakernel (one barotropic solve)."""
    n, q = s.ngl, s.nq
    npts, nqq = n * n, q * q
    E = s.nelx * s.nely
    visc = s.visc
    nodal = 4 + 3 + 5 + 4 + 3 + (1 + 4 + 4 if visc else 0)
    quad = 3 + 4 + 8 + 12
    side_q = 4 + 13 + 16
    side_n = 3 + (10 + 8 if visc else 0)
    values = E * (nodal * npts + quad * nqq + side_q * 4 * q + side_n * 4 * n)
    nbytes = s.itemsize * values + 4 * 4 * E
    macs = (4 * n * q * n + 4 * nqq * n
            + 5 * q * n * q + 2 * q * n * q
            + 3 * npts * 2 * q
            + 2 * 16 * q * n + 12 * n * q)
    pointwise = 80 * nqq + 110 * 4 * q + 20 * 3 * npts + 8 * npts
    if visc:
        macs += 4 * npts * n + 16 * n * n + 2 * npts * 2 * n
        pointwise += 45 * 4 * n + 3 * 4 * npts
    flops = E * s.nsub * (2 * macs + pointwise)
    return _bound(nbytes, flops)


def fused_bounds(s: Shape, grad: bool | None = None) -> dict:
    """One launch each of A (the uniform-geometry volume kernel), F (faces)
    and U (update). `grad`: whether A also takes the nodal velocity
    gradient (on the fused path, with the viscosity; the per-stage path's
    uniform-geometry stage takes none)."""
    n, q = s.ngl, s.nq
    npts, nqq = n * n, q * q
    E = s.nelx * s.nely
    F = s.nely * (s.nelx + 1) + (s.nely + 1) * s.nelx
    visc = s.visc
    grad = visc if grad is None else grad
    rows = 6 if s.flat_bottom else 8
    a_vals = E * ((17 + (12 if grad else 0)) * npts + (rows + 28) * nqq)
    a_flops = E * (2 * (7 * n * q * n + 7 * nqq * n + 5 * q * n * q + 3 * npts * 2 * q
                        + (4 * npts * n if grad else 0)) + 80 * nqq + 8 * npts)
    f_vals = F * ((16 + (36 if visc else 0)) * n + 47 * q)
    f_flops = F * (2 * (10 * q * n + 3 * n * q) + 110 * q + (45 * n if visc else 0))
    u_vals = E * ((22 + (9 if visc else 0)) * npts + (3 + (2 if visc else 0)) * 4 * n)
    u_flops = E * (20 * 3 * npts + (2 * 2 * npts * 2 * n + 3 * 4 * npts if visc else 0))
    return {name: _bound(vals * s.itemsize, flops)
            for name, vals, flops in (("btp_volume_uni", a_vals, a_flops),
                                      ("btp_faces", f_vals, f_flops),
                                      ("btp_update", u_vals, u_flops))}


def kernel_bounds(s: Shape, launched) -> dict:
    """{kernel: `_bound` of one launch} of each kernel in `launched` (names
    of KERNEL_SYMBOLS): the path is read from which kernels ran. A is on
    the fused path (with the velocity gradient) where F ran beside it."""
    out = {}
    fused = "btp_faces" in launched
    for name in launched:
        if name == "btp_volume":
            out[name] = volume_bound(s)
        elif name == "btp_mega":
            out[name] = mega_bound(s)
        else:
            out[name] = fused_bounds(s, grad=None if fused else False)[name]
    return out
