"""Legacy-VTK snapshot writers (ASCII + binary), per-layer.

Counterpart of hnumo_tpu/io/vtk.py, writing the same bytes for the same
numbers (the grid file's title included). Capability parity with the
reference's VTK output path (src/write_output.F90:10-49 dispatches per layer;
src/outvtk_g_binary.F90:18-311 and src/mod_vtk_binary.F90 write legacy
unstructured-grid VTK with the DG mesh subdivided into (ngl-1)^2 bilinear
sub-quads per element). One file per layer per snapshot:
`{root}{NNNN}_l{K}.vtk`, with point data h, u, v and the layer-interface
elevation eta, points placed at (x, y, eta).

Binary legacy VTK is big-endian (VTK spec); data written as float32 like
the reference's default single-precision VTK output.
"""
from __future__ import annotations

import os

import numpy as np

from .diagnostics import derived_fields

_VTK_QUAD = 9


def _subcell_connectivity(nely, nelx, ngl):
    """Global connectivity of (ngl-1)^2 sub-quads per element over the
    element-major flat point numbering (reference builds the same sub-cell
    decomposition, src/outvtk_g_binary.F90:120-180)."""
    npts_e = ngl * ngl
    e_base = (np.arange(nely * nelx) * npts_e)[:, None, None]
    j = np.arange(ngl - 1)[None, :, None]
    i = np.arange(ngl - 1)[None, None, :]
    n00 = e_base + j * ngl + i
    n01 = n00 + 1
    n11 = n00 + ngl + 1
    n10 = n00 + ngl
    cells = np.stack([n00, n01, n11, n10], axis=-1).reshape(-1, 4)
    return cells


def write_vtk(model, state, itime, root="mlswe", outdir=".", fmt="ascii"):
    """Write one legacy-VTK file per layer. Returns the list of paths."""
    q5 = derived_fields(model, state)       # (5, L, ney, nex, ngl, ngl)
    geom = model.geom
    L = q5.shape[1]
    x = np.asarray(geom.coord[..., 0]).ravel()
    y = np.asarray(geom.coord[..., 1]).ravel()
    cells = _subcell_connectivity(geom.nely, geom.nelx, geom.ngl)
    paths = []
    for k in range(L):
        h, u, v = (q5[i, k].ravel() for i in range(3))
        eta = q5[4, k].ravel()
        pts = np.stack([x, y, eta], axis=-1)
        path = os.path.join(outdir, f"{root}{itime:04d}_l{k + 1}.vtk")
        fields = {"h": h, "u": u, "v": v, "eta": eta}
        if fmt == "binary":
            _write_legacy_binary(path, pts, cells, fields,
                                 title=f"mlswe layer {k + 1} t={float(state.t)}")
        else:
            _write_legacy_ascii(path, pts, cells, fields,
                                title=f"mlswe layer {k + 1} t={float(state.t)}")
        paths.append(path)
    return paths


def _header(title, fmt):
    return (f"# vtk DataFile Version 3.0\n{title}\n{fmt}\n"
            "DATASET UNSTRUCTURED_GRID\n")


def _write_legacy_ascii(path, pts, cells, fields, title):
    n, nc = len(pts), len(cells)
    with open(path, "w") as f:
        f.write(_header(title, "ASCII"))
        f.write(f"POINTS {n} float\n")
        np.savetxt(f, pts, fmt="%.7e")
        f.write(f"\nCELLS {nc} {nc * 5}\n")
        np.savetxt(f, np.hstack([np.full((nc, 1), 4, dtype=np.int64), cells]),
                   fmt="%d")
        f.write(f"\nCELL_TYPES {nc}\n")
        np.savetxt(f, np.full(nc, _VTK_QUAD, dtype=np.int64), fmt="%d")
        f.write(f"\nPOINT_DATA {n}\n")
        for name, val in fields.items():
            f.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n")
            np.savetxt(f, val, fmt="%.7e")


def _write_legacy_binary(path, pts, cells, fields, title):
    n, nc = len(pts), len(cells)
    with open(path, "wb") as f:
        f.write(_header(title, "BINARY").encode())
        f.write(f"POINTS {n} float\n".encode())
        f.write(pts.astype(">f4").tobytes())
        f.write(f"\nCELLS {nc} {nc * 5}\n".encode())
        conn = np.hstack([np.full((nc, 1), 4, dtype=np.int64), cells])
        f.write(conn.astype(">i4").tobytes())
        f.write(f"\nCELL_TYPES {nc}\n".encode())
        f.write(np.full(nc, _VTK_QUAD).astype(">i4").tobytes())
        f.write(f"\nPOINT_DATA {n}\n".encode())
        for name, val in fields.items():
            f.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n".encode())
            f.write(val.astype(">f4").tobytes())
            f.write(b"\n")


def write_grid_vtk(geom, path):
    """Grid-only VTK dump (reference src/write_grid.F90 analog)."""
    x = np.asarray(geom.coord[..., 0]).ravel()
    y = np.asarray(geom.coord[..., 1]).ravel()
    pts = np.stack([x, y, np.zeros_like(x)], axis=-1)
    cells = _subcell_connectivity(geom.nely, geom.nelx, geom.ngl)
    # the JAX package's title, so that the two packages' files are the same
    _write_legacy_ascii(path, pts, cells, {}, title="hnumo_tpu grid")
    return path
