"""bc.inp boundary-condition patch reader.

Own copy for the PyTorch package of hnumo_tpu/mesh/bcinp.py (numpy only).
Reference read_bc (src/mod_bc.F90:97-221), enabled by lread_bc=.true.
(src/mod_p4est.F90:433-435): `bc.inp` lists patch files + BC codes; a
boundary face whose corner points all coincide (tol 1e-5) with patch points
gets that code.

On the structured brick the boundary faces are the four domain sides, and a
patch assigns a side's code when it covers EVERY face-corner point of that
side (partial-side patches cannot be represented by the per-side BC model
and raise). Matching is on (x, y); the reference's z column is ignored
(MLSWE forces a single vertical element, src/mod_basis.F90:94).
"""
from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np

_TOL = 1.0e-5  # reference tolerance (src/mod_bc.F90:120)


def _read_patch(path: Path) -> np.ndarray:
    """One patch file: 2 junk headers, 'nptsi nptsj', then xyz rows.

    Mirrors the reference's Fortran list-directed reads (src/mod_bc.F90:
    130-146): the two header READs each consume exactly one record (blank or
    not); every later READ consumes whole records until its value list is
    satisfied, skipping blank records and discarding surplus values."""
    records = iter(path.read_text().splitlines()[2:])  # drop 2 header records

    def read_values(n):
        vals: list[str] = []
        for ln in records:
            toks = ln.split()
            if not toks:
                continue
            vals.extend(toks)
            if len(vals) >= n:
                return vals[:n]
        raise ValueError(f"{path}: unexpected end of patch file")

    npts_i, npts_j = (int(v) for v in read_values(2))
    npts = npts_i * npts_j
    pts = np.array([[float(v) for v in read_values(3)] for _ in range(npts)])
    return pts[:, :2]


def _side_corners(side: str, nelx, nely, xdims, ydims) -> np.ndarray:
    """Face-corner (x, y) coordinates along one domain side of the brick."""
    xs = np.linspace(xdims[0], xdims[1], nelx + 1)
    ys = np.linspace(ydims[0], ydims[1], nely + 1)
    if side == "west":
        return np.stack([np.full(nely + 1, xdims[0]), ys], axis=1)
    if side == "east":
        return np.stack([np.full(nely + 1, xdims[1]), ys], axis=1)
    if side == "south":
        return np.stack([xs, np.full(nelx + 1, ydims[0])], axis=1)
    return np.stack([xs, np.full(nelx + 1, ydims[1])], axis=1)


def _covers(patch_xy: np.ndarray, corners: np.ndarray) -> tuple[bool, bool]:
    """(all corners matched, some INTERIOR corner matched).

    The side's two endpoint corners also belong to the adjacent sides, so a
    patch covering a full adjacent side legitimately touches them — only
    interior matches signal a (non-representable) partial-side patch."""
    d = np.abs(corners[:, None, :] - patch_xy[None, :, :])
    hit = np.all(d < _TOL, axis=2).any(axis=1)
    return bool(hit.all()), bool(hit[1:-1].any())


def read_bc_inp(bc_inp_path, nelx, nely, xdims, ydims,
                x_boundary, y_boundary):
    """Apply bc.inp patches; returns updated (x_boundary, y_boundary).

    Format (src/mod_bc.F90:78-91):
        <nfiles>
        "<patch file>" <bc code>
        ...
    """
    bc_inp_path = Path(bc_inp_path)
    lines = [ln for ln in bc_inp_path.read_text().splitlines() if ln.strip()]
    nfiles = int(lines[0].split()[0])
    xb, yb = list(x_boundary), list(y_boundary)
    sides = {"west": ("x", 0), "east": ("x", 1),
             "south": ("y", 0), "north": ("y", 1)}
    for ln in lines[1:1 + nfiles]:
        parts = ln.replace('"', "'").split("'")
        if len(parts) >= 3 and parts[1]:   # quoted filename
            rest = parts[2].split()
            if not rest:
                raise ValueError(
                    f"{bc_inp_path}: missing BC code after filename in line "
                    f"{ln!r}")
            fname, code = parts[1], int(rest[0])
        else:
            toks = ln.split()
            if len(toks) < 2:
                raise ValueError(
                    f"{bc_inp_path}: expected '<patch file> <bc code>', got "
                    f"line {ln!r}")
            fname, code = toks[0], int(toks[1])
        patch = _read_patch(bc_inp_path.parent / fname)
        matched = False
        partial = []
        for side, (axis, idx) in sides.items():
            full, any_ = _covers(patch, _side_corners(side, nelx, nely,
                                                      xdims, ydims))
            if full:
                (xb if axis == "x" else yb)[idx] = code
                matched = True
            elif any_:
                partial.append(side)
        # a patch that fully covers one side may also brush interior corners
        # of an adjacent side; the reference assigns per-face, so full-side
        # assignments win and stray partial overlap is ignored. Only a patch
        # with NO full side and a partial one is non-representable here.
        if not matched and partial:
            raise ValueError(
                f"{fname}: patch covers only part of the {partial[0]} side — "
                "partial-side BC patches are not representable on the "
                "structured brick (use a gmsh mesh with $BC instead)")
        if not matched:
            warnings.warn(f"{fname}: patch matches no domain side; ignored "
                          "(reference read_bc would silently skip it too)")
    return tuple(xb), tuple(yb)
