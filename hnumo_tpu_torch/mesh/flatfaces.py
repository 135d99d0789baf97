"""Gather-based flat face machinery for genuinely unstructured quad meshes.

Own copy for the PyTorch package of the JAX package's mesh/flatfaces.py
(phase 1 of docs/unstructured.md; the two share no import): the building
blocks that replace the structured edge-slab face path when a mesh has
extraordinary vertices (valence != 4) and therefore no (ey, ex) logical
layout. No model path steps with it yet, in either package.

Reference counterpart: the face builder of create_normals_quad
(src/create_normals_quad.F90:227 builds imapl_q/imapr_q per-face node
index maps) and the p4est external-connectivity door
(src/p4est.c:1030-1187). Element storage stays dense element-major
(C, E, ngl, ngl); only the face pipeline uses precomputed flat index maps:

    traces   uL = u.reshape(..., E*ngl*ngl).index_select(-1, idx_L)
    scatter  rhs = rhs.reshape(..., E*ngl*ngl).index_add_(-1, idx, S)

Orientation is folded into the index order of idx_R when the tables are
built, so the runtime has no orientation branches. Boundary faces carry
R = L (the caller applies the mirror of its boundary condition).

Host side (float64 / int32 NumPy, as the JAX package's): `FlatFaces`,
`build_flat_faces`, `face_geometry`, `pinwheel_mesh`, `bilinear_coords`.
Run time, on tensors: `FlatFaces.to(device)` copies the index tables to
the caller's device once; `extract_traces` and `scatter_faces` take those
device tables and tensors on the same device. Nothing is copied between
the host and a device behind the caller's back.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# local edge -> the (j, i) nodal indices along it, in counterclockwise
# element order: side 0 = south (j=0, i ascending), 1 = east (i=ngl-1,
# j ascending), 2 = north (j=ngl-1, i descending), 3 = west (i=0,
# j descending). Corner k..k+1 of the quad spans side k.
_SIDE_CORNERS = [(0, 1), (1, 2), (2, 3), (3, 0)]


def _side_nodes(side: int, ngl: int) -> np.ndarray:
    """Linear (j*ngl + i) node indices along a local side, CCW order."""
    r = np.arange(ngl)
    if side == 0:
        j, i = np.zeros(ngl, int), r
    elif side == 1:
        j, i = r, np.full(ngl, ngl - 1)
    elif side == 2:
        j, i = np.full(ngl, ngl - 1), r[::-1]
    else:
        j, i = r[::-1], np.zeros(ngl, int)
    return j * ngl + i


@dataclass(frozen=True)
class DeviceFlatFaces:
    """The index tables of a `FlatFaces` on one device (`FlatFaces.to`):
    `idx_L` / `idx_R` flattened to (F*ngl,) int32 tensors."""

    idx_L: torch.Tensor
    idx_R: torch.Tensor
    n_faces: int
    ngl: int
    n_interior: int

    @property
    def device(self) -> torch.device:
        return self.idx_L.device


@dataclass
class FlatFaces:
    """Flat face index tables for an arbitrary conforming quad mesh.

    F faces total (interior first, then boundary). All arrays np.int32 /
    bool host tables; `to(device)` gives the index tables the run-time
    functions take.
    """

    idx_L: np.ndarray       # (F, ngl) linear indices into (E*ngl*ngl,)
    idx_R: np.ndarray       # (F, ngl); boundary faces repeat idx_L
    elem_L: np.ndarray      # (F,)
    elem_R: np.ndarray      # (F,) = elem_L on boundary faces
    side_L: np.ndarray      # (F,)
    is_boundary: np.ndarray  # (F,) bool
    n_interior: int

    def to(self, device) -> DeviceFlatFaces:
        """Copy the index tables to `device` (the caller names it; "cpu"
        too): one copy, made here and nowhere else."""
        F, ngl = self.idx_L.shape

        def table(a):
            return torch.tensor(a.reshape(-1), dtype=torch.int32, device=device)

        return DeviceFlatFaces(idx_L=table(self.idx_L), idx_R=table(self.idx_R),
                               n_faces=F, ngl=ngl, n_interior=self.n_interior)


def build_flat_faces(quads: np.ndarray, ngl: int) -> FlatFaces:
    """Build flat face tables from (E, 4) CCW vertex-id connectivity.

    Accepts any conforming quad mesh, extraordinary vertices included,
    which is exactly the class the structured BFS loader (mesh/gmsh.py)
    rejects. Matching edges get idx_R in the reversed node order of idx_L
    (two CCW elements traverse a shared edge oppositely), which is the only
    orientation a conforming quad mesh admits; two elements that traverse
    a shared edge in the same direction raise ValueError (an inconsistently
    oriented mesh).

    What is not checked, as in the JAX package (whose docstring says that
    T-junctions raise; its code does not): an edge shared by three
    elements does not raise. The first two elements (in element order)
    form an interior face, and the third element's side becomes a boundary
    face. A hanging vertex is not detected either: its edges become
    boundary faces.
    """
    E = quads.shape[0]
    edge_owner: dict[tuple[int, int], tuple[int, int]] = {}
    rows_L, rows_R = [], []
    eL, eR, sL, bnd = [], [], [], []
    # interior faces
    boundary = []
    for e in range(E):
        for s in range(4):
            a, b = (int(quads[e, _SIDE_CORNERS[s][0]]),
                    int(quads[e, _SIDE_CORNERS[s][1]]))
            key = (min(a, b), max(a, b))
            if key in edge_owner:
                (e0, s0) = edge_owner.pop(key)
                a0 = int(quads[e0, _SIDE_CORNERS[s0][0]])
                if a0 == a:
                    raise ValueError(
                        f"edge {key}: same traversal direction in elements "
                        f"{e0} and {e} — mesh is not consistently oriented")
                rows_L.append(e0 * ngl * ngl + _side_nodes(s0, ngl))
                # R runs the same physical direction as L: reverse R's CCW
                rows_R.append(e * ngl * ngl + _side_nodes(s, ngl)[::-1])
                eL.append(e0)
                eR.append(e)
                sL.append(s0)
                bnd.append(False)
            else:
                edge_owner[key] = (e, s)
    # remaining edges are domain boundary, in (element, side) order
    for (key, (e, s)) in sorted(edge_owner.items(),
                                key=lambda kv: (kv[1][0], kv[1][1])):
        idx = e * ngl * ngl + _side_nodes(s, ngl)
        boundary.append((idx, e, s))
    n_int = len(rows_L)
    for idx, e, s in boundary:
        rows_L.append(idx)
        rows_R.append(idx)
        eL.append(e)
        eR.append(e)
        sL.append(s)
        bnd.append(True)
    return FlatFaces(
        idx_L=np.asarray(rows_L, np.int32),
        idx_R=np.asarray(rows_R, np.int32),
        elem_L=np.asarray(eL, np.int32), elem_R=np.asarray(eR, np.int32),
        side_L=np.asarray(sL, np.int32),
        is_boundary=np.asarray(bnd, bool), n_interior=n_int)


def _check_device(t: torch.Tensor, faces: DeviceFlatFaces, what: str) -> None:
    if not isinstance(faces, DeviceFlatFaces):
        raise TypeError("pass the device tables of FlatFaces.to(device), "
                        f"not {type(faces).__name__}")
    if t.device != faces.device:
        raise ValueError(f"{what} lies on {t.device}, the face tables on "
                         f"{faces.device}: move one of them first")


def extract_traces(u: torch.Tensor, faces: DeviceFlatFaces):
    """(..., E, ngl, ngl) -> (uL, uR), each (..., F, ngl): one
    `index_select` per side, batched over leading channel/layer axes.
    `faces`: `FlatFaces.to(u.device)`."""
    _check_device(u, faces, "the field")
    lead = u.shape[:-3]
    flat = u.reshape(lead + (-1,))
    shape = lead + (faces.n_faces, faces.ngl)
    return (flat.index_select(-1, faces.idx_L).reshape(shape),
            flat.index_select(-1, faces.idx_R).reshape(shape))


def scatter_faces(rhs: torch.Tensor, S_L: torch.Tensor, S_R: torch.Tensor,
                  faces: DeviceFlatFaces) -> torch.Tensor:
    """Accumulate per-face values into both owners' edge nodes, out of
    place (as the JAX package's `.at[].add`): a new tensor, `rhs` as it was.

    rhs: (..., E, ngl, ngl); S_L/S_R: (..., F, ngl) contributions for the
    L (respectively R) element of each face (sign conventions are the
    caller's, matching scatter_face_x/y). Boundary faces must carry their
    full contribution in S_L with S_R zeroed there (idx_R aliases idx_L).
    One `index_add_` per side; the adds into a node that several faces
    share (a corner) run in another order than the JAX package's."""
    for t, what in ((rhs, "rhs"), (S_L, "S_L"), (S_R, "S_R")):
        _check_device(t, faces, what)
    shp = rhs.shape
    lead = shp[:-3]
    flat = rhs.reshape(lead + (-1,)).clone()
    flat.index_add_(-1, faces.idx_L, S_L.reshape(lead + (-1,)))
    flat.index_add_(-1, faces.idx_R, S_R.reshape(lead + (-1,)))
    return flat.reshape(shp)


def face_geometry(coords, ff: FlatFaces, wq, dpsi):
    """Per-face unit normals (outward from L), edge jacobian weights.

    coords: (E, ngl, ngl, 2) nodal coordinates (bilinear corner map or
    curvilinear); returns (nx, ny, jac) each (F, ngl) with jac = w * |dx/ds|
    along the face — the flat-table analog of the structured
    jac_facex/nx_x tables (mesh/grid.py). `dpsi` is the 1D LGL derivative
    matrix with the evaluation node in rows: dpsi[m, n] = dψ_n/dξ at node
    m, which is `Basis1D(nop).dpsi.T` (`Basis1D.dpsi` holds
    dpsi[i, j] = L_i'(x_j)). Float64 NumPy.
    """
    E, ngl = coords.shape[0], coords.shape[1]
    xy = coords.reshape(E * ngl * ngl, 2)
    fxy = xy[ff.idx_L]                      # (F, ngl, 2) along-face coords
    # d(x,y)/ds via the 1D derivative matrix in the face parameter
    dxy = np.einsum("fnc,mn->fmc", fxy, dpsi)
    tx, ty = dxy[..., 0], dxy[..., 1]
    jac_s = np.sqrt(tx * tx + ty * ty)
    # outward-from-L normal = tangent rotated -90deg for CCW traversal
    nx = ty / jac_s
    ny = -tx / jac_s
    return nx, ny, wq[None, :] * jac_s


def pinwheel_mesh():
    """The minimal genuinely unstructured conforming quad mesh: 3 quads
    fully surrounding an interior valence-3 (extraordinary) vertex — no
    (ey, ex) logical layout exists for it, so the structured BFS loader
    (mesh/gmsh.py) must reject it while this module accepts it.
    Returns (vertices (V, 2), quads (E, 4) CCW)."""
    import math

    ring = [(math.cos(math.radians(60 * k)), math.sin(math.radians(60 * k)))
            for k in range(6)]
    verts = np.array([[0.0, 0.0]] + ring)         # 0 = center, 1..6 = ring
    quads = np.array([
        [0, 1, 2, 3],     # center, 0deg, 60deg, 120deg   (CCW)
        [0, 3, 4, 5],     # center, 120deg, 180deg, 240deg
        [0, 5, 6, 1],     # center, 240deg, 300deg, 360deg
    ])
    return verts, quads


def bilinear_coords(verts, quads, xgl):
    """Nodal coordinates of each element via the bilinear corner map.

    xgl: (ngl,) LGL nodes on [-1, 1]. Returns (E, ngl, ngl, 2)."""
    ngl = len(xgl)
    s = (np.asarray(xgl) + 1.0) / 2.0
    a = s[None, :]                       # i (x-like)
    b = s[:, None]                       # j
    E = quads.shape[0]
    out = np.empty((E, ngl, ngl, 2))
    for e in range(E):
        v0, v1, v2, v3 = (verts[quads[e, k]] for k in range(4))
        for c in range(2):
            out[e, :, :, c] = ((1 - a) * (1 - b) * v0[c] + a * (1 - b) * v1[c]
                               + a * b * v2[c] + (1 - a) * b * v3[c])
    return out
