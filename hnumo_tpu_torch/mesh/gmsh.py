"""External (GMSH) quadrilateral mesh reader + bathymetry files.

Own copy for the PyTorch package of hnumo_tpu/mesh/gmsh.py. The MSH parse
and the layout inference go through the native C++ front end
(mesh/_native.py) when it is available, as in the JAX package; `native=False`
takes the pure-Python path (numpy only), the parity oracle.

Capability parity with the reference's external-mesh path
(src/read_gmsh.F90:12-207: MSH 2.x ASCII with a trailing `$BC` section;
read_bathy :178-207 reads a `$Bathy` section of per-linear-node depths;
high-order LGL node population is done a-posteriori from the bilinear
quads, src/read_gmsh.F90:249-330).

Difference from the reference: the solver's compute path is a structured
(nely, nelx) element grid (dense batched tensors, no index indirection —
see hnumo_tpu.mesh.grid). External meshes are therefore accepted when they
are *logically structured* (a quad grid under any smooth deformation —
which covers every curvilinear/stretched/mapped-brick mesh); the reader
infers the (ey, ex) layout by breadth-first walking the quad adjacency
graph and reorients every element consistently. Meshes with genuinely
irregular topology (T-junctions, extraordinary vertices) are rejected with
a clear error; AMR/non-conforming topology is out of scope for v1
(SURVEY.md §2.9).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GmshMesh:
    nodes: np.ndarray           # (nnodes, 2) float64
    quads: np.ndarray           # (nelem, 4) int, 0-based, CCW
    boundary_edges: np.ndarray  # (nboun, 3) int: node0, node1, physical tag
    bc_map: dict[int, int]      # physical tag -> BC code (from $BC section)
    bathy: np.ndarray | None = None  # (nnodes,) depths, from $Bathy
    node_ids: np.ndarray | None = None  # (nnodes,) original gmsh node ids


def _take_native(native: bool | None) -> bool:
    """`native`: None = the native path when it is available (a failed build
    raises, see mesh/_native.py), True = the native path or raise, False =
    the pure-Python path."""
    if native is False:
        return False
    from . import _native

    return True if native else _native.available()


def read_msh(path, native: bool | None = None) -> GmshMesh:
    """Parse an MSH 2.x ASCII file (the reference's supported format).

    Element types used (gmsh spec): 1 = 2-node line (boundary edge),
    3 = 4-node quad (element); reference src/read_gmsh.F90:71-76, 145-160.
    The optional `$BC` section maps physical tags to h-NUMO BC codes
    (src/read_gmsh.F90:163-176 reads `nbc` pairs).

    Uses the native C++ parser (mesh/csrc/qmesh.cpp) when available;
    `native=False` forces the pure-Python path (the parity oracle).
    """
    if _take_native(native):
        from . import _native

        nodes, node_ids, quads, bedges, bc_map = _native.read_msh(path)
        bathy = None
        # stream-scan for the section marker (don't slurp the whole file the
        # native parser exists to handle efficiently)
        with open(path) as f:
            has_bathy = any(ln.strip() == "$Bathy" for ln in f)
        if has_bathy:
            id_to_idx = {int(v): k for k, v in enumerate(node_ids)}
            bathy = read_bathy(path, len(nodes), id_to_idx)
        return GmshMesh(nodes=nodes, quads=quads, boundary_edges=bedges,
                        bc_map=bc_map, bathy=bathy, node_ids=node_ids)
    with open(path) as f:
        lines = [ln.strip() for ln in f.read().splitlines()]

    def section(name):
        try:
            i = lines.index(f"${name}")
        except ValueError:
            return None
        return i + 1

    i = section("Nodes")
    if i is None:
        raise ValueError(f"{path}: no $Nodes section (only MSH 2.x ASCII is supported)")
    nnodes = int(lines[i].split()[0])
    nodes = np.empty((nnodes, 2))
    node_ids = np.empty(nnodes, dtype=np.int64)
    for k in range(nnodes):
        parts = lines[i + 1 + k].split()
        node_ids[k] = int(parts[0])
        nodes[k] = (float(parts[1]), float(parts[2]))
    # gmsh node ids are usually 1..N but may be sparse
    id_to_idx = {int(v): k for k, v in enumerate(node_ids)}

    i = section("Elements")
    if i is None:
        raise ValueError(f"{path}: no $Elements section")
    nelements = int(lines[i].split()[0])
    quads, bedges = [], []
    for k in range(nelements):
        parts = [int(v) for v in lines[i + 1 + k].split()]
        etype, ntags = parts[1], parts[2]
        tags = parts[3:3 + ntags]
        conn = parts[3 + ntags:]
        phys = tags[0] if tags else 0
        if etype == 3:      # 4-node quad
            quads.append([id_to_idx[c] for c in conn])
        elif etype == 1:    # 2-node line (boundary)
            bedges.append([id_to_idx[conn[0]], id_to_idx[conn[1]], phys])

    quads = np.asarray(quads, dtype=np.int64)
    bedges = (np.asarray(bedges, dtype=np.int64)
              if bedges else np.empty((0, 3), dtype=np.int64))

    # enforce CCW orientation (reference swaps nodes to make CCW,
    # src/read_gmsh.F90:735-760)
    x, y = nodes[:, 0], nodes[:, 1]
    qx, qy = x[quads], y[quads]
    area2 = np.zeros(len(quads))
    for a in range(4):
        b = (a + 1) % 4
        area2 += qx[:, a] * qy[:, b] - qx[:, b] * qy[:, a]
    cw = area2 < 0
    quads[cw] = quads[cw][:, ::-1]

    # optional $BC section: "nbc" then nbc lines of "physical_tag bc_code"
    bc_map = {}
    i = section("BC")
    if i is not None:
        nbc = int(lines[i].split()[0])
        for k in range(nbc):
            t, c = (int(v) for v in lines[i + 1 + k].split()[:2])
            bc_map[t] = c

    bathy = None
    i = section("Bathy")
    if i is not None:
        bathy = read_bathy(path, nnodes, id_to_idx)

    return GmshMesh(nodes=nodes, quads=quads, boundary_edges=bedges,
                    bc_map=bc_map, bathy=bathy, node_ids=node_ids)


def read_bathy(path, nnodes, id_to_idx=None) -> np.ndarray:
    """Read a `$Bathy` section: header line, then `nnodes` lines "ip z"
    (reference read_bathy, src/read_gmsh.F90:178-207). Streams to the
    section marker instead of slurping the file; node ids map through
    `id_to_idx` when given (sparse gmsh ids), else assume dense 1-based."""
    bathy = np.zeros(nnodes)
    with open(path) as f:
        for ln in f:
            if ln.strip() == "$Bathy":
                break
        else:
            raise ValueError(f"{path}: no $Bathy section")
        next(f)  # header line
        for _ in range(nnodes):
            parts = next(f).split()
            ip = int(parts[0])
            idx = id_to_idx[ip] if id_to_idx else ip - 1
            bathy[idx] = float(parts[1])
    return bathy


# ---------------------------------------------------------------------------
# logical-structure inference
# ---------------------------------------------------------------------------

_EDGES = ((0, 1), (1, 2), (2, 3), (3, 0))  # S, E, N, W of a canonical quad


def infer_structured_layout(quads: np.ndarray, native: bool | None = None):
    """Map quads of a logically-structured mesh onto an (nely, nelx) grid.

    Returns (nely, nelx, elem_of (nely, nelx) int, rot (nelem,) int) where
    `rot[e]` is the left-rotation of quad e's connectivity that puts its
    nodes in canonical order (node 0 = SW corner, CCW). Raises ValueError
    for non-quad-grid topology.

    Dispatches to the native C++ implementation (hashed BFS,
    mesh/csrc/qmesh.cpp) when available; `native=False` forces the
    pure-Python path.
    """
    if _take_native(native):
        from . import _native

        return _native.infer_structured_layout(quads)
    nelem = len(quads)
    # edge -> (elem, local_edge) adjacency
    edge_owner: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for e in range(nelem):
        for le, (a, b) in enumerate(_EDGES):
            key = (int(quads[e, a]), int(quads[e, b]))
            skey = (min(key), max(key))
            edge_owner.setdefault(skey, []).append((e, le))
    for k, v in edge_owner.items():
        if len(v) > 2:
            raise ValueError(f"non-manifold edge {k}: shared by {len(v)} quads")

    def neighbor(e, le):
        a, b = _EDGES[le]
        skey_ = (int(quads[e, a]), int(quads[e, b]))
        skey = (min(skey_), max(skey_))
        for (e2, le2) in edge_owner[skey]:
            if e2 != e:
                return e2, le2
        return None, None

    # BFS from element 0 with rotation 0; assign integer (iy, ix) coords.
    # Crossing local edge le (in canonical orientation) moves:
    #   S->(iy-1), E->(ix+1), N->(iy+1), W->(ix-1)
    move = {0: (-1, 0), 1: (0, 1), 2: (1, 0), 3: (0, -1)}
    rot = np.full(nelem, -1, dtype=np.int64)
    pos = np.zeros((nelem, 2), dtype=np.int64)
    rot[0] = 0
    stack = [0]
    seen = 1
    while stack:
        e = stack.pop()
        for canon_le in range(4):
            le = (canon_le + rot[e]) % 4  # local edge in stored orientation
            e2, le2 = neighbor(e, le)
            if e2 is None:
                continue
            dy, dx = move[canon_le]
            # e2's stored edge le2 must become the OPPOSITE canonical edge
            opp = (canon_le + 2) % 4
            r2 = (le2 - opp) % 4
            p2 = (pos[e, 0] + dy, pos[e, 1] + dx)
            if rot[e2] >= 0:
                if rot[e2] != r2 or tuple(pos[e2]) != p2:
                    raise ValueError(
                        "mesh is not logically structured (inconsistent "
                        f"layout at element {e2}); irregular topology is "
                        "not supported by the structured compute path")
                continue
            rot[e2] = r2
            pos[e2] = p2
            stack.append(e2)
            seen += 1
    if seen != nelem:
        raise ValueError("mesh has disconnected components")

    pos -= pos.min(axis=0)
    nely = int(pos[:, 0].max()) + 1
    nelx = int(pos[:, 1].max()) + 1
    if nely * nelx != nelem:
        raise ValueError(
            f"mesh is not a logically-structured {nely}x{nelx} quad grid "
            f"({nelem} elements); irregular topology is not supported")
    elem_of = np.full((nely, nelx), -1, dtype=np.int64)
    elem_of[pos[:, 0], pos[:, 1]] = np.arange(nelem)
    if (elem_of < 0).any():
        raise ValueError("mesh is not logically structured (holes in layout)")
    return nely, nelx, elem_of, rot


def structured_corner_coords(mesh: GmshMesh, native: bool | None = None):
    """(nely+1, nelx+1, 2) corner-vertex coordinates + per-corner node index.

    Canonical quad node order after rotation: (SW, SE, NE, NW). `native`:
    the layout inference's path (infer_structured_layout).
    """
    nely, nelx, elem_of, rot = infer_structured_layout(mesh.quads, native=native)
    # canonical node c of element e = quads[e, (c + rot[e]) % 4]
    qe = mesh.quads[elem_of]                       # (nely, nelx, 4)
    re = rot[elem_of][..., None]                   # (nely, nelx, 1)
    canon = np.take_along_axis(qe, (np.arange(4)[None, None] + re) % 4, axis=-1)
    corners = np.empty((nely + 1, nelx + 1), dtype=np.int64)
    corners[:-1, :-1] = canon[..., 0]              # SW of every element
    corners[:-1, -1] = canon[:, -1, 1]             # SE of last column
    corners[-1, :-1] = canon[-1, :, 3]             # NW of last row
    corners[-1, -1] = canon[-1, -1, 2]             # NE corner element
    return mesh.nodes[corners], corners


def boundary_bc_codes(mesh: GmshMesh, corners: np.ndarray) -> tuple[int, int, int, int]:
    """Derive (west, east, south, north) BC codes from tagged boundary edges.

    Each physical side must carry a single code; defaults to 4 (free-slip
    wall — the reference's standard ocean boundary) when untagged.
    """
    if len(mesh.boundary_edges) == 0 or not mesh.bc_map:
        return (4, 4, 4, 4)
    edge_code = {}
    for n0, n1, phys in mesh.boundary_edges:
        code = mesh.bc_map.get(int(phys), 4)
        edge_code[(min(int(n0), int(n1)), max(int(n0), int(n1)))] = code

    def side_code(pairs):
        codes = {edge_code[k] for k in pairs if k in edge_code}
        if len(codes) > 1:
            raise ValueError(f"mixed BC codes on one side: {sorted(codes)}")
        return codes.pop() if codes else 4

    def keys(vs):
        return [(min(int(a), int(b)), max(int(a), int(b)))
                for a, b in zip(vs[:-1], vs[1:])]

    west = side_code(keys(corners[:, 0]))
    east = side_code(keys(corners[:, -1]))
    south = side_code(keys(corners[0, :]))
    north = side_code(keys(corners[-1, :]))
    return (west, east, south, north)


def geometry_from_msh(path, nop: int, exact_integration: bool = True,
                      bc: tuple[int, int, int, int] | None = None,
                      bathy_path=None, use_bathy: bool = True,
                      native: bool | None = None):
    """Build a curvilinear Geometry (+ optional nodal bathymetry) from a
    gmsh file: bilinear LGL node population (the reference's a-posteriori
    high-order fill, src/read_gmsh.F90:249-330) then isoparametric metrics.

    `bathy_path`: optional separate file with a `$Bathy` section of
    per-linear-node bottom elevations (reference read_bathy,
    src/read_gmsh.F90:178-207); an in-file `$Bathy` section also works.
    `use_bathy=False` (lread_external_bathy=.false.) ignores BOTH sources so
    the config flag actually gates the override of the test case's analytic
    bathymetry. `native`: the path of the parse and of the layout inference
    (read_msh). Returns (Geometry, zbot_nodal_or_None).
    """
    from .grid import build_geometry_from_corners

    mesh = read_msh(path, native=native)
    cc, corner_idx = structured_corner_coords(mesh, native=native)
    if bc is None:
        bc = boundary_bc_codes(mesh, corner_idx)
    geom = build_geometry_from_corners(cc, nop, bc=bc,
                                       exact_integration=exact_integration)
    bathy = mesh.bathy if use_bathy else None
    if use_bathy and bathy_path:
        # map through the mesh's node-id table (gmsh ids may be sparse)
        id_to_idx = (None if mesh.node_ids is None else
                     {int(v): k for k, v in enumerate(mesh.node_ids)})
        bathy = read_bathy(bathy_path, len(mesh.nodes), id_to_idx)
    zbot = None
    if bathy is not None:
        zbot = _bilinear_to_nodal(bathy[corner_idx], geom)
    return geom, zbot


def _bilinear_to_nodal(corner_vals: np.ndarray, geom) -> np.ndarray:
    """Interpolate per-corner values bilinearly to the (nely,nelx,ngl,ngl)
    nodal grid (matching the linear-grid bathymetry semantics of
    src/read_gmsh.F90:178-207)."""
    s = (geom.xgl + 1.0) / 2.0  # [0,1] LGL abscissae
    c00 = corner_vals[:-1, :-1][:, :, None, None]
    c01 = corner_vals[:-1, 1:][:, :, None, None]
    c10 = corner_vals[1:, :-1][:, :, None, None]
    c11 = corner_vals[1:, 1:][:, :, None, None]
    sj = s[None, None, :, None]
    si = s[None, None, None, :]
    return ((1 - sj) * ((1 - si) * c00 + si * c01)
            + sj * ((1 - si) * c10 + si * c11))
