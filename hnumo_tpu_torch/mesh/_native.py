"""ctypes binding for the native mesh front end (mesh/csrc/qmesh.cpp).

Counterpart of hnumo_tpu/mesh/_native.py, on the package's own copy of the
C++ source. The native library is the path for large external meshes (MSH
parsing and the structured-layout search in C++, with hashed edge lookup);
mesh/gmsh.py keeps the pure-Python path as the parity oracle and takes this
one when it is available.

The library is built with g++ into `hnumo_tpu_torch/_build/` at first use,
by the package's host build (`_hostlib.py`: a name that carries a hash of
the source and of the flags, a build safe for processes that build at
once). `HNUMO_NATIVE=0` turns the native path off; so does the absence of
g++. Where g++ is present and the build or the load fails, that raises: it
is never hidden behind the Python path. `calls` counts the native calls per
function, the record of which path ran.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from .. import _hostlib
from .._hostlib import enabled

SOURCE = Path(__file__).resolve().parent / "csrc" / "qmesh.cpp"
BUILD_DIR = _hostlib.BUILD_DIR

_LIB: ctypes.CDLL | None = None

# native calls per function since import (or since a caller reset them)
calls = {"infer_structured_layout": 0, "corner_table": 0, "read_msh": 0,
         "partition": 0}


def library_path() -> Path:
    """Where the library of the present source and flags lives."""
    return _hostlib.library_path(SOURCE, BUILD_DIR)


def get_lib() -> ctypes.CDLL:
    """The loaded library (built at the first call). Raises where the native
    path is off, or if the build or the load fails."""
    global _LIB
    if _LIB is not None and enabled():
        return _LIB
    lib = _hostlib.load(SOURCE, BUILD_DIR)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.qmesh_infer_layout.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p, i64p, ctypes.c_char_p, ctypes.c_int]
    lib.qmesh_corner_table.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p, i64p,
        ctypes.c_char_p, ctypes.c_int]
    lib.qmesh_msh_sizes.argtypes = [
        ctypes.c_char_p, i64p, ctypes.c_char_p, ctypes.c_int]
    lib.qmesh_msh_data.argtypes = [
        f64p, i64p, i64p, i64p, i64p, ctypes.c_char_p, ctypes.c_int]
    lib.qmesh_partition.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, ctypes.c_char_p, ctypes.c_int]
    for fn in (lib.qmesh_infer_layout, lib.qmesh_corner_table,
               lib.qmesh_msh_sizes, lib.qmesh_msh_data, lib.qmesh_partition):
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    """The native path is on; builds and loads the library if it is (a
    failure there raises)."""
    if not enabled():
        return False
    get_lib()
    return True


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _check(rc, err):
    if rc != 0:
        raise ValueError(err.value.decode() or f"qmesh error {rc}")


def infer_structured_layout(quads: np.ndarray):
    """Native gmsh.infer_structured_layout. Returns
    (nely, nelx, elem_of, rot) or raises ValueError."""
    lib = get_lib()
    calls["infer_structured_layout"] += 1
    q = np.ascontiguousarray(quads, dtype=np.int64)
    nelem = len(q)
    dims = np.zeros(2, np.int64)
    elem_of = np.zeros(nelem, np.int64)
    rot = np.zeros(nelem, np.int64)
    err = ctypes.create_string_buffer(256)
    _check(lib.qmesh_infer_layout(nelem, _i64p(q), _i64p(dims),
                                  _i64p(elem_of), _i64p(rot), err, 256), err)
    nely, nelx = int(dims[0]), int(dims[1])
    return nely, nelx, elem_of.reshape(nely, nelx), rot


def corner_table(nely, nelx, quads, elem_of, rot) -> np.ndarray:
    """(nely+1, nelx+1) node index of every corner vertex."""
    lib = get_lib()
    calls["corner_table"] += 1
    q = np.ascontiguousarray(quads, dtype=np.int64)
    eo = np.ascontiguousarray(elem_of, dtype=np.int64)
    r = np.ascontiguousarray(rot, dtype=np.int64)
    corners = np.zeros((nely + 1) * (nelx + 1), np.int64)
    err = ctypes.create_string_buffer(256)
    _check(lib.qmesh_corner_table(nely, nelx, _i64p(q), _i64p(eo), _i64p(r),
                                  _i64p(corners), err, 256), err)
    return corners.reshape(nely + 1, nelx + 1)


def read_msh(path):
    """Native MSH 2.x parse. Returns (nodes, node_ids, quads, bedges, bc_map)."""
    lib = get_lib()
    calls["read_msh"] += 1
    err = ctypes.create_string_buffer(256)
    sizes = np.zeros(4, np.int64)
    _check(lib.qmesh_msh_sizes(str(path).encode(), _i64p(sizes), err, 256), err)
    nnodes, nquads, nbedges, nbc = (int(v) for v in sizes)
    nodes = np.zeros((nnodes, 2), np.float64)
    node_ids = np.zeros(nnodes, np.int64)
    quads = np.zeros((nquads, 4), np.int64)
    bedges = np.zeros((max(nbedges, 1), 3), np.int64)
    bc_pairs = np.zeros((max(nbc, 1), 2), np.int64)
    _check(lib.qmesh_msh_data(
        nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _i64p(node_ids), _i64p(quads), _i64p(bedges), _i64p(bc_pairs),
        err, 256), err)
    bc_map = {int(t): int(c) for t, c in bc_pairs[:nbc]}
    return nodes, node_ids, quads, bedges[:nbedges], bc_map


def partition(n: int, p: int) -> np.ndarray:
    """Balanced 1-D block partition bounds (len p+1): shard i holds
    [bounds[i], bounds[i+1])."""
    lib = get_lib()
    calls["partition"] += 1
    bounds = np.zeros(p + 1, np.int64)
    err = ctypes.create_string_buffer(256)
    _check(lib.qmesh_partition(n, p, _i64p(bounds), err, 256), err)
    return bounds
