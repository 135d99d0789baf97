"""The port's native C++ mesh front end (hnumo_tpu_torch/mesh/_native.py on
its own copy, mesh/csrc/qmesh.cpp) against the JAX package's
(hnumo_tpu/mesh/_native.py on native/src/qmesh.cpp): bitwise on every entry
point, on the same files and arrays, written with numpy from a seed
(tests/test_gmsh.make_msh). And against the port's pure-Python path: the
geometry built from a file through the native path is bitwise the one built
through the Python path, and the native path is the one taken by default
where g++ is present.

The layouts and the parse are held to equality (the same C++ in both
packages); the JAX package's own tests/test_native.py holds the native path
against the Python one with a tolerance on the coordinates, this file
bitwise."""
import dataclasses
import shutil

import numpy as np
import pytest

import hnumo_tpu.mesh._native as jnative
from hnumo_tpu.mesh import gmsh as jgmsh
from hnumo_tpu_torch.mesh import _native as tnative
from hnumo_tpu_torch.mesh import gmsh as tgmsh
from hnumo_tpu_torch.mesh.grid import Geometry
from test_gmsh import make_msh

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++: neither native front end builds")


@pytest.fixture(autouse=True)
def native_on(monkeypatch):
    """The native path of both packages, whatever the environment says."""
    monkeypatch.delenv("HNUMO_NATIVE", raising=False)
    assert jnative.available() and tnative.available()


def _msh(tmp_path, nelx, nely, seed=None, **kw):
    p = tmp_path / f"m{nelx}x{nely}.msh"
    make_msh(p, nelx, nely, kw.pop("xdims", (0, nelx)), kw.pop("ydims", (0, nely)),
             shuffle=None if seed is None else np.random.default_rng(seed), **kw)
    return p


def test_library_is_built_from_the_ports_source_into_its_build_dir():
    lib = tnative.library_path()
    assert lib.parent.name == "_build" and lib.parent.parent.name == "hnumo_tpu_torch"
    assert tnative.SOURCE.parts[-3:] == ("mesh", "csrc", "qmesh.cpp")
    assert "native" not in tnative.SOURCE.parts
    assert lib.exists()


@pytest.mark.parametrize("nelx,nely,seed,deform", [(7, 5, 3, 0.2), (5, 5, 7, 0.0),
                                                   (9, 4, 11, 0.3), (1, 6, 2, 0.0)])
def test_layout_of_scrambled_meshes_matches_jax(tmp_path, nelx, nely, seed, deform):
    p = _msh(tmp_path, nelx, nely, seed, deform=deform)
    quads = jgmsh.read_msh(p, native=False).quads
    j = jnative.infer_structured_layout(quads)
    t = tnative.infer_structured_layout(quads)
    # a scrambled mesh may come out transposed (its first element fixes
    # the orientation): the two must agree, on the same grid
    assert j[:2] == t[:2] and sorted(t[:2]) == sorted((nely, nelx))
    for a, b in zip(j[2:], t[2:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("bathy", [None, lambda x, y: -10.0 - x - 2 * y])
def test_msh_parse_matches_jax(tmp_path, bathy):
    p = _msh(tmp_path, 4, 6, 5, xdims=(0, 2), ydims=(0, 3), deform=0.1,
             bc_codes=(4, 2, 4, 2), bathy=bathy)
    j = jnative.read_msh(p)
    t = tnative.read_msh(p)
    for a, b in zip(j[:4], t[:4]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert j[4] == t[4] == {1: 4, 2: 2, 3: 4, 4: 2}
    # the whole reader (with the $Bathy section read beside the C++ parse)
    jm, tm = jgmsh.read_msh(p, native=True), tgmsh.read_msh(p, native=True)
    for f in dataclasses.fields(tm):
        a, b = getattr(jm, f.name), getattr(tm, f.name)
        if isinstance(a, np.ndarray) or a is None:
            assert (a is None) == (b is None) and (a is None or np.array_equal(a, b)), f.name
        else:
            assert a == b, f.name


def test_corner_table_matches_jax_and_the_python_path(tmp_path):
    p = _msh(tmp_path, 5, 5, 7)
    mesh = tgmsh.read_msh(p, native=False)
    layout = tnative.infer_structured_layout(mesh.quads)
    t = tnative.corner_table(*layout[:2], mesh.quads, *layout[2:])
    j = jnative.corner_table(*layout[:2], mesh.quads, *layout[2:])
    _, py = tgmsh.structured_corner_coords(mesh, native=False)
    assert np.array_equal(t, j) and np.array_equal(t, py)


@pytest.mark.parametrize("n,p,want", [(10, 4, [0, 3, 6, 8, 10]), (8, 4, [0, 2, 4, 6, 8]),
                                      (7, 1, [0, 7])])
def test_partition_matches_jax(n, p, want):
    t = tnative.partition(n, p)
    assert np.array_equal(t, jnative.partition(n, p)) and t.tolist() == want


def test_irregular_topology_is_rejected_like_jax():
    # a third quad on one edge: non-manifold
    quads = np.array([[0, 1, 2, 3], [1, 4, 5, 2], [1, 6, 7, 2]])
    msgs = []
    for impl in (jnative, tnative):
        with pytest.raises(ValueError) as e:
            impl.infer_structured_layout(quads)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError):
        tnative.partition(3, 4)


@pytest.mark.parametrize("name,kw", [
    ("brick", dict(nelx=4, nely=3, seed=None)),
    ("deformed_scrambled", dict(nelx=6, nely=5, seed=1, deform=0.3)),
    ("bathy", dict(nelx=6, nely=5, seed=None, deform=0.2, xdims=(0.0, 2e6),
                   ydims=(0.0, 2e6), bc_codes=(4, 2, 4, 2),
                   bathy=lambda x, y: -9928.0 + 1e-3 * x))])
def test_geometry_through_the_native_path_is_bitwise_the_python_path(tmp_path, name, kw):
    p = _msh(tmp_path, **kw)
    before = dict(tnative.calls)
    gn, zn = tgmsh.geometry_from_msh(p, nop=3)              # the default path
    taken = {k: tnative.calls[k] - before[k] for k in before}
    assert taken["read_msh"] == 1 and taken["infer_structured_layout"] == 1
    gp, zp = tgmsh.geometry_from_msh(p, nop=3, native=False)
    assert {k: tnative.calls[k] - before[k] for k in before} == taken
    assert (gn.nelx, gn.nely, gn.bc) == (gp.nelx, gp.nely, gp.bc)
    for f in dataclasses.fields(Geometry):
        a, b = getattr(gn, f.name), getattr(gp, f.name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), f.name
    assert (zn is None) == (zp is None)
    if zn is not None:
        assert np.array_equal(zn, zp)


def test_native_off_by_environment(tmp_path, monkeypatch):
    """HNUMO_NATIVE=0 takes the Python path by default and makes an explicit
    native=True raise; it never falls back silently in that direction."""
    p = _msh(tmp_path, 3, 3, None)
    monkeypatch.setenv("HNUMO_NATIVE", "0")
    assert not tnative.available()
    before = dict(tnative.calls)
    geom, _ = tgmsh.geometry_from_msh(p, nop=3)
    assert (geom.nely, geom.nelx) == (3, 3) and tnative.calls == before
    with pytest.raises(RuntimeError, match="HNUMO_NATIVE"):
        tgmsh.read_msh(p, native=True)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's message: the
    Python path does not hide a broken native build."""
    bad = tmp_path / "qmesh.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_LIB", None)
    with pytest.raises(RuntimeError, match="building qmesh.cpp failed"):
        tnative.available()
