"""External (gmsh) meshes in the port against the JAX package: the MSH 2.x
reader with its $BC and $Bathy sections, the layout inference (the
pure-Python path of both packages, `native=False`; tests/test_torch_native.py
holds the two C++ front ends against each other), the isoparametric geometry, and two float64 steps of a model on a deformed mesh
with external bathymetry.

Both packages read the same files, written with numpy from a seed
(tests/test_gmsh.make_msh). The readers, the layout and the corner tables
must be equal; the geometry equal to 1e-13 of each table's scale (the same
numpy operations in both; measured: bitwise); the two steps to 1e-11 of
each field's max (the port's steps are held to the JAX package's at that
level everywhere; measured here ~2e-15).
"""
import dataclasses

import numpy as np
import pytest

import hnumo_tpu.mesh._native as jax_native
from hnumo_tpu.config import Config as JaxConfig
from hnumo_tpu.mesh import gmsh as jgmsh
from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu_torch.config import Config as TorchConfig
from hnumo_tpu_torch.io.diagnostics import derived_fields
from hnumo_tpu_torch.mesh import gmsh as tgmsh
from hnumo_tpu_torch.mesh.grid import Geometry
from hnumo_tpu_torch.model import Model as TorchModel
from test_gmsh import make_msh
from test_torch_common import assert_close, one_thread  # noqa: F401  (autouse)

BASIN = (0.0, 2.0e6)
FIELDS = ("qb_df", "q_df", "qprime_df")


def seamount(x, y):
    """Bottom elevation of a 1500 m seamount in the 9928 m deep basin."""
    return -9928.0 + 1500.0 * np.exp(-((x - 1e6) ** 2 + (y - 1e6) ** 2) / 4e5 ** 2)


MESHES = {
    "brick": dict(nelx=4, nely=3, xdims=(0.0, 2.0), ydims=(0.0, 1.5)),
    "scrambled": dict(nelx=5, nely=3, xdims=(0.0, 10.0), ydims=(0.0, 6.0), shuffle=0),
    "deformed_scrambled": dict(nelx=6, nely=5, xdims=(0.0, 3.0), ydims=(0.0, 2.0),
                               deform=0.3, shuffle=1),
    "deformed_bathy": dict(nelx=6, nely=5, xdims=BASIN, ydims=BASIN, deform=0.2,
                           bathy=seamount, bc_codes=(4, 2, 4, 2)),
}


def write_mesh(tmp_path, name):
    kw = dict(MESHES[name])
    if "shuffle" in kw:
        kw["shuffle"] = np.random.default_rng(kw["shuffle"])
    path = tmp_path / f"{name}.msh"
    make_msh(path, **kw)
    return path


@pytest.fixture
def jax_python_path(monkeypatch):
    """The pure-Python mesh path of both packages (their C++ front ends
    would otherwise be taken where they build)."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setenv("HNUMO_NATIVE", "0")


@pytest.mark.parametrize("name", MESHES)
def test_reader_layout_and_corners_match_jax(tmp_path, name):
    path = write_mesh(tmp_path, name)
    jm, tm = jgmsh.read_msh(path, native=False), tgmsh.read_msh(path, native=False)
    for field in ("nodes", "quads", "boundary_edges", "node_ids", "bathy"):
        a, b = getattr(jm, field), getattr(tm, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert jm.bc_map == tm.bc_map
    # the two must reorient the elements identically: the layout, the
    # rotation of every element and the corner tables, not the coordinates only
    jl = jgmsh.infer_structured_layout(jm.quads, native=False)
    tl = tgmsh.infer_structured_layout(tm.quads, native=False)
    assert jl[:2] == tl[:2]
    assert np.array_equal(jl[2], tl[2]) and np.array_equal(jl[3], tl[3])


@pytest.mark.parametrize("name", MESHES)
def test_corner_tables_and_bc_codes_match_jax(tmp_path, name, jax_python_path):
    path = write_mesh(tmp_path, name)
    jm, tm = jgmsh.read_msh(path, native=False), tgmsh.read_msh(path)
    jcc, jidx = jgmsh.structured_corner_coords(jm)
    tcc, tidx = tgmsh.structured_corner_coords(tm)
    assert np.array_equal(jidx, tidx) and np.array_equal(jcc, tcc)
    assert jgmsh.boundary_bc_codes(jm, jidx) == tgmsh.boundary_bc_codes(tm, tidx)


@pytest.mark.parametrize("name", MESHES)
def test_geometry_matches_jax(tmp_path, name, jax_python_path):
    """Coordinates, volume metrics, face normals and jacobians, at quad and
    nodal points, of the geometry built from the same file."""
    path = write_mesh(tmp_path, name)
    jg, jz = jgmsh.geometry_from_msh(path, nop=3)
    tg, tz = tgmsh.geometry_from_msh(path, nop=3)
    assert (jg.nelx, jg.nely, jg.ngl, jg.nq, jg.bc) == (tg.nelx, tg.nely, tg.ngl, tg.nq, tg.bc)
    for f in dataclasses.fields(Geometry):
        a, b = getattr(jg, f.name), getattr(tg, f.name)
        if isinstance(a, np.ndarray):
            assert_close(b, a, 1e-13, f.name)
    assert (jz is None) == (tz is None) == ("bathy" not in MESHES[name])
    if jz is not None:
        assert_close(tz, jz, 1e-13, "zbot")


def test_bc_section_and_bathymetry(tmp_path):
    """The $BC codes reach the geometry; the $Bathy depths, in the mesh file
    or in a separate file, reach the nodal bottom the same as in the JAX
    package."""
    path = write_mesh(tmp_path, "deformed_bathy")
    mesh = tgmsh.read_msh(path)
    assert mesh.bc_map == {1: 4, 2: 2, 3: 4, 4: 2}
    _, idx = tgmsh.structured_corner_coords(mesh)
    assert tgmsh.boundary_bc_codes(mesh, idx) == (4, 2, 4, 2)
    np.testing.assert_allclose(mesh.bathy, seamount(*mesh.nodes.T), rtol=1e-13)
    geom, zbot = tgmsh.geometry_from_msh(path, nop=3)
    assert geom.bc == (4, 2, 4, 2)
    # bilinear fill: the corner values at the element corners
    np.testing.assert_allclose(zbot[:, :, 0, 0], mesh.bathy[idx][:-1, :-1], rtol=1e-14)
    np.testing.assert_allclose(zbot[:, :, -1, -1], mesh.bathy[idx][1:, 1:], rtol=1e-14)
    # lread_external_bathy=.false.: the file's depths are not used
    assert tgmsh.geometry_from_msh(path, nop=3, use_bathy=False)[1] is None
    # a separate bathymetry file (its own $Bathy section) wins over the mesh's
    other = tmp_path / "other.msh"
    make_msh(other, 6, 5, BASIN, BASIN, deform=0.2, bathy=lambda x, y: -100.0 + 0 * x)
    _, z2 = tgmsh.geometry_from_msh(path, nop=3, bathy_path=other)
    _, jz2 = jgmsh.geometry_from_msh(path, nop=3, bathy_path=other)
    np.testing.assert_array_equal(z2, jz2)
    np.testing.assert_allclose(z2, -100.0, rtol=1e-15)


def test_irregular_topology_is_rejected(tmp_path):
    """An L-shaped mesh (a 2x2 grid less one element) is not a logically
    structured grid: both packages refuse it with the same message."""
    path = write_mesh(tmp_path, "brick")
    text = path.read_text().splitlines()
    i = text.index("$Elements")
    n = int(text[i + 1])
    last_quad = max(k for k in range(i + 2, i + 2 + n) if text[k].split()[1] == "3")
    del text[last_quad]
    text[i + 1] = str(n - 1)
    path.write_text("\n".join(text) + "\n")
    msgs = []
    for read, infer in ((lambda p: jgmsh.read_msh(p, native=False),
                         lambda q: jgmsh.infer_structured_layout(q, native=False)),
                        (lambda p: tgmsh.read_msh(p, native=False),
                         lambda q: tgmsh.infer_structured_layout(q, native=False))):
        with pytest.raises(ValueError, match="logically") as e:
            infer(read(path).quads)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("nel,nop,deform,uniform", [(6, 3, 0.0, True), (6, 3, 0.2, False),
                                                    (32, 4, 0.0, True), (32, 4, 0.2, False)])
def test_uniformity_of_a_mesh_from_a_file(tmp_path, nel, nop, deform, uniform,
                                          jax_python_path):
    """A brick read from a file counts as uniform in both packages (the
    megakernel and the fused path stay open), a deformed mesh in neither
    (every stage runs the general volume stage on its per-point metric); at
    6x6 and at the 32x32 of the card's curvilinear run."""
    path = tmp_path / "m.msh"
    make_msh(path, nel, nel, BASIN, BASIN, deform=deform)
    kw = dict(nopx=nop, nopy=nop, nlayers=2, xdims=BASIN, ydims=BASIN, dt=400.0,
              dt_btp=20.0, test_case="double_gyre", dtype="float64",
              lread_external_grid=True, mesh_file=str(path))
    jm = JaxModel(JaxConfig(**kw))
    tm = TorchModel(TorchConfig(**kw), device="cpu")
    assert jm.static.uniform_geom is tm.static.uniform_geom is uniform
    assert tm.static.mega is uniform


def test_model_config_describes_the_mesh(tmp_path):
    """nelx/nely and the boundary codes of the model's Config are the mesh's,
    whatever the namelist said."""
    path = write_mesh(tmp_path, "deformed_bathy")
    cfg = TorchConfig(nelx=2, nely=2, nopx=3, nopy=3, nlayers=2, xdims=BASIN, ydims=BASIN,
                      test_case="double_gyre", lread_external_grid=True,
                      mesh_file=str(path))
    m = TorchModel(cfg, device="cpu")
    assert (m.cfg.nelx, m.cfg.nely) == (6, 5)
    assert (m.cfg.x_boundary, m.cfg.y_boundary) == ((4, 2), (4, 2))
    assert m.bc[:4] == (4, 2, 4, 2)
    assert (cfg.nelx, cfg.nely) == (2, 2)      # the caller's Config is not changed
    assert m.g.wjac_df.shape[:2] == (5, 6)


def _step_both(cfg_kw, steps):
    jm = JaxModel(JaxConfig(**cfg_kw))
    tm = TorchModel(TorchConfig(**cfg_kw), device="cpu")
    sj, st = jm.state0, tm.state0
    for _ in range(steps):
        sj, st = jm.step(sj), tm.step(st)
    return jm, tm, sj, st


def test_two_steps_on_a_deformed_mesh_with_bathymetry(tmp_path, jax_python_path):
    """The double gyre (wind, Coriolis, nodal viscosity, linear drag) on a
    deformed 6x5 mesh with a seamount from $Bathy, shifted by
    bathymetry_shift, and a no-slip east and north wall from $BC."""
    path = write_mesh(tmp_path, "deformed_bathy")
    kw = dict(nopx=3, nopy=3, nlayers=2, xdims=BASIN, ydims=BASIN, dt=400.0,
              dt_btp=20.0, time_final=1e9, test_case="double_gyre", f0=9.3e-5,
              beta=2e-11, botfr=1, cd_mlswe=1e-7, method_visc=2, visc_mlswe=100.0,
              dtype="float64", lread_external_grid=True, mesh_file=str(path),
              lread_external_bathy=True, bathymetry_shift=-50.0)
    jm, tm, sj, st = _step_both(kw, 2)
    assert jm.static.uniform_geom is False and tm.static.uniform_geom is False
    assert not tm.static.mega and tm.bc[:4] == (4, 2, 4, 2)
    np.testing.assert_array_equal(tm.P.zbot_df.numpy(), np.asarray(jm.P.zbot_df))
    assert float(tm.P.zbot_df.max()) < -9928.0 + 1500.0 - 50.0 + 1e-6
    assert bool(st.ok) and bool(sj.ok)
    for name in FIELDS:
        assert_close(getattr(st, name), np.asarray(getattr(sj, name)), 1e-11, name)
    # the steps moved the state: the comparison is not of two rest states
    assert float(st.q_df[1].abs().max()) > 0.0


def test_lake_at_rest_on_deformed_mesh(tmp_path):
    """Well-balancedness on a curvilinear mesh with external bathymetry: the
    free surface stays flat over the seamount (tests/test_gmsh.py's gate)."""
    p = tmp_path / "m.msh"
    make_msh(p, 6, 6, (0.0, 1000.0), (0.0, 1000.0), deform=0.2,
             bathy=lambda x, y: -40.0 + 3.0 * (1.0 + np.cos(
                 np.pi * min(1.0, np.hypot(x - 500, y - 500) / 250.0))))
    cfg = TorchConfig(nopx=3, nopy=3, nlayers=2, dt=50.0, dt_btp=2.0,
                      time_final=500.0, test_case="lakeatrest",
                      lread_external_grid=True, mesh_file=str(p),
                      lread_external_bathy=True, dtype="float64")
    m = TorchModel(cfg, device="cpu")
    assert not m.static.uniform_geom
    s = m.run(m.state0, 10)
    q5 = derived_fields(m, s)
    assert np.abs(q5[4, 0]).max() < 1e-8, "lake not at rest"
    assert np.abs(q5[1]).max() < 1e-8 and np.abs(q5[2]).max() < 1e-8
