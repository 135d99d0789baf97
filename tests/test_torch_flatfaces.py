"""The port's flat face machinery (hnumo_tpu_torch/mesh/flatfaces.py)
against the JAX package's (hnumo_tpu/mesh/flatfaces.py), on the CPU, f64:

- the tables, bitwise and of the same dtype, on the pinwheel, on bricks of
  1x1, 2x3, 8x8 and 32x32 at ngl 3, 5, 9, on a brick shuffled and rotated
  from a seed, and on a mesh with an edge shared by three elements (the
  third element's side becomes a boundary face in both, whatever the JAX
  docstring says); the same ValueError on a clockwise element;
- `face_geometry` to 1e-13 with dpsi = Basis1D(nop).dpsi.T, and the
  identities of tests/test_flatfaces.py (unit normals, the divergence
  theorem per element) plus each pinwheel spoke's length, 1: the
  untransposed `Basis1D.dpsi` fails that one, which pins the convention;
- traces bitwise, scatter to 1e-14 of the field's max (index_add_ adds
  into a corner node in another order than XLA), the adjoint identity,
  coordinate continuity across interior faces, the caller's `rhs` left as
  it was;
- on a brick, the flat traces are bitwise the structured path's
  (core/faces.extract_faces_stacked), face by face;
- the port's structured loader rejects the pinwheel, as the JAX test
  requires of its own.
"""
import numpy as np
import pytest
import torch

from hnumo_tpu.mesh import flatfaces as jff
from hnumo_tpu_torch.basis.lgl import Basis1D, lgl_points_weights
from hnumo_tpu_torch.core import faces as tf
from hnumo_tpu_torch.mesh import flatfaces as ff

TABLES = ("idx_L", "idx_R", "elem_L", "elem_R", "side_L", "is_boundary")
GEOM_TOL = 1e-13
SCATTER_TOL = 1e-14


def brick(nely: int, nelx: int, deform: float = 0.0, seed: int = 0):
    """An (nely, nelx) brick on [0, nelx] x [0, nely]: vertices (V, 2) and CCW
    quads (E, 4) in the structured element order e = ey*nelx + ex, corners
    SW, SE, NE, NW; `deform` moves the interior vertices at random (a
    fraction of a cell, from `seed`)."""
    jj, ii = np.meshgrid(np.arange(nely + 1), np.arange(nelx + 1), indexing="ij")
    verts = np.stack([ii, jj], -1).reshape(-1, 2).astype(float)
    if deform:
        rng = np.random.default_rng(seed)
        inner = ((ii > 0) & (ii < nelx) & (jj > 0) & (jj < nely)).reshape(-1)
        verts[inner] += deform * rng.uniform(-1, 1, size=(inner.sum(), 2))
    v = lambda j, i: j * (nelx + 1) + i  # noqa: E731
    quads = np.array([[v(ey, ex), v(ey, ex + 1), v(ey + 1, ex + 1), v(ey + 1, ex)]
                      for ey in range(nely) for ex in range(nelx)])
    return verts, quads


def shuffled_brick(seed: int):
    """A 6x5 brick whose elements are in random order and whose vertex lists
    are rotated at random (still counter-clockwise)."""
    verts, quads = brick(6, 5)
    rng = np.random.default_rng(seed)
    quads = quads[rng.permutation(len(quads))]
    return verts, np.array([np.roll(q, -int(k)) for q, k in
                            zip(quads, rng.integers(0, 4, len(quads)))])


def three_on_an_edge():
    """Three quads on the edge (0, 1), their vertex lists consistently
    oriented: every edge two of them share runs opposite ways in the two."""
    verts = np.array([[0, 0], [1, 0], [1, 1], [0, 1], [1, -1], [0, -1],
                      [0.5, 2.0]], float)
    quads = np.array([[0, 1, 2, 3], [5, 4, 1, 0], [1, 0, 6, 2]])
    return verts, quads


MESHES = {"pinwheel": lambda: jff.pinwheel_mesh(),
          "brick1x1": lambda: brick(1, 1), "brick2x3": lambda: brick(2, 3),
          "brick8x8": lambda: brick(8, 8), "brick32x32": lambda: brick(32, 32),
          "brick_shuffled": lambda: shuffled_brick(7),
          "three_on_an_edge": three_on_an_edge}


@pytest.mark.parametrize("ngl", [3, 5, 9])
@pytest.mark.parametrize("mesh", MESHES)
def test_tables_are_the_jax_package_s(mesh, ngl):
    _, quads = MESHES[mesh]()
    got, want = ff.build_flat_faces(quads, ngl), jff.build_flat_faces(quads, ngl)
    for name in TABLES:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert got.n_interior == want.n_interior
    F = got.idx_L.shape[0]
    assert got.is_boundary.sum() == F - got.n_interior
    assert not got.is_boundary[:got.n_interior].any()


def test_an_edge_of_three_elements_gives_a_boundary_face():
    """Elements 0 and 1 pair on the edge (0, 1); element 2, the third on it,
    pairs with element 0 on the edge (1, 2), and its side on (0, 1) becomes
    a boundary face of its own. Nothing raises."""
    _, quads = three_on_an_edge()
    faces = ff.build_flat_faces(quads, 3)
    assert faces.n_interior == 2
    interior = [(int(e), int(s), int(r)) for e, s, r in
                zip(faces.elem_L, faces.side_L, faces.elem_R)][:2]
    assert interior == [(0, 0, 1), (0, 1, 2)]
    bnd = [(int(e), int(s)) for e, s, b in zip(faces.elem_L, faces.side_L,
                                               faces.is_boundary) if b]
    assert (2, 0) in bnd


@pytest.mark.parametrize("pkg", [ff, jff], ids=["port", "jax"])
def test_a_clockwise_element_raises(pkg):
    _, quads = brick(2, 2)
    quads = quads.copy()
    quads[3] = quads[3][::-1]
    with pytest.raises(ValueError, match="not consistently oriented"):
        pkg.build_flat_faces(quads, 5)


# ---- geometry ---------------------------------------------------------------

def _geometry_case(name, nop=4):
    verts, quads = (ff.pinwheel_mesh() if name == "pinwheel"
                    else brick(8, 8, deform=0.3, seed=5))
    b = Basis1D(nop)
    faces = ff.build_flat_faces(quads, b.ngl)
    coords = ff.bilinear_coords(verts, quads, b.xgl)
    return verts, quads, faces, coords, b


def _poly_area(pts):
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


@pytest.mark.parametrize("name", ["pinwheel", "deformed_brick8x8"])
def test_face_geometry_is_the_jax_package_s_and_exact(name):
    verts, quads, faces, coords, b = _geometry_case(name)
    dpsi = b.dpsi.T                       # dpsi[m, n] = psi_n'(xi_m)
    assert np.array_equal(coords, jff.bilinear_coords(verts, quads, b.xgl))
    got = ff.face_geometry(coords, faces, b.wgl, dpsi)
    want = jff.face_geometry(coords, jff.build_flat_faces(quads, b.ngl), b.wgl, dpsi)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=GEOM_TOL * np.abs(w).max())
    nx, ny, jac = got
    np.testing.assert_allclose(nx * nx + ny * ny, 1.0, rtol=0, atol=1e-12)
    # divergence theorem for F = (x, y): sum of w*jac*(n.F) over an
    # element's faces is 2*area (straight sides: LGL quadrature is exact)
    xy = coords.reshape(-1, 2)[faces.idx_L]
    flux = (jac * (nx * xy[..., 0] + ny * xy[..., 1])).sum(-1)
    per_elem = np.zeros(len(quads))
    np.add.at(per_elem, faces.elem_L, flux)
    np.add.at(per_elem, faces.elem_R[~faces.is_boundary], -flux[~faces.is_boundary])
    areas = np.array([_poly_area(verts[q]) for q in quads])
    np.testing.assert_allclose(per_elem, 2.0 * areas, rtol=1e-12)


@pytest.mark.parametrize("layout", ["dpsi.T", "dpsi"])
def test_spoke_lengths_pin_the_dpsi_convention(layout):
    """Each spoke of the pinwheel (its 3 interior faces) is 1 long: the sum
    of w*|dx/ds| along it, with dpsi[m, n] = psi_n'(xi_m) = Basis1D.dpsi.T.
    Basis1D.dpsi as it is, (basis, node), gives another length; unit
    normals alone would not show it (they are normalised)."""
    _, _, faces, coords, b = _geometry_case("pinwheel")
    dpsi = b.dpsi.T if layout == "dpsi.T" else b.dpsi
    nx, ny, jac = ff.face_geometry(coords, faces, b.wgl, dpsi)
    lengths = jac[:faces.n_interior].sum(-1)
    np.testing.assert_allclose(nx * nx + ny * ny, 1.0, rtol=0, atol=1e-12)
    if layout == "dpsi.T":
        np.testing.assert_allclose(lengths, 1.0, rtol=0, atol=1e-12)
    else:
        assert np.abs(lengths - 1.0).min() > 0.1, lengths


# ---- traces and scatter ---------------------------------------------------------

def _traces_case(name, C=3, nop=4, seed=3):
    verts, quads = ff.pinwheel_mesh() if name == "pinwheel" else brick(32, 32)
    ngl = nop + 1
    faces = ff.build_flat_faces(quads, ngl)
    rng = np.random.default_rng(seed)
    E, F = len(quads), faces.idx_L.shape[0]
    u = rng.normal(size=(C, E, ngl, ngl))
    SL, SR = rng.normal(size=(2, C, F, ngl))
    SR[:, faces.is_boundary] = 0.0        # boundary faces: all in S_L
    rhs = rng.normal(size=(C, E, ngl, ngl))
    xgl, _ = lgl_points_weights(ngl)
    coords = ff.bilinear_coords(verts, quads, xgl)
    return faces, u, SL, SR, rhs, coords


@pytest.mark.parametrize("name", ["pinwheel", "brick32x32"])
def test_traces_and_scatter_are_the_jax_package_s(name):
    import jax.numpy as jnp

    faces, u, SL, SR, rhs, _ = _traces_case(name)
    jfaces = jff.build_flat_faces(MESHES[name]()[1], 5)
    dev = faces.to("cpu")
    assert dev.idx_L.dtype == torch.int32 and dev.idx_L.shape == (faces.idx_L.size,)
    uL, uR = ff.extract_traces(torch.tensor(u), dev)
    jL, jR = jff.extract_traces(jnp.asarray(u), jfaces)
    assert np.array_equal(uL.numpy(), np.asarray(jL))
    assert np.array_equal(uR.numpy(), np.asarray(jR))
    rhs_t = torch.tensor(rhs)
    got = ff.scatter_faces(rhs_t, torch.tensor(SL), torch.tensor(SR), dev).numpy()
    want = np.asarray(jff.scatter_faces(jnp.asarray(rhs), jnp.asarray(SL),
                                        jnp.asarray(SR), jfaces))
    np.testing.assert_allclose(got, want, rtol=0, atol=SCATTER_TOL * np.abs(want).max())
    assert np.array_equal(rhs_t.numpy(), rhs), "scatter_faces changed the caller's rhs"


@pytest.mark.parametrize("name", ["pinwheel", "brick32x32"])
def test_scatter_is_the_adjoint_of_extract(name):
    """<extract(u), S> over faces == <u, scatter(S)> over elements."""
    faces, u, SL, SR, _, _ = _traces_case(name)
    dev = faces.to("cpu")
    ut = torch.tensor(u)
    uL, uR = ff.extract_traces(ut, dev)
    lhs = float((uL * torch.tensor(SL)).sum() + (uR * torch.tensor(SR)).sum())
    rhs = float((ut * ff.scatter_faces(torch.zeros_like(ut), torch.tensor(SL),
                                       torch.tensor(SR), dev)).sum())
    assert abs(lhs - rhs) < 1e-12 * max(1.0, abs(lhs))


@pytest.mark.parametrize("name", ["pinwheel", "brick32x32"])
def test_coordinates_are_continuous_across_interior_faces(name):
    """The L and R traces of the coordinates agree node by node on interior
    faces: this pins the index maps and the orientation folding."""
    faces, *_, coords = _traces_case(name)
    dev = faces.to("cpu")
    for c in range(2):
        uL, uR = ff.extract_traces(torch.tensor(coords[None, ..., c]), dev)
        err = (uL - uR)[0, :faces.n_interior].abs().max().item()
        assert err < 1e-14, (c, err)


def test_the_run_time_functions_take_device_tables_only():
    faces, u, SL, SR, rhs, _ = _traces_case("pinwheel")
    with pytest.raises(TypeError, match="FlatFaces.to"):
        ff.extract_traces(torch.tensor(u), faces)
    dev = faces.to("cpu")
    with pytest.raises(ValueError, match="lies on meta"):
        ff.extract_traces(torch.empty(u.shape, device="meta"), dev)


# ---- against the structured path ----------------------------------------------

# Along each local side, the flat table runs the element's nodes counter-
# clockwise; the structured traces (core/faces) run them in ascending i
# (y-faces) or j (x-faces). So the flat trace of side s is the structured
# own-side trace in that order (south, east) or reversed (north, west).
SIDE_REVERSED = {0: False, 1: False, 2: True, 3: True}


def structured_pair(xl, xr, yl, yr, e, side, nelx):
    """The structured traces (own side, other side) of element e's side,
    each (C, ngl), in the flat table's node order of that side."""
    ey, ex = divmod(int(e), nelx)
    own, other = {0: (yr[:, ey, ex], yl[:, ey, ex]),
                  1: (xl[:, ey, ex + 1], xr[:, ey, ex + 1]),
                  2: (yl[:, ey + 1, ex], yr[:, ey + 1, ex]),
                  3: (xr[:, ey, ex], xl[:, ey, ex])}[int(side)]
    if SIDE_REVERSED[int(side)]:
        own, other = own.flip(-1), other.flip(-1)
    return own, other


@pytest.mark.parametrize("nely,nelx,ngl", [(1, 1, 3), (2, 3, 5), (8, 8, 5), (6, 9, 9)])
def test_flat_traces_are_the_structured_path_s(nely, nelx, ngl):
    _, quads = brick(nely, nelx)
    faces = ff.build_flat_faces(quads, ngl)
    rng = np.random.default_rng(nely * 100 + nelx)
    q = torch.tensor(rng.normal(size=(4, nely, nelx, ngl, ngl)))
    xl, xr, yl, yr = tf.extract_faces_stacked(q, tf.BCs(4, 4, 4, 4))
    uL, uR = ff.extract_traces(q.reshape(4, nely * nelx, ngl, ngl), faces.to("cpu"))
    for f in range(faces.idx_L.shape[0]):
        own, other = structured_pair(xl, xr, yl, yr, faces.elem_L[f], faces.side_L[f], nelx)
        assert torch.equal(uL[:, f], own), f
        if not faces.is_boundary[f]:
            assert torch.equal(uR[:, f], other), f
        else:
            assert torch.equal(uR[:, f], uL[:, f]), f


def test_structured_loader_rejects_the_pinwheel():
    from hnumo_tpu_torch.mesh import _native
    from hnumo_tpu_torch.mesh.gmsh import infer_structured_layout

    _, quads = ff.pinwheel_mesh()
    with pytest.raises(ValueError):
        infer_structured_layout(quads, native=False)
    if _native.available():
        with pytest.raises(ValueError):
            infer_structured_layout(quads, native=True)
