"""ops/dg.py and core/faces.py of the PyTorch package against the JAX
package, f64 on the CPU: same numpy inputs through both, agreement to
1e-13 of each field's max (both are the same few-term contractions; only
the summation order inside einsum differs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnumo_tpu.core import faces as jf
from hnumo_tpu.mesh.grid import build_geometry as j_build_geometry
from hnumo_tpu.ops import dg as jdg
from hnumo_tpu_torch.core import faces as tf
from hnumo_tpu_torch.mesh.grid import build_geometry as t_build_geometry
from hnumo_tpu_torch.ops import dg as tdg
from test_torch_common import assert_close, tt

REL = 1e-13
NEY, NEX, NOP = 3, 4, 4


@pytest.fixture(scope="module")
def geoms():
    args = (NEX, NEY, NOP, (0.0, 2e6), (0.0, 1e6))
    gj = jdg.device_geom(j_build_geometry(*args), jnp.float64)
    gt = tdg.device_geom(t_build_geometry(*args), torch.float64, "cpu")
    return gj, gt


def test_geometry_tables_match(geoms):
    gj, gt = geoms
    for name in tdg.DeviceGeom._fields:
        assert_close(getattr(gt, name), np.asarray(getattr(gj, name)), 1e-15, name)


def _nodal(seed, lead=(2, 3)):
    return np.random.default_rng(seed).normal(size=lead + (NEY, NEX, NOP + 1, NOP + 1))


def _quad(seed, lead=(2,)):
    nq = 2 * NOP + 1
    return np.random.default_rng(seed).normal(size=lead + (NEY, NEX, nq, nq))


def test_interp_n2q(geoms):
    gj, gt = geoms
    u = _nodal(0)
    assert_close(tdg.interp_n2q(gt, tt(u)), np.asarray(jdg.interp_n2q(gj, jnp.asarray(u))), REL)


@pytest.mark.parametrize("fn", ["grad_n2q", "grad_nodal"])
def test_gradients(geoms, fn):
    gj, gt = geoms
    u = _nodal(1)
    want = getattr(jdg, fn)(gj, jnp.asarray(u))
    got = getattr(tdg, fn)(gt, tt(u))
    for w, g_, name in zip(want, got, ("d/dx", "d/dy")):
        assert_close(g_, np.asarray(w), REL, f"{fn} {name}")


@pytest.mark.parametrize("which", ["xy", "x", "s", "xys"])
def test_scatter_volume(geoms, which):
    gj, gt = geoms
    fx, fy, fs = _quad(2), _quad(3), _quad(4)
    kj = dict(Fx=jnp.asarray(fx) if "x" in which else None,
              Fy=jnp.asarray(fy) if "y" in which else None,
              Fs=jnp.asarray(fs) if "s" in which else None)
    kt = dict(Fx=tt(fx) if "x" in which else None,
              Fy=tt(fy) if "y" in which else None,
              Fs=tt(fs) if "s" in which else None)
    assert_close(tdg.scatter_volume(gt, **kt), np.asarray(jdg.scatter_volume(gj, **kj)), REL)


def test_scatter_volume_nodal_and_project(geoms):
    gj, gt = geoms
    fx, fy = _nodal(5), _nodal(6)
    assert_close(tdg.scatter_volume_nodal(gt, tt(fx), tt(fy)),
                 np.asarray(jdg.scatter_volume_nodal(gj, jnp.asarray(fx), jnp.asarray(fy))), REL)
    f = _quad(7)
    assert_close(tdg.project_q2n(gt, tt(f)), np.asarray(jdg.project_q2n(gj, jnp.asarray(f))), REL)


BC_CASES = [(4, 4, 4, 4), (2, 2, 2, 2), (5, 4, 2, 5), (4, 2, 5, 4), (3, 3, 4, 4), (4, 2, 3, 3)]


@pytest.mark.parametrize("codes", BC_CASES, ids=lambda c: "bc" + "".join(map(str, c)))
def test_extract_faces(codes):
    u = _nodal(8, lead=(4, 2))
    pairs = ((0, 1), (2, 3))
    want = jf.extract_faces_stacked(jnp.asarray(u), jf.BCs(*codes), vec_pairs=pairs)
    got = tf.extract_faces_stacked(tt(u), tf.BCs(*codes), vec_pairs=pairs)
    for w, g_, name in zip(want, got, ("xl", "xr", "yl", "yr")):
        assert_close(g_, np.asarray(w), 0.0, name)
    # per-channel view and the (u, v) form
    multi = tf.extract_faces_multi(tt(u), tf.BCs(*codes), vec_pairs=pairs)
    assert_close(multi[2].xr, np.asarray(want[1][2]), 0.0, "multi")
    ju, jv = jf.extract_faces(jnp.asarray(u[0]), jf.BCs(*codes), jnp.asarray(u[1]))
    tu, tv = tf.extract_faces(tt(u[0]), tf.BCs(*codes), tt(u[1]))
    for a, b in zip(tuple(ju) + tuple(jv), tuple(tu) + tuple(tv)):
        assert_close(b, np.asarray(a), 0.0, "extract_faces(u, v)")
    js, none_j = jf.extract_faces(jnp.asarray(u[0]), jf.BCs(*codes))
    ts, none_t = tf.extract_faces(tt(u[0]), tf.BCs(*codes))
    assert none_j is None and none_t is None
    assert_close(ts.yl, np.asarray(js.yl), 0.0, "extract_faces(u)")


@pytest.mark.parametrize("codes", BC_CASES, ids=lambda c: "bc" + "".join(map(str, c)))
def test_face_scatter_views_and_projection(codes):
    rng = np.random.default_rng(9)
    ngl = NOP + 1
    rhs = _nodal(10, lead=(3,))
    Sx = rng.normal(size=(3, NEY, NEX + 1, ngl))
    Sy = rng.normal(size=(3, NEY + 1, NEX, ngl))
    Sxr = rng.normal(size=Sx.shape)
    Syr = rng.normal(size=Sy.shape)
    bj, bt = jf.BCs(*codes), tf.BCs(*codes)
    rhs_t = tt(rhs)
    keep = rhs_t.clone()
    for S_right_j, S_right_t in ((None, None), (jnp.asarray(Sxr), tt(Sxr))):
        assert_close(tf.scatter_face_x(rhs_t, tt(Sx), bt, S_right_t),
                     np.asarray(jf.scatter_face_x(jnp.asarray(rhs), jnp.asarray(Sx), bj, S_right_j)),
                     1e-15, "scatter_face_x")
    for S_right_j, S_right_t in ((None, None), (jnp.asarray(Syr), tt(Syr))):
        assert_close(tf.scatter_face_y(rhs_t, tt(Sy), bt, S_right_t),
                     np.asarray(jf.scatter_face_y(jnp.asarray(rhs), jnp.asarray(Sy), bj, S_right_j)),
                     1e-15, "scatter_face_y")
    assert torch.equal(rhs_t, keep), "scatter must not mutate its input"

    for got, want in zip(tf.face_views_x(tt(Sx), bt), jf.face_views_x(jnp.asarray(Sx), bj)):
        assert_close(got, np.asarray(want), 0.0, "face_views_x")
    for got, want in zip(tf.face_views_y(tt(Sy), bt), jf.face_views_y(jnp.asarray(Sy), bj)):
        assert_close(got, np.asarray(want), 0.0, "face_views_y")

    qu, qv = _nodal(11, lead=(2,)), _nodal(12, lead=(2,))
    qu_t, qv_t = tt(qu), tt(qv)
    got = tf.apply_wall_projection(qu_t, qv_t, bt)
    want = jf.apply_wall_projection(jnp.asarray(qu), jnp.asarray(qv), bj)
    for a, b in zip(got, want):
        assert_close(a, np.asarray(b), 0.0, "apply_wall_projection")
    assert torch.equal(qu_t, tt(qu)) and torch.equal(qv_t, tt(qv))
    shape = (NEY, NEX, ngl, ngl)
    for a, b in zip(tf.wall_projection_masks(shape, bt, torch.float64, "cpu"),
                    jf.wall_projection_masks(shape, bj, jnp.float64)):
        assert_close(a, np.asarray(b), 0.0, "wall_projection_masks")


def test_face_n2q_and_quad_scatter(geoms):
    gj, gt = geoms
    rng = np.random.default_rng(13)
    f = rng.normal(size=(4, NEY, NEX + 1, NOP + 1))
    assert_close(tf.face_n2q(gt.psiq, tt(f)), np.asarray(jf.face_n2q(gj.psiq, jnp.asarray(f))), REL)
    flux = rng.normal(size=(3, NEY, NEX + 1, 2 * NOP + 1))
    assert_close(tf.face_quad_scatter(gt.psiq, gt.jac_facex, tt(flux)),
                 np.asarray(jf.face_quad_scatter(gj.psiq, gj.jac_facex, jnp.asarray(flux))), REL)


@pytest.mark.parametrize("code", [0, 2, 4, 5])
def test_mirror_signs(code):
    for direction in "xy":
        assert (tf._mirror_signs(5, code, direction, ((1, 2), (3, 4)))
                == jf._mirror_signs(5, code, direction, ((1, 2), (3, 4))))
