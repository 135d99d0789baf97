"""The options off the main path, the JAX package against the port (the
counterpart of tests/test_options.py): per-direction barotropic faces, the
quad-family LDG viscosity (method_visc=1), LSRK sub-cycling, periodic
boundaries and the vertical shear stress (ad_mlswe>0).

The same inputs, made with numpy from a seed (test_torch_common.perturb),
go through the JAX function and its counterpart on tables converted from
the JAX package. f64 throughout: the stage functions to 1e-12 of each
output's max, the periodic tables of build_precomputed to 1e-13, one
barotropic solve — qb and all 52 running-average fields — to 1e-11. The
JAX reference calls take the path the port mirrors: use_pallas="on" in
interpret mode and mega="off" (tests/test_torch_common.jax_config). Each
path of the port is proved by the counters of the plain versions it
calls (`*_plain.calls`), the face pipeline by counting its function.
Whole steps: tests/test_torch_options_steps.py."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnumo_tpu.core import bcl as jbcl
from hnumo_tpu.core import btp as jbtp
from hnumo_tpu.core import viscosity as jvisc
from hnumo_tpu.core.coupling import btp_bcl_coeffs as j_coeffs
from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu.ops.dg import interp_n2q as j_n2q
from hnumo_tpu_torch.config import Config as TorchConfig
from hnumo_tpu_torch.convert import from_numpy_tables
from hnumo_tpu_torch.core import bcl as tbcl
from hnumo_tpu_torch.core import btp as tbtp
from hnumo_tpu_torch.core import viscosity as tvisc
from hnumo_tpu_torch.core.coupling import btp_bcl_coeffs as t_coeffs
from hnumo_tpu_torch.core.init import StaticConfig
from hnumo_tpu_torch.model import Model as TorchModel
from hnumo_tpu_torch.ops import btp_tail, btp_volume, btp_volume_uni, mega
from hnumo_tpu_torch.ops.dg import interp_n2q as t_n2q
from hnumo_tpu_torch.ops.dg import scatter_volume as t_scatter_volume
from test_torch_common import (assert_close, counting, jax_config, leaves, perturb,
                               to_np, torch_config, tt)

FN_REL = 1e-12
SOLVE_REL = 1e-11
TABLE_REL = 1e-13

# boundary codes ((west, east), (south, north)). Free-slip and no-slip walls
# hide a wrong boundary-face sign; a copy side shows it, and periodic sides
# are gated with walls of both kinds in the other direction.
WALLS = {"free_slip": ((4, 4), (4, 4)),
         "copy_noslip": ((0, 4), (2, 0)),
         "periodic_xy": ((3, 3), (3, 3)),
         "periodic_x": ((3, 3), (2, 0)),
         "periodic_y": ((0, 4), (3, 3))}


def walls(name):
    x, y = WALLS[name]
    return dict(x_boundary=x, y_boundary=y)


_PAIRS = {}


def pair(wall, family=2, visc=100.0, seed=5):
    """(JAX model, port model on the JAX model's converted tables, inputs):
    the inputs are a perturbed (qb, qprime) as numpy and the coupling fields
    of each package from them, with the quad-resolution viscosity weight of
    the quad family (the nodal family reads no such weight)."""
    key = (wall, family, visc, seed)
    if key not in _PAIRS:
        over = dict(method_visc=family, visc_mlswe=visc, batched_faces="off", **walls(wall))
        jm = JaxModel(jax_config(**over))
        state_np = to_np(jm.state0)
        tm = TorchModel.from_tables(
            torch_config(**over),
            *from_numpy_tables(to_np(jm.P), to_np(jm.g), state_np, "cpu", torch.float64),
            device="cpu")
        _, qb, qp = perturb(state_np, seed, "float64")
        qbj, qpj = jnp.asarray(qb), jnp.asarray(qp)
        qbt, qpt = tt(qb), tt(qp)
        cj = j_coeffs(jm.static, jm.P, jm.g, jm.bc, qpj, jbcl.extract_qprime_faces(jm.bc, qpj),
                      qpj[0], j_n2q(jm.g, qpj[0]))
        ct = t_coeffs(tm.static, tm.P, tm.g, tm.bc, qpt, tbcl.extract_qprime_faces(tm.bc, qpt),
                      qpt[0], t_n2q(tm.g, qpt[0]))
        _PAIRS[key] = (jm, tm, types.SimpleNamespace(qbj=qbj, qpj=qpj, qbt=qbt, qpt=qpt,
                                                     cj=cj, ct=ct))
    return _PAIRS[key]


def close_trees(got, want, rel, what=""):
    """Every leaf of the port's result within rel of the JAX one's max."""
    want = dict(leaves(to_np(want)))
    got = dict(leaves(got))
    assert list(got) == list(want), what
    for name, w in want.items():
        assert_close(got[name], w, rel, f"{what} {name}")


# ---- the stage functions ------------------------------------------------------

@pytest.mark.parametrize("wall", ["free_slip", "copy_noslip", "periodic_xy"])
def test_face_flux_dir(wall):
    jm, tm, x = pair(wall)
    tj, tt_ = jbtp.btp_extract_df(jm.bc, x.qbj), tbtp.btp_extract_df(tm.bc, x.qbt)
    for d in "xy":
        def args(P, coup, traces):
            fg = getattr(P.faces, d)
            edge = [getattr(getattr(coup, n), d) for n in
                    ("Q_uu_dp_edge", "Q_uv_dp_edge", "Q_vv_dp_edge", "dH_bcl_edge")]
            return (fg, *edge, [(getattr(t, d + "l"), getattr(t, d + "r")) for t in traces])

        want = jbtp._face_flux_dir(jm.static, *args(jm.P, x.cj, tj), jm.g.psiq)
        got = tbtp._face_flux_dir(tm.static, *args(tm.P, x.ct, tt_), tm.g.psiq)
        close_trees(got, want, FN_REL, f"{d}-faces")


@pytest.mark.parametrize("wall", ["free_slip", "copy_noslip", "periodic_xy"])
def test_btp_nodal_laplacian(wall):
    jm, tm, x = pair(wall)
    want = jbtp.btp_nodal_laplacian(jm.static, jm.P, jm.g, jm.bc, x.cj, x.qbj)
    got = tbtp.btp_nodal_laplacian(tm.static, tm.P, tm.g, tm.bc, x.ct, x.qbt)
    close_trees(got, want, FN_REL)


@pytest.mark.parametrize("family,visc", [(2, 100.0), (1, 100.0), (2, 0.0)],
                         ids=["nodal", "quad", "inviscid"])
@pytest.mark.parametrize("wall", ["free_slip", "copy_noslip", "periodic_xy"])
def test_btp_faces_visc(wall, family, visc):
    """The per-direction face pipeline with either viscosity family: rhs,
    both face increments, graduv and its face traces."""
    jm, tm, x = pair(wall, family, visc)
    rhs = np.random.default_rng(3).normal(size=(3,) + x.qbt.shape[1:])
    want = jbtp._btp_faces_visc(jm.static, jm.P, jm.g, jm.bc, x.cj, x.qbj, x.qpj,
                                jnp.asarray(rhs))
    got = tbtp._btp_faces_visc(tm.static, tm.P, tm.g, tm.bc, x.ct, x.qbt, x.qpt, tt(rhs))
    close_trees(got, want, FN_REL)


@pytest.mark.parametrize("family", [2, 1], ids=["nodal", "quad"])
@pytest.mark.parametrize("wall", ["free_slip", "copy_noslip", "periodic_xy"])
def test_create_rhs_btp(wall, family):
    jm, tm, x = pair(wall, family)
    want = jbtp.create_rhs_btp(jm.static, jm.P, jm.g, jm.bc, x.cj, x.qbj, x.qpj)
    got = tbtp.create_rhs_btp(tm.static, tm.P, tm.g, tm.bc, x.ct, x.qbt, x.qpt)
    close_trees(got, want, FN_REL)


@pytest.mark.parametrize("wall", ["free_slip", "copy_noslip", "periodic_xy"])
def test_btp_quad_laplacian(wall):
    jm, tm, x = pair(wall, 1)
    want = jvisc.btp_quad_laplacian(jm.static, jm.P, jm.g, jm.bc, x.cj, x.qbj, x.qpj)
    got = tvisc.btp_quad_laplacian(tm.static, tm.P, tm.g, tm.bc, x.ct, x.qbt, x.qpt)
    close_trees(got, want, FN_REL)
    assert float(got[0].abs().max()) > 0.0
    assert all(float(t.abs().max()) == 0.0 for t in (got[1], *got[2]))


@pytest.mark.parametrize("wall", ["free_slip", "copy_noslip", "periodic_xy"])
def test_bcl_quad_laplacian(wall):
    """The layers' quad-family Laplacian on random barotropic-average
    velocities (the only averages it reads)."""
    jm, tm, x = pair(wall, 1)
    rng = np.random.default_rng(11)
    ub, vb = (0.1 * rng.normal(size=x.qbt.shape[1:]) for _ in range(2))
    want = jvisc.bcl_quad_laplacian(jm.static, jm.P, jm.g, jm.bc, x.cj, x.qpj,
                                    types.SimpleNamespace(ub_df=jnp.asarray(ub),
                                                          vb_df=jnp.asarray(vb)))
    got = tvisc.bcl_quad_laplacian(tm.static, tm.P, tm.g, tm.bc, x.ct, x.qpt,
                                   types.SimpleNamespace(ub_df=tt(ub), vb_df=tt(vb)))
    assert_close(got, np.asarray(want), FN_REL)


@pytest.fixture(scope="module")
def sheared():
    """tests/test_options.py's shear-stress case: three layers of the lake at
    rest, each with its own velocity profile; the JAX model and the port on
    its converted tables."""
    from hnumo_tpu.config import Config as JaxConfig

    kw = dict(nelx=8, nely=8, nopx=3, nopy=3, xdims=(0.0, 2e3), ydims=(0.0, 2e3),
              nlayers=3, dt=20.0, dt_btp=2.0, time_final=300.0, test_case="lakeatrest",
              dtype="float64", ad_mlswe=2.0e-3, max_shear_dz=5.0)
    jm = JaxModel(JaxConfig(**kw))
    tm = TorchModel.from_tables(
        TorchConfig(**kw),
        *from_numpy_tables(to_np(jm.P), to_np(jm.g), to_np(jm.state0), "cpu", torch.float64),
        device="cpu")
    L = 3
    x = np.asarray(jm.geom.coord[..., 0])
    dpp_ref = np.asarray(jm.P.dpp_ref_df)
    u_lay = np.stack([(k + 1.0) * 0.1 * (1.0 + 0.3 * np.sin(2 * np.pi * x / 2e3))
                      for k in range(L)])
    v_lay = np.stack([(L - k) * 0.05 * np.ones_like(x) for k in range(L)])
    q_df = np.asarray(jm.state0.q_df).copy()
    q_df[1] = u_lay * dpp_ref
    q_df[2] = v_lay * dpp_ref
    return jm, tm, q_df


def test_rhs_layer_shear_stress_matches_jax(sheared):
    jm, tm, q_df = sheared
    want = jbcl.rhs_layer_shear_stress(jm.static, jm.P, jm.g, jnp.asarray(q_df))
    got = tbcl.rhs_layer_shear_stress(tm.static, tm.P, tm.g, tt(q_df))
    assert_close(got, np.asarray(want), FN_REL)


def test_rhs_layer_shear_stress_matches_dense_solve(sheared):
    """The Thomas solve against numpy's dense solve of the same tridiagonal
    system per quad column, with the reference's asymmetric diagonals
    (a = -coeff, c = -gravity*dt*coeff; src/mod_create_rhs_mlswe.F90:181-271)."""
    _, tm, q_df = sheared
    st, P, g = tm.static, tm.P, tm.g
    L = st.nlayers
    got = tbcl.rhs_layer_shear_stress(st, P, g, tt(q_df)).numpy()

    q = tt(q_df)
    dp = (P.dpp_ref_q + t_n2q(g, q[0])).numpy().reshape(L, -1)
    udp = t_n2q(g, q[1]).numpy().reshape(L, -1)
    vdp = t_n2q(g, q[2]).numpy().reshape(L, -1)
    a1 = float(P.alpha[0])
    fq = P.coriolis_quad.numpy().reshape(-1)
    coeff = np.maximum(np.sqrt(0.5 * fq * st.ad_mlswe) / a1,
                       st.ad_mlswe / (a1 * st.max_shear_dz))
    coeff1 = st.gravity * st.dt * coeff
    sol = np.zeros((2, L, dp.shape[1]))
    for i in range(dp.shape[1]):
        M = np.zeros((L, L))
        for k in range(L):
            M[k, k] = dp[k, i] + (coeff1[i] if k in (0, L - 1) else 2 * coeff1[i])
            if k > 0:
                M[k, k - 1] = -coeff[i]
            if k < L - 1:
                M[k, k + 1] = -coeff1[i]
        sol[0, :, i] = np.linalg.solve(M, udp[:, i] / dp[:, i])
        sol[1, :, i] = np.linalg.solve(M, vdp[:, i] / dp[:, i])
    tau = np.zeros((2, L + 1, dp.shape[1]))
    tau[:, 1:L] = coeff * (sol[:, :-1] - sol[:, 1:])
    F = st.gravity * (tau[:, :-1] - tau[:, 1:])
    shape = (L,) + tuple(g.wjac.shape)
    want = np.stack([t_scatter_volume(g, Fs=tt(F[c].reshape(shape))).numpy()
                     for c in range(2)])
    assert np.abs(want).max() > 0.0
    assert_close(got, want, FN_REL)


# ---- periodic tables of build_precomputed -----------------------------------

@pytest.mark.parametrize("wall", ["periodic_x", "periodic_y", "periodic_xy"])
def test_periodic_precomputed_tables(wall):
    """The port's own build_precomputed against the JAX package's on
    periodic grids: every Precomputed field, the device geometry, the
    initial state and the shared static fields."""
    jm = JaxModel(jax_config(**walls(wall)))
    tm = TorchModel(torch_config(**walls(wall)), device="cpu")
    assert tm.static.periodic and tm.bc == tuple(jm.bc[:4])
    for tree_t, tree_j in ((tm.P, jm.P), (tm.g, jm.g)):
        close_trees(tree_t, tree_j, TABLE_REL)
    for name in ("qb_df", "q_df", "qprime_df"):
        assert_close(getattr(tm.state0, name), np.asarray(getattr(jm.state0, name)),
                     TABLE_REL, name)
    for f in dataclasses.fields(StaticConfig):
        if hasattr(jm.static, f.name) and f.name not in ("ssprk_a", "ssprk_beta"):
            assert getattr(tm.static, f.name) == getattr(jm.static, f.name), f.name


# ---- one barotropic solve -----------------------------------------------------

# (case id, config overrides, the port's path): "per_dir" and "flat" are the
# per-stage path with its face pipeline, "fused" the three-stage path
SOLVES = [
    ("per_dir-visc100-k5", dict(batched_faces="off"), "per_dir"),
    ("per_dir-visc100-k3", dict(batched_faces="off", kstages=3), "per_dir"),
    ("per_dir-visc0-k5", dict(batched_faces="off", visc_mlswe=0.0), "per_dir"),
    ("per_dir-visc0-k3", dict(batched_faces="off", visc_mlswe=0.0, kstages=3), "per_dir"),
    ("quad", dict(method_visc=1), "per_dir"),
    ("lsrk5", dict(ti_method_btp="lsrk"), "flat"),
    ("lsrk14", dict(ti_method_btp="lsrk", kstages=14), "flat"),
    ("lsrk_ref", dict(ti_method_btp="lsrk_ref"), "flat"),
    ("lsrk_ref-fused", dict(ti_method_btp="lsrk_ref", fused_tail="on"), "fused"),
    ("periodic_x", walls("periodic_x"), "flat"),
    ("periodic_y", walls("periodic_y"), "flat"),
    ("periodic_xy", walls("periodic_xy"), "flat"),
    ("periodic_x-fused", dict(fused_tail="on", **walls("periodic_x")), "fused"),
    ("periodic_y-fused", dict(fused_tail="on", **walls("periodic_y")), "fused"),
    ("periodic_xy-fused", dict(fused_tail="on", **walls("periodic_xy")), "fused"),
]


def plain_calls():
    return {"volume": btp_volume.btp_volume_plain.calls,
            "volume_uni": btp_volume_uni.btp_volume_uni_plain.calls,
            "faces": btp_tail.btp_faces_plain.calls,
            "update": btp_tail.btp_update_plain.calls,
            "mega": mega.barotropic_solve_mega_plain.calls}


@pytest.mark.filterwarnings("ignore:ti_method_btp='lsrk_ref'")
@pytest.mark.parametrize("case,over,path", SOLVES, ids=[c[0] for c in SOLVES])
def test_one_solve(monkeypatch, case, over, path):
    """qb and every running average of one barotropic solve; the port's
    path proved by its counters."""
    jm = JaxModel(jax_config(**over))
    assert jm.static.use_pallas and jm.static.pallas_interpret and not jm.static.mega
    assert jm.static.fused_tail == (path == "fused")
    assert jm.static.batched_faces == (path == "flat")
    state_np = to_np(jm.state0)
    _, qb_np, qp_np = perturb(state_np, 5, "float64")
    static, P, g, bc = jm.static, jm.P, jm.g, jm.bc
    quad = static.method_visc == 1

    @jax.jit
    def run(qb, qp):
        coup = j_coeffs(static, P, g, bc, qp, jbcl.extract_qprime_faces(bc, qp), qp[0],
                        j_n2q(g, qp[0]) if quad else jnp.zeros_like(j_n2q(g, qp[0])))
        return jbtp.barotropic_solve(static, P, g, bc, coup, qb, qp, vol_ops=jm._vol_ops)

    qb_j, avg_j = run(jnp.asarray(qb_np), jnp.asarray(qp_np))

    tm = TorchModel.from_tables(
        torch_config(**over),
        *from_numpy_tables(to_np(P), to_np(g), state_np, "cpu", torch.float64),
        device="cpu")
    st = tm.static
    assert (st.fused_tail, st.batched_faces, st.mega) == (path == "fused", path == "flat", False)
    qb, qp = tt(qb_np), tt(qp_np)
    qb_keep = qb.clone()
    wq = t_n2q(tm.g, qp[0])
    coup = t_coeffs(st, tm.P, tm.g, tm.bc, qp, tbcl.extract_qprime_faces(tm.bc, qp), qp[0],
                    wq if quad else torch.zeros_like(wq))
    faces_dir = counting(monkeypatch, tbtp, "_btp_faces_visc")
    faces_flat = counting(monkeypatch, tbtp, "_btp_faces_visc_flat")
    quad_lap = counting(monkeypatch, tbtp, "btp_quad_laplacian")
    before = plain_calls()
    qb_t, avg_t = tbtp.barotropic_solve(st, tm.P, tm.g, tm.bc, coup, qb, qp,
                                        vol_ops=tm.vol_ops, tail_ops=tm.tail_ops)
    calls = {k: v - before[k] for k, v in plain_calls().items()}
    nsub = st.n_btp * st.kstages
    want = dict.fromkeys(calls, 0)
    if path == "fused":
        want.update(volume_uni=nsub, faces=nsub, update=nsub)
    else:
        want.update(volume=nsub)
    assert calls == want
    assert (len(faces_dir), len(faces_flat)) == ((nsub, 0) if path == "per_dir" else
                                                 (0, nsub) if path == "flat" else (0, 0))
    assert len(quad_lap) == (nsub if quad else 0)
    assert torch.equal(qb, qb_keep), "barotropic_solve must not mutate its input"

    for c in range(4):
        assert_close(qb_t[c], np.asarray(qb_j[c]), SOLVE_REL, f"qb[{c}]")
    want_avg, got_avg = dict(leaves(to_np(avg_j))), dict(leaves(avg_t))
    assert list(got_avg) == list(want_avg) and len(want_avg) == 16 + 2 * 18
    for name, w in want_avg.items():
        assert_close(got_avg[name], w, SOLVE_REL, name)
    if quad or st.visc_mlswe == 0.0:     # no graduvb averages in the quad family
        assert float(avg_t.graduvb.abs().max()) == 0.0
