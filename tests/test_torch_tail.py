"""The plain versions of the face and update stages of the fused barotropic
path (hnumo_tpu_torch/ops/btp_tail: btp_faces_plain, btp_update_plain)
against the JAX package's Pallas kernels `_kernel_faces` and `_kernel_update`
in interpret mode, on the JAX package's own tables carried across by
hnumo_tpu_torch/convert with their padding stripped: viscous and inviscid,
f32 and f64, the update for the weights of stages 1, 2 and 5 of SSP(5,3).
Tolerances of tests/test_pallas.py: 1e-12 of each output's max in f64, 2e-5 in
f32. Also: the port's own `build_face_tables` / `build_update_ops` against
the reference's, the 1-D tables the CUDA kernel reads against the matrices the
plain version reads, and `extract_faces_from_slabs` against the JAX package's
`extract_faces_stacked` under free-slip, no-slip and copy/no-slip walls. The
CUDA kernels themselves are held against these plain versions on the card by
chip_smoke.py."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnumo_tpu.core import faces as jfaces
from hnumo_tpu.core.bcl import extract_qprime_faces as j_qfaces
from hnumo_tpu.core.coupling import btp_bcl_coeffs as j_coeffs
from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu.ops import pallas_btp_tail as jt
from hnumo_tpu.ops.dg import interp_n2q as j_n2q
from hnumo_tpu_torch.convert import (face_tables_from_padded, from_numpy_tables,
                                     update_ops_from_padded)
from hnumo_tpu_torch.core import faces as tfaces
from hnumo_tpu_torch.core.bcl import extract_qprime_faces as t_qfaces
from hnumo_tpu_torch.core.btp import fused_edge_pack, fused_traces
from hnumo_tpu_torch.core.coupling import btp_bcl_coeffs as t_coeffs
from hnumo_tpu_torch.model import Model as TorchModel
from hnumo_tpu_torch.ops import btp_tail as tb
from hnumo_tpu_torch.ops.btp_volume import eflat
from test_torch_common import (TDTYPE, assert_close, jax_config, perturb, to_np,
                               torch_config, tt)
from test_torch_common import one_thread  # noqa: F401  (autouse)

WALLS0420 = dict(x_boundary=(0, 4), y_boundary=(2, 0))


def _visc(visc):
    return (dict(method_visc=2, visc_mlswe=100.0) if visc
            else dict(method_visc=0, visc_mlswe=0.0))


def _pad(a, n, axis=1):
    pads = [(0, 0)] * a.ndim
    pads[axis] = (0, n - a.shape[axis])
    return np.pad(a, pads, mode="edge")


@functools.lru_cache(maxsize=None)
def _models(dtype, visc):
    """A JAX model, the port's model on its converted tables, a perturbed
    state and both packages' coupling fields for it."""
    over = dict(dtype=dtype, **_visc(visc), **WALLS0420)
    jm = JaxModel(jax_config(**over))
    state_np = to_np(jm.state0)
    rng, qb_np, qp_np = perturb(state_np, 2, dtype)
    qp = jnp.asarray(qp_np)
    coup_j = j_coeffs(jm.static, jm.P, jm.g, jm.bc, qp, j_qfaces(jm.bc, qp), qp[0],
                      jnp.zeros_like(j_n2q(jm.g, qp[0])))
    tm = TorchModel.from_tables(
        torch_config(**over, fused_tail="on"),
        *from_numpy_tables(to_np(jm.P), to_np(jm.g), state_np, "cpu", TDTYPE[dtype]),
        device="cpu")
    qpt = tt(qp_np, dtype)
    zq = torch.zeros(qpt.shape[1:-2] + tm.g.wjac.shape[-2:], dtype=qpt.dtype)
    coup_t = t_coeffs(tm.static, tm.P, tm.g, tm.bc, qpt, t_qfaces(tm.bc, qpt), qpt[0], zq)
    return jm, tm, rng, qb_np, coup_j, coup_t


# ---- kernel F --------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _faces_case(dtype, visc):
    jm, tm, rng, qb_np, coup_j, coup_t = _models(dtype, visc)
    ney, nex = tm.cfg.nely, tm.cfg.nelx
    ngl, nq = tm.g.psiq.shape
    tabs_j = jt.build_face_tables(jm.P, coup_j, jm.g.psiq, visc)
    F, Fp = tabs_j.nfx + tabs_j.nfy, tabs_j.Fp
    assert Fp > F, "this grid should exercise the face padding"
    # traces of the perturbed state and of a seeded stand-in for its gradient
    gv = tt(1e-6 * rng.normal(size=(4, ney * nex, ngl * ngl)), dtype) if visc else None
    trL, trR = fused_traces(tm.bc, ney, nex, ngl, eflat(tt(qb_np, dtype)), gv)
    af0 = rng.normal(size=(16, F, nq)).astype(dtype)
    ag0 = rng.normal(size=(8, F, ngl)).astype(dtype) if visc else None
    out = jt.btp_faces_pallas(
        tabs_j, jnp.asarray(_pad(trL.numpy(), Fp)), jnp.asarray(_pad(trR.numpy(), Fp)),
        jnp.asarray(_pad(af0, Fp)), jnp.asarray(_pad(ag0, Fp)) if visc else None,
        use_visc=visc, interpret=True)
    want = [None if a is None else np.asarray(a)[:, :F] for a in out]
    return tm, coup_t, to_np(tabs_j), trL, trR, af0, ag0, want


@pytest.mark.parametrize("visc", [True, False], ids=["visc", "inviscid"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_faces_plain_matches_pallas_on_the_reference_tables(dtype, visc):
    tm, _, tabs_np, trL, trR, af0, ag0, want = _faces_case(dtype, visc)
    tabs = face_tables_from_padded(tabs_np, visc, "cpu", TDTYPE[dtype])
    assert tabs.ftab.shape[1] == tabs.nfx + tabs.nfy == trL.shape[1]
    assert trL.shape[0] == (8 if visc else 4)
    af, ag = tt(af0, dtype), tt(ag0, dtype) if visc else None
    before = tb.btp_faces_plain.calls
    S, Sv, af_out, ag_out = tb.btp_faces_plain(tabs, trL, trR, af, ag, use_visc=visc)
    assert tb.btp_faces_plain.calls == before + 1
    # the in-place contract
    assert af_out is af and ag_out is ag
    assert not np.array_equal(af.numpy(), af0)
    tol = 1e-12 if dtype == "float64" else 2e-5
    assert_close(S, want[0], tol, "S")
    assert_close(af, want[2], tol, "af")
    if visc:
        assert_close(Sv, want[1], tol, "Sv")
        assert_close(ag, want[3], tol, "ag")
    else:
        assert Sv is None and ag_out is None and want[1] is None


@pytest.mark.parametrize("visc", [True, False], ids=["visc", "inviscid"])
def test_own_face_tables_match_the_reference(visc):
    tm, coup_t, tabs_np, *_ = _faces_case("float64", visc)
    ref = face_tables_from_padded(tabs_np, visc, "cpu", torch.float64)
    own = tb.build_face_tables(tm.P, coup_t, tm.g.psiq, visc)
    ahead = tb.build_face_tables(tm.P, coup_t, tm.g.psiq, visc,
                                 static_rows=tm.tail_ops.face_rows)
    for tabs in (own, ahead):
        assert (tabs.nfx, tabs.nfy) == (ref.nfx, ref.nfy)
        assert_close(tabs.ftab, ref.ftab.numpy(), 1e-12, "ftab")
        assert_close(tabs.ntab, ref.ntab.numpy(), 1e-14, "ntab")
        assert_close(tabs.psiq, ref.psiq.numpy(), 0.0, "psiq")
        if visc:
            assert_close(tabs.bgf, ref.bgf.numpy(), 1e-12, "bgf")
        else:
            assert tabs.bgf is None and ref.bgf is None
            assert not np.asarray(tabs_np.bgf).any()   # a block of zeros there


# ---- kernel U --------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _update_case(dtype, visc):
    jm, tm, rng, qb_np, _, coup_t = _models(dtype, visc)
    ney, nex = tm.cfg.nely, tm.cfg.nelx
    ngl = tm.g.psiq.shape[0]
    E, npts = ney * nex, ngl * ngl
    uops_j = jt.build_update_ops(jm.static, jm.P, jm.g, E)
    qb1 = np.asarray(eflat(tt(qb_np, dtype)))

    def noise(shape, amp):
        return (amp * rng.normal(size=shape)).astype(dtype)

    op = dict(rhs=noise((3, E, npts), 1e-2), edges=noise((3, E, 4 * ngl), 1e2),
              qb0=qb1 + np.abs(noise(qb1.shape, 1e-3)), qb1=qb1,
              qb2=qb1 + np.abs(noise(qb1.shape, 1e-3)),
              mask=np.stack([np.asarray(eflat(m)) for m in tfaces.wall_projection_masks(
                  (ney, nex, ngl, ngl), tm.bc, TDTYPE[dtype], "cpu")]))
    if visc:
        op.update(vedges=noise((2, E, 4 * ngl), 1e-3), gv=noise((4, E, npts), 1e-6),
                  pbpv=np.asarray(eflat(coup_t.pbprime_visc.contiguous()))[None],
                  bdg=np.asarray(eflat(coup_t.btp_dpp_graduv.contiguous())))
    else:
        op.update(vedges=None, gv=None, pbpv=None, bdg=None)
    return jm, tm, uops_j, op


# stages 1, 2 and 5 of SSP(5,3) weight qb0, qb1, and qb1 with qb2; no stage of
# it weights all three registers, so one set of made-up weights does
@pytest.mark.parametrize("stage", [0, 1, 4, "all"])
@pytest.mark.parametrize("visc", [True, False], ids=["visc", "inviscid"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_update_plain_matches_pallas_on_the_reference_tables(dtype, visc, stage):
    jm, tm, uops_j, op = _update_case(dtype, visc)
    if stage == "all":
        a, beta = np.array([0.2, 0.3, 0.5]), 0.3
    else:
        a = np.asarray(jm.P.ssprk_a)[stage]
        beta = float(np.asarray(jm.P.ssprk_beta)[stage])
        assert tuple(a != 0) == {0: (True, False, False), 1: (False, True, False),
                                 4: (False, True, True)}[stage]
    w = (float(a[0]), float(a[1]), float(a[2]), jm.static.dt_btp * beta)

    def j(x):
        return None if x is None else jnp.asarray(x)

    want = np.asarray(jt.btp_update_pallas(
        uops_j, jnp.asarray(w, dtype=dtype), j(op["rhs"]), j(op["edges"]), j(op["vedges"]),
        j(op["qb0"]), j(op["qb1"]), j(op["qb2"]), j(op["gv"]), j(op["pbpv"]),
        j(op["bdg"]), j(op["mask"]), use_visc=visc, interpret=True))

    uops = update_ops_from_padded(to_np(uops_j), tm.tail_ops.upd)
    t = {k: (None if v is None else tt(v, dtype)) for k, v in op.items()}
    keep = {k: t[k].clone() for k in ("qb0", "qb1", "qb2", "rhs")}
    before = tb.btp_update_plain.calls
    got = tb.btp_update_plain(uops, w, t["rhs"], t["edges"], t["vedges"], t["qb0"],
                              t["qb1"], t["qb2"], t["gv"], t["pbpv"], t["bdg"],
                              t["mask"], use_visc=visc)
    assert tb.btp_update_plain.calls == before + 1
    for k, v in keep.items():     # no operand is mutated
        assert torch.equal(t[k], v), k
    assert got.data_ptr() not in {t[k].data_ptr() for k in ("qb0", "qb1", "qb2")}
    tol = 1e-12 if dtype == "float64" else 2e-5
    for c, name in enumerate(("pb", "pbpert", "pbub", "pbvb")):
        assert_close(got[c], want[c], tol, name)
    # the walls of this case mask some momentum nodes
    assert (got[2] == 0).any() and (got[3] == 0).any()


@pytest.mark.parametrize("visc", [True, False], ids=["visc", "inviscid"])
def test_own_update_operators_match_the_reference(visc):
    jm, tm, uops_j, _ = _update_case("float64", visc)
    own, ref = tm.tail_ops.upd, to_np(uops_j)
    for name in ("Escat", "Evisc", "Vx", "Vy", "pbprime_df", "ref"):
        assert_close(getattr(own, name), getattr(ref, name), 1e-14, name)
    assert own.visc == (100.0 if visc else 0.0)


def test_update_one_d_tables_describe_the_same_operators():
    """What the CUDA kernel reads (dpsi, wn2, minv, visc and the edge slots)
    rebuilds what the plain version reads (Escat, Evisc, Vx, Vy)."""
    _, tm, _, _ = _update_case("float64", True)
    u = tm.tail_ops.upd
    ngl = u.dpsi.shape[0]
    npts = ngl * ngl
    # placement: slot k of side [W, E, S, N] -> node
    E4 = torch.zeros((4 * ngl, npts), dtype=torch.float64)
    for k in range(ngl):
        for side, node in enumerate((k * ngl, k * ngl + ngl - 1, k, (ngl - 1) * ngl + k)):
            E4[side * ngl + k, node] = 1.0
    assert_close(E4 * u.minv, u.Escat.numpy(), 1e-15, "Escat")
    assert_close(E4 * (u.visc * u.minv), u.Evisc.numpy(), 1e-15, "Evisc")
    eye = torch.eye(ngl, dtype=torch.float64)
    wx, wy = u.wn2[0].view(ngl, ngl), u.wn2[1].view(ngl, ngl)
    Vx = torch.einsum("JI,Jj,iI->JIji", wx, eye, u.dpsi).reshape(npts, npts)
    Vy = torch.einsum("JI,Ii,jJ->JIji", wy, eye, u.dpsi).reshape(npts, npts)
    assert_close(-u.visc * u.minv * Vx, u.Vx.numpy(), 1e-15, "Vx")
    assert_close(-u.visc * u.minv * Vy, u.Vy.numpy(), 1e-15, "Vy")


def test_converters_strip_the_padding():
    jm, tm, uops_j, _ = _update_case("float64", True)
    ref = to_np(uops_j)
    E = tm.tail_ops.upd.ref.shape[1]
    padded = ref._replace(pbprime_df=_pad(ref.pbprime_df, E + 3, axis=0),
                          ref=_pad(ref.ref, E + 3))
    u = update_ops_from_padded(padded, tm.tail_ops.upd)
    assert u.ref.shape == (3, E, 25) and u.pbprime_df.shape == (E, 25)
    assert np.array_equal(u.ref.numpy(), ref.ref)
    assert u.dpsi is tm.tail_ops.upd.dpsi


@pytest.mark.parametrize("stage_fn", ["faces", "update"])
@pytest.mark.parametrize("breakage", ["noncontiguous", "dtype", "shape", "missing", "cuda"])
def test_wrapper_contracts_raise(stage_fn, breakage):
    """Operands a stage does not take raise; the CUDA wrappers never swap in
    the plain version on CPU tensors."""
    if stage_fn == "faces":
        tm, _, tabs_np, trL, trR, af0, ag0, _ = _faces_case("float64", True)
        tabs = face_tables_from_padded(tabs_np, True, "cpu", torch.float64)
        args = [tabs, trL, trR, tt(af0), tt(ag0)]
        fn, cuda, bad = tb.btp_faces_plain, tb.btp_faces_cuda, 3
    else:
        _, tm, _, op = _update_case("float64", True)
        t = {k: tt(v) for k, v in op.items()}
        args = [tm.tail_ops.upd, (1.0, 0.0, 0.0, 0.1), t["rhs"], t["edges"], t["vedges"],
                t["qb0"], t["qb1"], t["qb2"], t["gv"], t["pbpv"], t["bdg"], t["mask"]]
        fn, cuda, bad = tb.btp_update_plain, tb.btp_update_cuda, 2
    if breakage == "noncontiguous":
        args[bad] = args[bad].transpose(1, 2).contiguous().transpose(1, 2)
    elif breakage == "dtype":
        args[bad] = args[bad].float()
    elif breakage == "shape":
        args[bad] = args[bad][:, :-1].contiguous()
    elif breakage == "missing":
        args[4] = None          # ag / vedges, needed when viscous
    else:
        fn = cuda
    before = cuda.launches
    with pytest.raises(ValueError, match="CUDA" if breakage == "cuda" else None):
        fn(*args, use_visc=True)
    assert cuda.launches == before


# ---- the exchange ---------------------------------------------------------------


@pytest.mark.parametrize("walls", [(4, 4, 4, 4), (2, 2, 2, 2), (0, 4, 2, 0)],
                         ids=["free-slip", "no-slip", "walls0420"])
def test_extract_faces_from_slabs_matches_extract_faces_stacked(walls):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(8, 5, 6, 5, 5))
    vec_pairs = ((2, 3), (4, 5), (6, 7))
    want = jfaces.extract_faces_stacked(jnp.asarray(q), jfaces.BCs(*walls), vec_pairs)
    bc = tfaces.BCs(*walls)
    qt = tt(q)
    slabs = (qt[..., :, -1], qt[..., :, 0], qt[..., -1, :], qt[..., 0, :])
    got = tfaces.extract_faces_from_slabs(*slabs, bc, vec_pairs=vec_pairs)
    stacked = tfaces.extract_faces_stacked(qt, bc, vec_pairs)
    for name, g, s, w in zip(("xl", "xr", "yl", "yr"), got, stacked, want):
        assert_close(g, np.asarray(w), 0.0, name)
        assert torch.equal(g, s), name
    # and the flat-layout form the fused path uses
    trL, trR = fused_traces(bc, 5, 6, 5, eflat(qt[:4].contiguous()),
                            eflat(qt[4:].contiguous()))
    nfx = 5 * 7
    assert_close(trL[:, :nfx].reshape(8, 5, 7, 5), np.asarray(want[0]), 0.0, "trL x")
    assert_close(trR[:, nfx:].reshape(8, 6, 6, 5), np.asarray(want[3]), 0.0, "trR y")


@pytest.mark.parametrize("walls", [(4, 4, 4, 4), (0, 4, 2, 0)], ids=["free-slip", "walls0420"])
def test_edge_pack_places_what_scatter_face_adds(walls):
    """Placing the packed edge values [W, E, S, N] on the edge nodes equals
    scatter_face_x + scatter_face_y of the structured path."""
    rng = np.random.default_rng(5)
    ney, nex, ngl = 5, 6, 5
    nfx, nfy = ney * (nex + 1), (ney + 1) * nex
    S = tt(rng.normal(size=(3, nfx + nfy, ngl)))
    bc = tfaces.BCs(*walls)
    edges = fused_edge_pack(bc, ney, nex, S)
    assert edges.shape == (3, ney * nex, 4 * ngl)
    zero = torch.zeros((3, ney, nex, ngl, ngl), dtype=torch.float64)
    want = tfaces.scatter_face_y(
        tfaces.scatter_face_x(zero, S[:, :nfx].reshape(3, ney, nex + 1, ngl), bc),
        S[:, nfx:].reshape(3, ney + 1, nex, ngl), bc)
    e = edges.view(3, ney, nex, 4, ngl)
    got = zero.clone()
    got[..., :, 0] += e[..., 0, :]
    got[..., :, -1] += e[..., 1, :]
    got[..., 0, :] += e[..., 2, :]
    got[..., -1, :] += e[..., 3, :]
    assert torch.equal(got, want)
    assert torch.equal(fused_edge_pack(bc, ney, nex, S, negate=True), -edges)
