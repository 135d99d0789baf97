"""The plain version of the uniform-geometry barotropic volume stage
(hnumo_tpu_torch/ops/btp_volume_uni.btp_volume_uni_plain) against the JAX
package's Pallas kernel `_kernel_uni` in interpret mode, on the JAX package's
own `operators_uniform` tables carried across by hnumo_tpu_torch/convert: with
the velocity gradient and the inverse mass folded in (the fused path's kernel
A, `btp_volume_grad_pallas_uni`) and without either (the per-stage path under
uni_volume, `btp_volume_pallas_uni`); botfr 0/1/2 x f32/f64 x flat
(double-gyre) and non-flat (seamount) bottom, random non-zero initial
accumulators. Tolerances of tests/test_pallas.py: 1e-12 of each output's max
in f64, 2e-5 in f32 (same operations; the ~100-term sums are taken in another
order). Also: the port's own operator tables against the reference's, and the
1-D tables the CUDA kernel reads against the Kronecker matrices the plain
version reads. The CUDA kernel itself is held against this plain version on
the card by chip_smoke.py."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnumo_tpu.core.bcl import extract_qprime_faces
from hnumo_tpu.core.coupling import btp_bcl_coeffs
from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu.ops import pallas_btp as jp
from hnumo_tpu.ops.dg import interp_n2q
from hnumo_tpu_torch.convert import from_numpy_tables, vol_ops_uni_from_padded
from hnumo_tpu_torch.ops import btp_volume_uni as tu
from hnumo_tpu_torch.ops.btp_volume import eflat
from test_torch_common import TDTYPE, assert_close, jax_config, perturb, to_np, tt

CASES = {"flat": "double_gyre", "nonflat": "seamount"}
OUT = ("rhs", "accv", "accn", "gv", "agr")


@functools.lru_cache(maxsize=None)
def _case(dtype, botfr, bottom):
    """Seeded operands, the two Pallas results and the port's operators."""
    m = JaxModel(jax_config(dtype=dtype, botfr=botfr, test_case=CASES[bottom]))
    static, P, g, bc = m.static, m.P, m.g, m.bc
    assert static.flat_bottom is (bottom == "flat")
    rng, qb_np, qp_np = perturb(to_np(m.state0), 1, dtype)
    qb, qp = jnp.asarray(qb_np), jnp.asarray(qp_np)
    coup = btp_bcl_coeffs(static, P, g, bc, qp, extract_qprime_faces(bc, qp), qp[0],
                          jnp.zeros_like(interp_n2q(g, qp[0])))
    ney, nex = g.wjac.shape[:2]
    nq, ngl = g.wjac.shape[-1], g.wjac_df.shape[-1]
    E = ney * nex
    acc0 = {"accv": rng.normal(size=(12, E, nq * nq)).astype(dtype),
            "accn": rng.normal(size=(3, E, ngl * ngl)).astype(dtype),
            "agr": rng.normal(size=(4, E, ngl * ngl)).astype(dtype)}
    coup_flat = jnp.stack([jp.eflat(c) for c in
                           (coup.Q_uu_dp, coup.Q_uv_dp, coup.Q_vv_dp, coup.dH_bcl)])
    kw = dict(grav=static.gravity, botfr=static.botfr, cd=static.cd_mlswe,
              alpha_bot=static.alpha_bot)
    jkw = dict(flat_bottom=static.flat_bottom, interpret=True, **kw)
    qbf, qpln = jp.eflat(qb), jp.eflat(qp[:, -1])
    j = {k: jnp.asarray(v) for k, v in acc0.items()}

    ops_grad = jp.operators_uniform(g, P, static.flat_bottom, fold_massinv=True,
                                    with_grad=True)
    want_grad = jp.btp_volume_grad_pallas_uni(ops_grad, qbf, qpln, j["accv"], j["accn"],
                                              coup_flat, j["agr"], **jkw)
    ops_bare = jp.operators_uniform(g, P, static.flat_bottom)
    want_bare = jp.btp_volume_pallas_uni(ops_bare, qbf, qpln, j["accv"], j["accn"],
                                         coup_flat, **jkw)

    Pt, gt, _ = from_numpy_tables(to_np(P), to_np(g), to_np(m.state0), "cpu", TDTYPE[dtype])
    own = {"grad": tu.operators_uniform(gt, Pt, static.flat_bottom, fold_massinv=True,
                                        with_grad=True),
           "bare": tu.operators_uniform(gt, Pt, static.flat_bottom)}
    ref_ops = {"grad": to_np(ops_grad), "bare": to_np(ops_bare)}
    operands = dict(qb=eflat(tt(qb_np, dtype)), qpln=tt(np.asarray(qpln), dtype),
                    coup=tt(np.asarray(coup_flat), dtype))
    want = {"grad": [np.asarray(a) for a in want_grad],
            "bare": [np.asarray(a) for a in want_bare]}
    return own, ref_ops, operands, acc0, kw, want


def _run(ops, operands, acc0, kw, dtype, with_grad):
    acc = {k: tt(v, dtype) for k, v in acc0.items()}
    out = tu.btp_volume_uni_plain(ops, operands["qb"], operands["qpln"], acc["accv"],
                                  acc["accn"], operands["coup"],
                                  acc["agr"] if with_grad else None, **kw)
    # the in-place contract: the same tensors come back, updated
    assert out[1] is acc["accv"] and out[2] is acc["accn"]
    assert not np.array_equal(acc["accv"].numpy(), acc0["accv"])
    if with_grad:
        assert out[4] is acc["agr"]
    return out


@pytest.mark.parametrize("bottom", ["flat", "nonflat"])
@pytest.mark.parametrize("botfr", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("variant", ["grad", "bare"])
def test_plain_matches_pallas_on_the_reference_tables(variant, dtype, botfr, bottom):
    own, ref_ops, operands, acc0, kw, want = _case(dtype, botfr, bottom)
    ops = vol_ops_uni_from_padded(ref_ops[variant], own[variant])
    assert ops.flat_bottom is (bottom == "flat")
    assert (ops.Gx is not None) is (variant == "grad")
    before = tu.btp_volume_uni_plain.calls
    out = _run(ops, operands, acc0, kw, dtype, variant == "grad")
    assert tu.btp_volume_uni_plain.calls == before + 1
    assert len(out) == len(want[variant]) == (5 if variant == "grad" else 3)
    tol = 1e-12 if dtype == "float64" else 2e-5
    for name, got, w in zip(OUT, out, want[variant]):
        assert got.dtype == TDTYPE[dtype]
        assert_close(got, w, tol, f"{name} ({variant})")


@pytest.mark.parametrize("bottom", ["flat", "nonflat"])
@pytest.mark.parametrize("variant", ["grad", "bare"])
def test_own_operator_tables_match_the_reference(variant, bottom):
    own, ref_ops, *_ = _case("float64", 1, bottom)
    ops, ref = own[variant], ref_ops[variant]
    assert ops.ptab.shape[0] == (6 if bottom == "flat" else 8)
    for name in ("K", "M2", "ptab", "pbp_df") + (("Gx", "Gy") if variant == "grad" else ()):
        assert_close(getattr(ops, name), getattr(ref, name), 1e-14, name)
    if variant == "bare":
        assert ops.Gx is None and ops.Gy is None and ref.Gx is None
        assert torch.equal(ops.minv, torch.ones_like(ops.minv))


def _own_ops(nop, variant):
    """The port's own operators at order `nop` on a small brick (CPU)."""
    from hnumo_tpu_torch.model import Model as TorchModel
    from test_torch_common import torch_config

    m = TorchModel(torch_config(nelx=2, nely=2, nopx=nop, nopy=nop), device="cpu")
    return tu.operators_uniform(m.g, m.P, True, fold_massinv=variant == "grad",
                                with_grad=variant == "grad")


@pytest.mark.parametrize("nop", [None, 2, 8])
@pytest.mark.parametrize("variant", ["grad", "bare"])
def test_one_d_tables_describe_the_same_operators(variant, nop):
    """What the CUDA kernel reads (psiq, dpsiq, dpsi, wq3, minv, kx_df, ey_df)
    rebuilds what the plain version reads (K, M2, Gx, Gy): at p=4 on the
    tables carried over from the JAX package, at p=2 and p=8 on the port's."""
    ops = _case("float64", 1, "flat")[0][variant] if nop is None else _own_ops(nop, variant)
    ngl, nq = ops.psiq.shape
    K = torch.einsum("jJ,iI->jiJI", ops.psiq, ops.psiq).reshape(ngl**2, nq**2)
    Dk = torch.einsum("jJ,iI->jiJI", ops.psiq, ops.dpsiq).reshape(K.shape)
    De = torch.einsum("jJ,iI->jiJI", ops.dpsiq, ops.psiq).reshape(K.shape)
    M2 = torch.cat([Dk.T * ops.wq3[0][:, None], De.T * ops.wq3[1][:, None],
                    K.T * ops.wq3[2][:, None]]) * ops.minv[None, :]
    assert_close(K, ops.K.numpy(), 1e-15, "K")
    assert_close(M2, ops.M2.numpy(), 1e-15, "M2")
    if variant == "grad":
        eye = torch.eye(ngl, dtype=K.dtype)
        Gx = ops.kx_df * torch.einsum("jJ,iI->jiJI", eye, ops.dpsi).reshape(ngl**2, -1)
        Gy = ops.ey_df * torch.einsum("jJ,iI->jiJI", ops.dpsi, eye).reshape(ngl**2, -1)
        assert_close(Gx, ops.Gx.numpy(), 1e-15, "Gx")
        assert_close(Gy, ops.Gy.numpy(), 1e-15, "Gy")


@pytest.mark.parametrize("bottom", ["flat", "nonflat"])
@pytest.mark.parametrize("botfr", [0, 1, 2])
def test_sum_factorised_stage_matches_plain(botfr, bottom):
    """The arithmetic of the CUDA kernel — two 1-D passes per interpolation,
    scatter and gradient, folded weights, inverse mass — written out in numpy
    from the 1-D tables alone, against btp_volume_uni_plain with its Kronecker
    matrices: 1e-12 of each output's max in f64."""
    from test_torch_common import sumfact_interp, sumfact_scatter

    own, _, operands, acc0, kw, _ = _case("float64", botfr, bottom)
    ops = own["grad"]
    out = _run(ops, operands, acc0, kw, "float64", True)
    psiq, dpsiq, dpsi = ops.psiq.numpy(), ops.dpsiq.numpy(), ops.dpsi.numpy()
    ngl = psiq.shape[0]
    qb, qpln = operands["qb"].numpy(), operands["qpln"].numpy()
    dp, dpp, udp, vdp = sumfact_interp(psiq, qb)
    ppq, up, vp = sumfact_interp(psiq, qpln)
    ptab = ops.ptab.numpy()
    cor, tau_u, tau_v, opbp, pref, Href = ptab[:6]
    ub, vb = udp / dp, vdp / dp
    g_ = kw["grav"]
    if botfr == 1:
        spd = (kw["cd"] / g_) * (pref + ppq)
        tb_u, tb_v = spd * (up + ub), spd * (vp + vb)
    elif botfr == 2:
        spd = (kw["cd"] / kw["alpha_bot"]) * np.hypot(up + ub, vp + vb)
        tb_u, tb_v = spd * (up + ub), spd * (vp + vb)
    else:
        tb_u = tb_v = np.zeros_like(dp)
    sc_x = cor * vdp + g_ * (tau_u - tb_u)
    sc_y = -cor * udp + g_ * (tau_v - tb_v)
    if bottom == "nonflat":
        sc_x, sc_y = sc_x - g_ * dpp * ptab[6], sc_y - g_ * dpp * ptab[7]
    Quu, Quv, Qvv, dHbcl = operands["coup"].numpy()
    mu = dpp * opbp
    mu2 = mu * (2.0 + mu)
    dHq = dHbcl + mu2 * (Href + dHbcl)
    qu, quv, qv = ub * udp + (1 + mu) * Quu, ub * vdp + (1 + mu) * Quv, vb * vdp + (1 + mu) * Qvv
    wkx, wey, w = ops.wq3.numpy()
    minv = ops.minv.numpy()

    def scatter(Fx, Fy, Fs):
        return minv * sumfact_scatter(psiq, dpsiq, wkx * Fx, wey * Fy,
                                      None if Fs is None else w * Fs)

    rhs = np.stack([scatter(udp, vdp, None), scatter(dHq + qu, quv, sc_x),
                    scatter(quv, dHq + qv, sc_y)])
    inc = np.stack([dHq, qu, qv, quv, mu, mu2, ub, vb, udp, vdp, tb_u, tb_v])
    t_df = qb[1] * ops.pbp_df.numpy()
    u, v = qb[2] / qb[0], qb[3] / qb[0]
    ninc = np.stack([t_df * (2.0 + t_df), u, v])

    def grad(f):    # (E, npts) -> d/dx along i, d/dy along j
        f = f.reshape(-1, ngl, ngl)
        return (ops.kx_df * np.einsum("ejk,ki->eji", f, dpsi).reshape(-1, ngl * ngl),
                ops.ey_df * np.einsum("eki,kj->eji", f, dpsi).reshape(-1, ngl * ngl))

    gv = np.stack([*grad(u), *grad(v)])
    want = (rhs, acc0["accv"] + inc, acc0["accn"] + ninc, gv, acc0["agr"] + gv)
    for name, got, wnt in zip(OUT, out, want):
        assert_close(got, wnt, 1e-12, name)


def test_converter_strips_the_element_padding():
    own, ref_ops, *_ = _case("float64", 1, "nonflat")
    ref = ref_ops["grad"]
    E = own["grad"].ptab.shape[1]
    padded = ref._replace(ptab=np.pad(ref.ptab, ((0, 0), (0, 2), (0, 0)), mode="edge"),
                          pbp_df=np.pad(ref.pbp_df, ((0, 2), (0, 0)), mode="edge"))
    ops = vol_ops_uni_from_padded(padded, own["grad"])
    assert ops.ptab.shape[1] == E and ops.pbp_df.shape[0] == E
    assert np.array_equal(ops.ptab.numpy(), ref.ptab)
    assert ops.psiq is own["grad"].psiq


@pytest.mark.parametrize("breakage", ["noncontiguous", "dtype", "shape", "botfr",
                                      "grad_without_operators", "cuda", "psiq_shape",
                                      "tables_of_another_order"])
def test_wrapper_contract_raises(breakage):
    """Operands the stage does not take raise; nothing is copied silently, and
    the CUDA wrapper never swaps in the plain version on CPU tensors."""
    own, _, operands, acc0, kw, _ = _case("float64", 1, "flat")
    ops = own["grad"]
    acc = {k: tt(v) for k, v in acc0.items()}
    args = [operands["qb"], operands["qpln"], acc["accv"], acc["accn"], operands["coup"],
            acc["agr"]]
    kw = dict(kw)
    fn, exc = tu.btp_volume_uni_plain, ValueError
    if breakage == "noncontiguous":
        args[2] = acc["accv"].transpose(1, 2).contiguous().transpose(1, 2)
    elif breakage == "dtype":
        args[1] = args[1].float()
    elif breakage == "shape":
        args[3] = acc["accn"][:, :, :-1].contiguous()
    elif breakage == "botfr":
        kw["botfr"] = 3
    elif breakage == "grad_without_operators":
        ops = own["bare"]
    elif breakage == "psiq_shape":
        ops = ops._replace(dpsiq=ops.dpsiq[:, :-1].contiguous())
    elif breakage == "tables_of_another_order":
        other = _own_ops(2, "grad")
        ops = ops._replace(psiq=other.psiq, dpsiq=other.dpsiq, dpsi=other.dpsi)
    else:
        fn = tu.btp_volume_uni_cuda
    before = tu.btp_volume_uni_cuda.launches
    with pytest.raises(exc, match="CUDA" if breakage == "cuda" else None):
        fn(ops, *args, **kw)
    assert tu.btp_volume_uni_cuda.launches == before
