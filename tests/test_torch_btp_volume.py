"""The plain version of the fused barotropic volume stage
(hnumo_tpu_torch/ops/btp_volume.btp_volume_plain) against the JAX package's
Pallas kernel in interpret mode AND against its structured reference
(btp_volume_rhs + the nodal increments): botfr 0/1/2 x f32/f64, random
non-zero initial accumulators. Tolerances of tests/test_pallas.py: 1e-12 of
the field's max in f64, 2e-5 in f32 (same operations; the ~100-term sums are
taken in another order). The CUDA kernel itself is held against this plain
version on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnumo_tpu.core.bcl import extract_qprime_faces
from hnumo_tpu.core.btp import _NOD_ORDER, _VOL_ORDER, btp_volume_rhs
from hnumo_tpu.core.coupling import btp_bcl_coeffs
from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu.ops import pallas_btp as jp
from hnumo_tpu.ops.dg import interp_n2q
from hnumo_tpu_torch.convert import from_numpy_tables
from hnumo_tpu_torch.core import btp as tbtp
from hnumo_tpu_torch.ops import btp_volume as tv
from test_torch_common import TDTYPE, jax_config, perturb, to_np, tt


def _case(dtype, botfr):
    m = JaxModel(jax_config(dtype=dtype, botfr=botfr))
    static, P, g, bc = m.static, m.P, m.g, m.bc
    rng, qb_np, qp_np = perturb(to_np(m.state0), 0, dtype)
    qb, qp = jnp.asarray(qb_np), jnp.asarray(qp_np)
    coup = btp_bcl_coeffs(static, P, g, bc, qp, extract_qprime_faces(bc, qp), qp[0],
                          jnp.zeros_like(interp_n2q(g, qp[0])))
    qpl_q = interp_n2q(g, qp[:, -1])
    ney, nex = g.wjac.shape[:2]
    nq, ngl = g.wjac.shape[-1], g.wjac_df.shape[-1]
    E = ney * nex
    accv0 = rng.normal(size=(12, E, nq * nq)).astype(dtype)
    accn0 = rng.normal(size=(3, E, ngl * ngl)).astype(dtype)
    coup_flat = jnp.stack([jp.eflat(c) for c in
                           (coup.Q_uu_dp, coup.Q_uv_dp, coup.Q_vv_dp, coup.dH_bcl)])
    kw = dict(grav=static.gravity, botfr=static.botfr, cd=static.cd_mlswe,
              alpha_bot=static.alpha_bot)

    # the two JAX references
    pallas = jp.btp_volume_pallas(jp.operators_from_tables(g, P), jp.eflat(qb),
                                  jp.eflat(qpl_q), coup_flat, jnp.asarray(accv0),
                                  jnp.asarray(accn0), interpret=True, **kw)
    rhs_ref, vinc = btp_volume_rhs(static, P, g, coup, qb, qpl_q)
    t_df = qb[1] * P.one_over_pbprime_df
    ninc = jnp.stack([t_df * (2.0 + t_df), qb[2] / qb[0], qb[3] / qb[0]])
    xla = (np.asarray(rhs_ref).reshape(3, E, -1),
           np.asarray(vinc).reshape(12, E, -1) + accv0,
           np.asarray(ninc).reshape(3, E, -1) + accn0)

    # the port: its own operator tables on the converted tables, same operands
    Pt, gt, _ = from_numpy_tables(to_np(P), to_np(g), to_np(m.state0), "cpu", TDTYPE[dtype])
    ops = tv.operators_from_tables(gt, Pt)
    operands = (tv.eflat(tt(qb_np, dtype)), tt(np.asarray(jp.eflat(qpl_q)), dtype),
                tt(np.asarray(coup_flat), dtype))
    return ops, operands, accv0, accn0, kw, [np.asarray(a) for a in pallas], xla


@pytest.mark.parametrize("botfr", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_matches_pallas_and_xla(dtype, botfr):
    ops, operands, accv0, accn0, kw, pallas, xla = _case(dtype, botfr)
    accv, accn = tt(accv0, dtype), tt(accn0, dtype)
    rhs, accv_out, accn_out = tv.btp_volume_plain(ops, *operands, accv, accn, **kw)
    # the in-place contract: the same two tensors come back, updated
    assert accv_out is accv and accn_out is accn
    assert not np.array_equal(accv.numpy(), accv0)
    if dtype == "float64":   # in f32 the nodal increments (~1e-11) vanish beside O(1) values
        assert not np.array_equal(accn.numpy(), accn0)
    assert rhs.shape == (3, accv0.shape[1], accn0.shape[2]) and rhs.dtype == TDTYPE[dtype]

    tol = 1e-12 if dtype == "float64" else 2e-5
    for ref_name, (rhs_w, accv_w, accn_w) in (("pallas", pallas), ("xla", xla)):
        np.testing.assert_allclose(rhs.numpy(), rhs_w, rtol=0, atol=tol * np.abs(rhs_w).max(),
                                   err_msg=f"rhs vs {ref_name}")
        np.testing.assert_allclose(accv.numpy(), accv_w, atol=tol * np.abs(accv_w).max(),
                                   rtol=tol * 10, err_msg=f"accv vs {ref_name}")
        np.testing.assert_allclose(accn.numpy(), accn_w, atol=tol * np.abs(accn_w).max(),
                                   rtol=tol * 10, err_msg=f"accn vs {ref_name}")


def test_accumulator_orders_are_the_jax_package_s():
    assert tbtp._VOL_ORDER == _VOL_ORDER and tbtp._NOD_ORDER == _NOD_ORDER


def test_structured_reference_matches_plain():
    """btp_volume_rhs (structured layout) == btp_volume_plain (flat layout)."""
    from hnumo_tpu_torch.core.bcl import extract_qprime_faces as t_faces
    from hnumo_tpu_torch.core.coupling import btp_bcl_coeffs as t_coeffs
    from hnumo_tpu_torch.model import Model as TorchModel
    from hnumo_tpu_torch.ops.dg import interp_n2q as t_n2q
    from test_torch_common import torch_config

    m = TorchModel(torch_config(botfr=2), device="cpu")
    _, qb_np, qp_np = perturb(to_np_state(m.state0), 3, "float64")
    qb, qp = tt(qb_np), tt(qp_np)
    zq = torch.zeros(qp.shape[1:-2] + m.g.wjac.shape[-2:], dtype=qp.dtype)
    coup = t_coeffs(m.static, m.P, m.g, m.bc, qp, t_faces(m.bc, qp), qp[0], zq)
    qpl_q = t_n2q(m.g, qp[:, -1])
    rhs_s, vinc = tbtp.btp_volume_rhs(m.static, m.P, m.g, coup, qb, qpl_q)
    E = qb.shape[1] * qb.shape[2]
    accv = torch.zeros((12, E, 81), dtype=qb.dtype)
    accn = torch.zeros((3, E, 25), dtype=qb.dtype)
    coup_flat = torch.stack([tv.eflat(c.contiguous()) for c in
                             (coup.Q_uu_dp, coup.Q_uv_dp, coup.Q_vv_dp, coup.dH_bcl)])
    rhs_f, _, _ = tv.btp_volume_plain(
        m.vol_ops, tv.eflat(qb), tv.eflat(qpl_q.contiguous()), coup_flat, accv, accn,
        grav=m.static.gravity, botfr=2, cd=m.static.cd_mlswe, alpha_bot=m.static.alpha_bot)
    np.testing.assert_allclose(rhs_f.numpy(), rhs_s.reshape(3, E, 25).numpy(), rtol=0,
                               atol=1e-12 * float(rhs_s.abs().max()))
    np.testing.assert_allclose(accv.numpy(), vinc.reshape(12, E, 81).numpy(), rtol=1e-11,
                               atol=1e-12 * float(vinc.abs().max()))


def to_np_state(state):
    return type(state)(*[t.numpy() for t in state])


@pytest.mark.parametrize("breakage", ["noncontiguous", "dtype", "shape", "botfr"])
def test_wrapper_contract_raises(breakage):
    """Operands the stage does not take raise; nothing is copied silently."""
    from hnumo_tpu_torch.model import Model as TorchModel
    from test_torch_common import torch_config

    m = TorchModel(torch_config(nelx=2, nely=2), device="cpu")
    E, npts, nqq = 4, 25, 81
    z = lambda c, n, dt=torch.float64: torch.ones((c, E, n), dtype=dt)
    args = [tv.eflat(m.state0.qb_df), z(3, nqq), z(4, nqq), z(12, nqq), z(3, npts)]
    kw = dict(grav=9.8, botfr=1, cd=0.0, alpha_bot=1e-3)
    if breakage == "noncontiguous":
        args[3] = torch.ones((12, nqq, E), dtype=torch.float64).transpose(1, 2)
    elif breakage == "dtype":
        args[1] = z(3, nqq, torch.float32)
    elif breakage == "shape":
        args[4] = z(3, npts + 1)
    else:
        kw["botfr"] = 3
    with pytest.raises(ValueError):
        tv.btp_volume_plain(m.vol_ops, *args, **kw)
    with pytest.raises(RuntimeError):
        tv.eflat(torch.ones((2, 2, 5, 7, 5)).transpose(-1, -2)[..., :5, :5])


# ---- the 1-D tables the CUDA kernel reads, and its sum-factorised arithmetic ----


def _torch_case(nop, botfr, seed=5, nelx=3, nely=2):
    """A small model of the port on the CPU and seeded flat operands."""
    from hnumo_tpu_torch.core.bcl import extract_qprime_faces as t_faces
    from hnumo_tpu_torch.core.coupling import btp_bcl_coeffs as t_coeffs
    from hnumo_tpu_torch.model import Model as TorchModel
    from hnumo_tpu_torch.ops.dg import interp_n2q as t_n2q
    from test_torch_common import torch_config

    m = TorchModel(torch_config(nelx=nelx, nely=nely, nopx=nop, nopy=nop, botfr=botfr),
                   device="cpu")
    rng, qb_np, qp_np = perturb(to_np_state(m.state0), seed, "float64")
    qb, qp = tt(qb_np), tt(qp_np)
    zq = torch.zeros(qp.shape[1:-2] + m.g.wjac.shape[-2:], dtype=qp.dtype)
    coup = t_coeffs(m.static, m.P, m.g, m.bc, qp, t_faces(m.bc, qp), qp[0], zq)
    coup_flat = torch.stack([tv.eflat(c.contiguous()) for c in
                             (coup.Q_uu_dp, coup.Q_uv_dp, coup.Q_vv_dp, coup.dH_bcl)])
    qplq = tv.eflat(t_n2q(m.g, qp[:, -1]).contiguous())
    kw = dict(grav=m.static.gravity, botfr=botfr, cd=m.static.cd_mlswe,
              alpha_bot=m.static.alpha_bot)
    return m, rng, tv.eflat(qb), qplq, coup_flat, kw


@pytest.mark.parametrize("nop", [2, 4, 8])
def test_one_d_tables_reproduce_the_kronecker_matrices(nop):
    """psiq and dpsiq (what the kernel reads) rebuild K, DkT, DeT (what the
    plain version reads) as Kronecker products, at every order."""
    m = _torch_case(nop, 1)[0]
    ops = m.vol_ops
    psiq, dpsiq = ops.psiq.numpy(), ops.dpsiq.numpy()
    assert psiq.shape == dpsiq.shape == (nop + 1, m.g.wjac.shape[-1])
    assert ops.psiq.is_contiguous() and ops.dpsiq.is_contiguous()
    np.testing.assert_allclose(ops.K.numpy(), np.kron(psiq, psiq), rtol=0, atol=1e-15)
    np.testing.assert_allclose(ops.DkT.numpy(), np.kron(psiq, dpsiq).T, rtol=0, atol=1e-13)
    np.testing.assert_allclose(ops.DeT.numpy(), np.kron(dpsiq, psiq).T, rtol=0, atol=1e-13)


@pytest.mark.parametrize("botfr", [0, 1, 2])
@pytest.mark.parametrize("nop", [2, 4, 8])
def test_sum_factorised_stage_matches_plain_on_a_curvilinear_metric(nop, botfr):
    """The arithmetic of the CUDA kernel — interpolation and scatter as two
    1-D passes each, the metric applied pointwise in between — written out in
    numpy, against btp_volume_plain with its Kronecker matrices, on a metric
    that differs at every element and quad point (all four derivatives
    non-zero): 1e-12 of each output's max in f64."""
    from test_torch_common import sumfact_interp, sumfact_scatter

    m, rng, qbf, qplq, coupf, kw = _torch_case(nop, botfr)
    met = m.vol_ops.met.numpy()
    size = np.abs(met[:4]).max()
    new = met.copy()
    new[:4] = (met[:4] * (1.0 + 0.2 * rng.uniform(-1, 1, met[:4].shape))
               + 0.3 * size * rng.uniform(-1, 1, met[:4].shape))
    new[4] = met[4] * (1.0 + 0.2 * rng.uniform(-1, 1, met[4].shape))
    ops = m.vol_ops._replace(met=tt(new))
    E, npts = qbf.shape[1], qbf.shape[2]
    nqq = coupf.shape[2]
    accv0, accn0 = rng.normal(size=(12, E, nqq)), rng.normal(size=(3, E, npts))
    accv, accn = tt(accv0), tt(accn0)
    rhs, _, _ = tv.btp_volume_plain(ops, qbf, qplq, coupf, accv, accn, **kw)

    psiq, dpsiq = ops.psiq.numpy(), ops.dpsiq.numpy()
    dp, dpp, udp, vdp = sumfact_interp(psiq, qbf.numpy())
    ppq, up, vp = qplq.numpy()
    cor, tau_u, tau_v, gzx, gzy, opbp, pref, Href = ops.ptab.numpy()
    pp = pref + ppq
    ub, vb = udp / dp, vdp / dp
    g_ = kw["grav"]
    if botfr == 1:
        spd = (kw["cd"] / g_) * pp
        tb_u, tb_v = spd * (up + ub), spd * (vp + vb)
    elif botfr == 2:
        spd = (kw["cd"] / kw["alpha_bot"]) * np.hypot(up + ub, vp + vb)
        tb_u, tb_v = spd * (up + ub), spd * (vp + vb)
    else:
        tb_u = tb_v = np.zeros_like(dp)
    sc_x = cor * vdp + g_ * (tau_u - tb_u) - g_ * dpp * gzx
    sc_y = -cor * udp + g_ * (tau_v - tb_v) - g_ * dpp * gzy
    Quu, Quv, Qvv, dHbcl = coupf.numpy()
    mu = dpp * opbp
    mu2 = mu * (2.0 + mu)
    dHq = dHbcl + mu2 * (Href + dHbcl)
    qu, quv, qv = ub * udp + (1 + mu) * Quu, ub * vdp + (1 + mu) * Quv, vb * vdp + (1 + mu) * Qvv
    kx, ky, ex, ey, wj = new

    def scatter(Fx, Fy, Fs):
        return sumfact_scatter(psiq, dpsiq, wj * (Fx * kx + Fy * ky), wj * (Fx * ex + Fy * ey),
                               None if Fs is None else wj * Fs)

    want = np.stack([scatter(udp, vdp, None), scatter(dHq + qu, quv, sc_x),
                     scatter(quv, dHq + qv, sc_y)])
    np.testing.assert_allclose(rhs.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    inc = np.stack([dHq, qu, qv, quv, mu, mu2, ub, vb, udp, vdp, tb_u, tb_v])
    np.testing.assert_allclose(accv.numpy(), accv0 + inc, rtol=0,
                               atol=1e-12 * np.abs(accv0 + inc).max())
    t_df = qbf[1].numpy() * ops.pbp_df.numpy()
    ninc = np.stack([t_df * (2.0 + t_df), qbf[2].numpy() / qbf[0].numpy(),
                     qbf[3].numpy() / qbf[0].numpy()])
    np.testing.assert_allclose(accn.numpy(), accn0 + ninc, rtol=0,
                               atol=1e-12 * np.abs(accn0 + ninc).max())


def test_converted_tables_yield_the_reference_operators():
    """The port's operators built on tables carried over from the JAX package
    equal that package's own, field by field; the 1-D tables are its psiq and
    dpsiq."""
    m = JaxModel(jax_config(dtype="float64", botfr=1))
    ref = jp.operators_from_tables(m.g, m.P)
    Pt, gt, _ = from_numpy_tables(to_np(m.P), to_np(m.g), to_np(m.state0), "cpu",
                                  torch.float64)
    ops = tv.operators_from_tables(gt, Pt)
    for name in ("K", "DkT", "DeT", "met", "ptab", "pbp_df"):
        got, want = getattr(ops, name).numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-14 * np.abs(want).max(),
                                   err_msg=name)
    assert np.array_equal(ops.psiq.numpy(), np.asarray(m.g.psiq))
    assert np.array_equal(ops.dpsiq.numpy(), np.asarray(m.g.dpsiq))
    assert ops._fields == ("K", "DkT", "DeT", "met", "ptab", "pbp_df", "psiq", "dpsiq")


@pytest.mark.parametrize("breakage", ["psiq_shape", "dpsiq_shape", "dpsiq_dtype",
                                      "tables_of_another_order", "psiq_noncontiguous",
                                      "psiq_not_2d"])
@pytest.mark.parametrize("which", ["plain", "cuda"])
def test_wrapper_checks_the_one_d_tables(which, breakage):
    """Both implementations refuse 1-D tables that do not fit the operands,
    and the CUDA wrapper refuses them before it would build or launch."""
    m, rng, qbf, qplq, coupf, kw = _torch_case(4, 1, nelx=2, nely=2)
    ops = m.vol_ops
    other = _torch_case(2, 1, nelx=2, nely=2)[0].vol_ops
    if breakage == "psiq_shape":
        ops = ops._replace(psiq=ops.psiq[:, :-1].contiguous())
    elif breakage == "dpsiq_shape":
        ops = ops._replace(dpsiq=ops.dpsiq[:-1].contiguous())
    elif breakage == "dpsiq_dtype":
        ops = ops._replace(dpsiq=ops.dpsiq.float())
    elif breakage == "tables_of_another_order":
        ops = ops._replace(psiq=other.psiq, dpsiq=other.dpsiq)
    elif breakage == "psiq_noncontiguous":
        ops = ops._replace(psiq=ops.psiq.T.contiguous().T)
    else:
        ops = ops._replace(psiq=ops.psiq.reshape(-1))
    E = qbf.shape[1]
    accv = torch.zeros((12, E, 81), dtype=qbf.dtype)
    accn = torch.zeros((3, E, 25), dtype=qbf.dtype)
    fn = tv.btp_volume_plain if which == "plain" else tv.btp_volume_cuda
    before = tv.btp_volume_cuda.launches
    with pytest.raises(ValueError, match="psiq|1-D tables"):
        fn(ops, qbf, qplq, coupf, accv, accn, **kw)
    assert tv.btp_volume_cuda.launches == before
    assert not accv.any() and not accn.any()


def test_cuda_wrapper_refuses_cpu_tensors():
    """On CPU tensors the CUDA wrapper raises; it never swaps in the plain version."""
    m, rng, qbf, qplq, coupf, kw = _torch_case(4, 1, nelx=2, nely=2)
    accv = torch.zeros((12, 4, 81), dtype=qbf.dtype)
    accn = torch.zeros((3, 4, 25), dtype=qbf.dtype)
    before = tv.btp_volume_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tv.btp_volume_cuda(m.vol_ops, qbf, qplq, coupf, accv, accn, **kw)
    assert tv.btp_volume_cuda.launches == before and not accv.any()
