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
