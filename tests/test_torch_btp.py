"""barotropic_solve of the PyTorch package, on tables converted from the
JAX package, against the JAX barotropic_solve on the path the port mirrors
(one Pallas volume kernel per stage in interpret mode, flat-axis faces, no
megakernel): the final qb and all 23 running averages — the 12 volume, 3
nodal, graduvb, and per direction the 16 face and 2 gradient-trace ones —
f64, to 1e-11 of each field's max (N_btp*kstages = 60 or 100 stages of
identical operations; only summation orders differ)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hnumo_tpu.core.bcl import extract_qprime_faces as j_faces
from hnumo_tpu.core.btp import barotropic_solve as j_solve
from hnumo_tpu.core.coupling import btp_bcl_coeffs as j_coeffs
from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu.ops.dg import interp_n2q as j_n2q
from hnumo_tpu_torch.convert import from_numpy_tables
from hnumo_tpu_torch.core.bcl import extract_qprime_faces as t_faces
from hnumo_tpu_torch.core.btp import barotropic_solve as t_solve
from hnumo_tpu_torch.core.coupling import btp_bcl_coeffs as t_coeffs
from hnumo_tpu_torch.model import Model as TorchModel
from test_torch_common import (assert_close, jax_config, leaves, perturb, to_np,
                               torch_config, tt)
import torch

REL = 1e-11
CASES = [(100.0, 5), (100.0, 3), (0.0, 5), (0.0, 3)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"visc{c[0]:g}-k{c[1]}")
def solved(request):
    visc, kstages = request.param
    over = dict(visc_mlswe=visc, kstages=kstages)
    jm = JaxModel(jax_config(**over))
    assert jm.static.use_pallas and jm.static.pallas_interpret
    assert jm.static.batched_faces and not jm.static.mega
    state_np = to_np(jm.state0)
    _, qb_np, qp_np = perturb(state_np, 5, "float64")

    static, P, g, bc = jm.static, jm.P, jm.g, jm.bc

    @jax.jit
    def run(qb, qp):
        coup = j_coeffs(static, P, g, bc, qp, j_faces(bc, qp), qp[0],
                        jnp.zeros_like(j_n2q(g, qp[0])))
        return coup, j_solve(static, P, g, bc, coup, qb, qp, vol_ops=jm._vol_ops)

    coup_j, (qb_j, avg_j) = run(jnp.asarray(qb_np), jnp.asarray(qp_np))

    tm = TorchModel.from_tables(
        torch_config(**over),
        *from_numpy_tables(to_np(P), to_np(g), state_np, "cpu", torch.float64),
        device="cpu")
    qb, qp = tt(qb_np), tt(qp_np)
    qb_keep = qb.clone()
    zq = torch.zeros(qp.shape[1:-2] + tm.g.wjac.shape[-2:], dtype=qp.dtype)
    coup_t = t_coeffs(tm.static, tm.P, tm.g, tm.bc, qp, t_faces(tm.bc, qp), qp[0], zq)
    qb_t, avg_t = t_solve(tm.static, tm.P, tm.g, tm.bc, coup_t, qb, qp, vol_ops=tm.vol_ops)
    assert torch.equal(qb, qb_keep), "barotropic_solve must not mutate its input"
    return to_np(coup_j), coup_t, np.asarray(qb_j), qb_t, to_np(avg_j), avg_t


def test_coupling_fields(solved):
    coup_j, coup_t = solved[0], solved[1]
    names = [n for n, _ in leaves(coup_t)]
    assert names == [n for n, _ in leaves(coup_j)]
    for (name, w), (_, got) in zip(leaves(coup_j), leaves(coup_t)):
        assert_close(got, w, 1e-13, name)


def test_final_qb(solved):
    assert_close(solved[3], solved[2], REL, "qb")


def test_all_running_averages(solved):
    avg_j, avg_t = solved[4], solved[5]
    want, got = dict(leaves(avg_j)), dict(leaves(avg_t))
    assert list(want) == list(got)
    # 15 volume/nodal + graduvb + 2 directions x (16 face + gvL + gvR)
    assert len(want) == 16 + 2 * 18
    for name, w in want.items():
        assert_close(got[name], w, REL, name)


def test_vol_ops_default_matches_prebuilt(solved):
    """vol_ops=None rebuilds the operator tables inside the solve."""
    tm = TorchModel(torch_config(dt=40.0, dt_btp=20.0), device="cpu")
    s = tm.state0
    qp = s.qprime_df
    zq = torch.zeros(qp.shape[1:-2] + tm.g.wjac.shape[-2:], dtype=qp.dtype)
    coup = t_coeffs(tm.static, tm.P, tm.g, tm.bc, qp, t_faces(tm.bc, qp), qp[0], zq)
    a, _ = t_solve(tm.static, tm.P, tm.g, tm.bc, coup, s.qb_df, qp, vol_ops=tm.vol_ops)
    b, _ = t_solve(tm.static, tm.P, tm.g, tm.bc, coup, s.qb_df, qp)
    assert torch.equal(a, b)
