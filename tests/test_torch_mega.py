"""The whole-solve megakernel path of the PyTorch package (ops/mega) against
the JAX package's megakernel.

The same seeded numpy inputs (the pattern of tests/test_mega.py) go through
the JAX `barotropic_solve_mega(..., interpret=True)` and through
`barotropic_solve_mega_plain` on tables converted from the JAX model, f64,
over the parity matrix of tests/test_mega.py: viscosity on/off, botfr 0/1/2,
kstages 3/5, nop 4/6, on a 6x5 grid (nex != ney on purpose), plus one case
with other boundary codes: copy (0) west and north, no-slip (2) south. At a
free-slip or no-slip wall every boundary flux either vanishes by symmetry or
is masked by the wall projection, so only a copy boundary shows the sign with
which a boundary face lands on its element, and only these codes the other
rows of the mirror-sign tables. The final qb is
held to rtol/atol 1e-11 and each of the running averages to 1e-11 of its own
max: 60 or 100 stages of the same operations in another summation order
(sum-factorised 1-D operators here, Kronecker matrices there). The plain
version is also held against the port's own per-stage solve (mega="off") on
the same inputs, and the static operand tables against the JAX ones with
their lane padding stripped."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnumo_tpu.core.bcl import extract_qprime_faces as j_faces
from hnumo_tpu.core.coupling import btp_bcl_coeffs as j_coeffs
from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu.ops.dg import interp_n2q as j_n2q
from hnumo_tpu.ops.pallas_mega import barotropic_solve_mega as j_solve_mega
from hnumo_tpu.ops.pallas_mega import build_mega_static as j_build_mega
from hnumo_tpu_torch.convert import from_numpy_tables, mega_tables_from_padded
from hnumo_tpu_torch.core.bcl import extract_qprime_faces as t_faces
from hnumo_tpu_torch.core.btp import barotropic_solve as t_solve
from hnumo_tpu_torch.core.coupling import btp_bcl_coeffs as t_coeffs
from hnumo_tpu_torch.model import Model as TorchModel
from hnumo_tpu_torch.ops.mega import barotropic_solve_mega_plain
from test_torch_common import (assert_close, jax_config, leaves, perturb, to_np,
                               torch_config, tt)

REL = 1e-11
# (viscosity, botfr, kstages, nop, walls): the cases of tests/test_mega.py,
# all free-slip (code 4), and one with copy (0) and no-slip (2) boundaries
FREE = ((4, 4), (4, 4))
CASES = [(False, 1, 5, 4, FREE), (True, 1, 5, 4, FREE), (True, 2, 5, 4, FREE),
         (False, 0, 3, 4, FREE), (True, 1, 5, 6, FREE),
         (True, 1, 5, 4, ((0, 4), (2, 0)))]


def _over(visc, botfr, kstages, nop, walls):
    kw = dict(method_visc=2, visc_mlswe=100.0) if visc else dict(
        method_visc=0, visc_mlswe=0.0)
    return dict(botfr=botfr, kstages=kstages, nopx=nop, nopy=nop, mega="on",
                x_boundary=walls[0], y_boundary=walls[1], **kw)


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"visc{int(c[0])}-botfr{c[1]}-k{c[2]}-nop{c[3]}"
                              + ("" if c[4] == FREE else "-walls0420"))
def solved(request):
    over = _over(*request.param)
    jm = JaxModel(jax_config(**over))
    assert jm.static.mega, "the JAX mega gate should be on for this config"
    state_np = to_np(jm.state0)
    _, qb_np, qp_np = perturb(state_np, 0, "float64")
    static, P, g, bc = jm.static, jm.P, jm.g, jm.bc
    jmops = j_build_mega(static, g, P, bc)

    @jax.jit
    def run(qb, qp):
        coup = j_coeffs(static, P, g, bc, qp, j_faces(bc, qp), qp[0],
                        jnp.zeros_like(j_n2q(g, qp[0])))
        return j_solve_mega(static, P, g, bc, coup, qb, qp, jmops, interpret=True)

    qb_j, avg_j = run(jnp.asarray(qb_np), jnp.asarray(qp_np))

    tm = TorchModel.from_tables(
        torch_config(**over),
        *from_numpy_tables(to_np(P), to_np(g), state_np, "cpu", torch.float64),
        device="cpu")
    assert tm.static.mega and tm.static.mega_impl == "plain"
    assert tm.mega_ops is not None
    qb, qp = tt(qb_np), tt(qp_np)
    qb_keep = qb.clone()
    zq = torch.zeros(qp.shape[1:-2] + tm.g.wjac.shape[-2:], dtype=qp.dtype)
    coup_t = t_coeffs(tm.static, tm.P, tm.g, tm.bc, qp, t_faces(tm.bc, qp), qp[0], zq)
    args = (tm.P, tm.g, tm.bc, coup_t, qb, qp)
    # through the dispatch of core/btp.barotropic_solve
    qb_t, avg_t = t_solve(tm.static, *args, vol_ops=tm.vol_ops, mega_ops=tm.mega_ops)
    unchanged = torch.equal(qb, qb_keep)
    # the port's own per-stage path on the same inputs
    st_off = dataclasses.replace(tm.static, mega_on=False)
    qb_s, avg_s = t_solve(st_off, *args, vol_ops=tm.vol_ops)
    return dict(tm=tm, args=args, jmops=to_np(jmops), unchanged=unchanged,
                qb_j=np.asarray(qb_j), avg_j=to_np(avg_j), qb_t=qb_t, avg_t=avg_t,
                qb_s=qb_s, avg_s=avg_s)


def test_final_qb_matches_jax_megakernel(solved):
    np.testing.assert_allclose(solved["qb_t"].numpy(), solved["qb_j"],
                               rtol=REL, atol=REL, err_msg="qb")


def test_all_running_averages_match_jax_megakernel(solved):
    want, got = dict(leaves(solved["avg_j"])), dict(leaves(solved["avg_t"]))
    assert list(want) == list(got)
    # 15 volume/nodal + graduvb + 2 directions x (16 face + gvL + gvR)
    assert len(want) == 16 + 2 * 18
    for name, w in want.items():
        assert_close(got[name], w, REL, name)


def test_caller_state_is_not_mutated(solved):
    assert solved["unchanged"], "the mega solve must not mutate its qb_df"


def test_dispatch_takes_the_mega_path(solved):
    """barotropic_solve with mega_ops gives what the plain mega solve gives,
    and without mega_ops it takes the per-stage path even when static.mega."""
    tm, args = solved["tm"], solved["args"]
    qb_m, avg_m = barotropic_solve_mega_plain(tm.static, *args, tm.mega_ops)
    assert torch.equal(qb_m, solved["qb_t"])
    for (name, a), (_, b) in zip(leaves(avg_m), leaves(solved["avg_t"])):
        assert torch.equal(a, b), name
    qb_n, _ = t_solve(tm.static, *args, vol_ops=tm.vol_ops)
    assert torch.equal(qb_n, solved["qb_s"])


def test_mega_plain_matches_per_stage_path(solved):
    """Two routes of the port to the same numbers: element-major with all
    four sides per element, against the flat-axis face path."""
    np.testing.assert_allclose(solved["qb_t"].numpy(), solved["qb_s"].numpy(),
                               rtol=REL, atol=REL, err_msg="qb")
    for (name, got), (_, want) in zip(leaves(solved["avg_t"]), leaves(solved["avg_s"])):
        assert_close(got, want.numpy(), REL, name)


def test_static_tables_match_jax_with_padding_stripped(solved):
    tm = solved["tm"]
    mops = tm.mega_ops
    ngl, nq = mops.psiq.shape
    E = mops.ney * mops.nex
    shared = mega_tables_from_padded(solved["jmops"], E, ngl, nq)
    for name in ("ptab", "btp_ref3", "massinv", "pbprime_df", "opbp_df", "masku",
                 "maskv", "ftab", "ntab"):
        assert_close(getattr(mops, name), shared[name], 1e-14, name)
    np.testing.assert_allclose(np.asarray(mops.a_tab), shared["a_tab"], rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(mops.b_tab), shared["b_tab"], rtol=0, atol=0)
    # walls and mirror signs: the JAX tables hold them per padded lane
    wall = (mops.nbr < 0).numpy()
    assert np.array_equal(wall, shared["wall"])
    mir = np.where(wall[None], mops.mir_q.T.numpy()[:, None, :], 1.0)
    np.testing.assert_array_equal(mir, shared["mir_q"])
    # neighbours by index: east/west differ by 1, north/south by nex
    nbr = mops.nbr.numpy().astype(np.int64)
    e = np.arange(E)
    for side, step in enumerate((1, -1, mops.nex, -mops.nex)):
        inside = ~wall[:, side]
        assert np.array_equal(nbr[inside, side], e[inside] + step)
