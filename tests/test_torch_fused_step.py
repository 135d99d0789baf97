"""The fused barotropic path of the PyTorch package (Config.fused_tail="on":
core/btp._barotropic_solve_fused, three stages per barotropic stage around a
plain-PyTorch exchange) and its per-stage path with the uniform-geometry
volume stage (Config.uni_volume="on") against the JAX package on the same
options, its Pallas kernels in interpret mode.

Both packages ask `mega` first and every grid here is under 1024 elements,
where mega="auto" would hand the solve to the megakernel and `fused_tail`
would be a flag that runs nothing: every configuration says mega="off"
(test_torch_common does), and each test proves the path by the call counters
of the plain versions, not by a flag.

One barotropic solve on tables converted from the JAX package: the final qb
and all 52 running-average fields to 1e-11 of each field's max (f64; 100
stages of the same operations in another summation order), viscous with
free-slip walls, viscous with copy (0) and no-slip (2) walls (the only walls
that show the sign a boundary face lands with) and inviscid. Two full
baroclinic steps to 1e-11 of each state field's max."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from hnumo_tpu_torch.ops import btp_tail, btp_volume, btp_volume_uni
from test_torch_common import (assert_close, jax_config, leaves, perturb, to_np,
                               torch_config, tt)

REL = 1e-11
FREE = ((4, 4), (4, 4))
WALLS0420 = ((0, 4), (2, 0))
SOLVE_CASES = [(True, FREE), (True, WALLS0420), (False, WALLS0420)]


def _over(visc, walls, **more):
    kw = (dict(method_visc=2, visc_mlswe=100.0) if visc
          else dict(method_visc=0, visc_mlswe=0.0))
    return dict(x_boundary=walls[0], y_boundary=walls[1], **kw, **more)


def _counters():
    return {"A": btp_volume_uni.btp_volume_uni_plain.calls,
            "F": btp_tail.btp_faces_plain.calls,
            "U": btp_tail.btp_update_plain.calls}


def _case_id(c):
    return ("visc" if c[0] else "inviscid") + ("" if c[1] == FREE else "-walls0420")


@pytest.fixture(scope="module", params=SOLVE_CASES, ids=_case_id)
def solved(request):
    visc, walls = request.param
    over = _over(visc, walls, fused_tail="on")
    jm = JaxModel(jax_config(**over))
    # the reference really takes its fused path, not the megakernel
    assert jm.static.fused_tail and not jm.static.mega and jm.static.pallas_interpret
    state_np = to_np(jm.state0)
    _, qb_np, qp_np = perturb(state_np, 6, "float64")
    static, P, g, bc = jm.static, jm.P, jm.g, jm.bc

    @jax.jit
    def run(qb, qp):
        coup = j_coeffs(static, P, g, bc, qp, j_faces(bc, qp), qp[0],
                        jnp.zeros_like(j_n2q(g, qp[0])))
        return j_solve(static, P, g, bc, coup, qb, qp)

    qb_j, avg_j = run(jnp.asarray(qb_np), jnp.asarray(qp_np))

    tm = TorchModel.from_tables(
        torch_config(**over),
        *from_numpy_tables(to_np(P), to_np(g), state_np, "cpu", torch.float64),
        device="cpu")
    assert tm.static.fused_tail and not tm.static.mega and tm.tail_ops is not None
    assert tm.static.tail_impl == tm.static.volume_impl == "plain"
    qb, qp = tt(qb_np), tt(qp_np)
    qb_keep = qb.clone()
    zq = torch.zeros(qp.shape[1:-2] + tm.g.wjac.shape[-2:], dtype=qp.dtype)
    coup_t = t_coeffs(tm.static, tm.P, tm.g, tm.bc, qp, t_faces(tm.bc, qp), qp[0], zq)
    args = (tm.P, tm.g, tm.bc, coup_t, qb, qp)
    before = _counters()
    qb_t, avg_t = t_solve(tm.static, *args, vol_ops=tm.vol_ops, tail_ops=tm.tail_ops)
    ran = {k: v - before[k] for k, v in _counters().items()}
    return dict(tm=tm, args=args, ran=ran, unchanged=torch.equal(qb, qb_keep),
                qb_j=np.asarray(qb_j), avg_j=to_np(avg_j), qb_t=qb_t, avg_t=avg_t,
                visc=visc)


def test_fused_solve_ran_its_three_stages(solved):
    nsub = solved["tm"].static.n_btp * solved["tm"].static.kstages
    assert nsub == 100
    assert solved["ran"] == {"A": nsub, "F": nsub, "U": nsub}
    assert solved["unchanged"], "the fused solve must not mutate its qb_df"


def test_fused_solve_final_qb(solved):
    for c, name in enumerate(("pb", "pbpert", "pbub", "pbvb")):
        assert_close(solved["qb_t"][c], solved["qb_j"][c], REL, name)


def test_fused_solve_all_running_averages(solved):
    want, got = dict(leaves(solved["avg_j"])), dict(leaves(solved["avg_t"]))
    assert list(want) == list(got)
    # 15 volume/nodal + graduvb + 2 directions x (16 face + gvL + gvR)
    assert len(want) == 16 + 2 * 18
    for name, w in want.items():
        assert_close(got[name], w, REL, name)
    if not solved["visc"]:      # the gradient averages come back as zeros
        for name in ("graduvb", "faces.x.gvL", "faces.y.gvR"):
            assert not got[name].any()


def test_fused_solve_rebuilds_its_operators_when_given_none(solved):
    tm, args = solved["tm"], solved["args"]
    qb_n, _ = t_solve(tm.static, *args)
    assert torch.equal(qb_n, solved["qb_t"])


def test_fused_solve_matches_the_port_s_per_stage_path(solved):
    """Two routes of the port to the same numbers."""
    import dataclasses

    tm, args = solved["tm"], solved["args"]
    st = dataclasses.replace(tm.static, fused_tail_on=False)
    before = _counters()
    qb_s, avg_s = t_solve(st, *args, vol_ops=btp_volume.operators_from_tables(tm.g, tm.P))
    assert _counters() == before      # none of the fused path's stages ran
    for c in range(4):
        assert_close(solved["qb_t"][c], qb_s[c].numpy(), REL, f"qb[{c}]")
    for (name, got), (_, want) in zip(leaves(solved["avg_t"]), leaves(avg_s)):
        assert_close(got, want.numpy(), REL, name)


# ---- two full steps ------------------------------------------------------------

STEP_CASES = [
    ("fused-visc", _over(True, FREE, fused_tail="on")),
    ("fused-inviscid-walls0420", _over(False, WALLS0420, fused_tail="on")),
    ("uni_volume-visc", _over(True, FREE, uni_volume="on")),
]


@pytest.fixture(scope="module", params=STEP_CASES, ids=lambda c: c[0])
def stepped(request):
    name, over = request.param
    jm = JaxModel(jax_config(**over))
    assert not jm.static.mega
    assert jm.static.fused_tail is ("fused" in name)
    assert jm.static.uni_volume is ("uni_volume" in name)
    s = jm.state0
    for _ in range(2):
        s = jm.step(s)
    tm = TorchModel(torch_config(**over), device="cpu")
    before = _counters()
    got = tm.run(tm.state0, 2)
    ran = {k: v - before[k] for k, v in _counters().items()}
    return name, tm, to_np(s), got, ran


def test_two_steps_match(stepped):
    _, _, want, got, _ = stepped
    for name in ("qb_df", "q_df", "qprime_df"):
        assert_close(getattr(got, name), getattr(want, name), REL, name)
    assert bool(got.ok) == bool(want.ok) is True


def test_two_steps_took_the_path_asked_for(stepped):
    name, tm, _, _, ran = stepped
    per_step = 2 * tm.static.n_btp * tm.static.kstages      # two solves per step
    if "fused" in name:
        assert tm.static.fused_tail and tm.tail_ops is not None
        assert ran == {"A": 2 * per_step, "F": 2 * per_step, "U": 2 * per_step}
    else:
        assert tm.static.uni_volume and not tm.static.fused_tail and tm.tail_ops is None
        assert ran == {"A": 2 * per_step, "F": 0, "U": 0}
        assert isinstance(tm.vol_ops, btp_volume_uni.BtpVolOpsUni)
        assert tm.vol_ops.Gx is None and torch.equal(tm.vol_ops.minv,
                                                     torch.ones_like(tm.vol_ops.minv))
