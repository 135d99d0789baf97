"""What the decomposed step must hold for one CUDA graph to be captured and
replayed on every rank over NCCL, checked on the CPU over gloo ranks (8x8
bump, p=3, f64; split 2x2 and 1x2, per stage and fused):

(a) every rank makes the same exchange calls (axis, sense, shape, dtype,
    peers) in step 2 as in step 1, and each send is met by its peer's
    receive of the same slab in the same call: a captured step replays the
    first step's calls, on every rank, in the same order;
(b) the receive buffers of step 2 are those of step 1 (a graph holds the
    addresses it was captured with);
(c) a decomposed eager step reads nothing back to the host (a capture
    forbids it), with every host read patched to raise;
(d) `step_impl` is resolved by the transport: "graph" by default over NCCL,
    "eager" over gloo, and "graph" with halos staged through host memory
    raises.

The capture and the replays themselves need CUDA devices: chip_smoke.py
phase 27c replays one rank's plans against a self-exchange on one GPU, and
phase 27b runs the split graphed against the split eager on several.
"""
import pathlib

import pytest
import torch

import torch_decomp_ranks as R
from hnumo_tpu_torch.model import Model, resolve_step_impl
from hnumo_tpu_torch.parallel.launch import start_function
from hnumo_tpu_torch.parallel.sharding import Decomposition, Exchange

TESTS = pathlib.Path(__file__).resolve().parent
SHAPES = [(2, 2), (1, 2)]
# a no-slip west and a copy east wall: the blocks on a closed edge post
# nothing that way
CASES = [("per_stage", dict(x_boundary=(2, 0))),
         ("fused", dict(x_boundary=(2, 0), fused_tail="on", method_visc=2,
                        visc_mlswe=10.0))]
RANK_TIMEOUT = 300.0


@pytest.fixture(scope="module")
def plans():
    ranks = {shape: start_function("torch_decomp_ranks:plan_ranks", shape, "gloo",
                                   device="cpu", kwargs=dict(cases=CASES),
                                   pythonpath=[TESTS])
             for shape in SHAPES}
    return {shape: r.result(RANK_TIMEOUT) for shape, r in ranks.items()}


def _without_ptr(plan):
    return [Exchange(*e)._replace(recv_ptr=None) for e in plan]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_the_exchange_plan_is_the_same_in_every_step(plans, name, shape):
    for rank, out in enumerate(plans[shape]):
        res = out[name]
        first, second = (_without_ptr(p) for p in res["plans"])
        assert first == second, f"rank {rank}: the plan changed between steps"
        assert res["calls"] == 2 * len(first) and res["posting"][0] > 0
        assert res["step_impl"] == "eager" and not res["mega"]
        assert res["fused"] == (name == "fused")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_every_send_meets_its_peer_s_receive(plans, name, shape):
    """Call i of every rank is the same exchange: where rank r sends to p,
    p receives from r a slab of the same axis, sense, shape and dtype, and
    the other way round."""
    per_rank = [_without_ptr(out[name]["plans"][0]) for out in plans[shape]]
    assert len({len(p) for p in per_rank}) == 1
    for rank, plan in enumerate(per_rank):
        for i, e in enumerate(plan):
            if e.send_to is not None:
                peer = per_rank[e.send_to][i]
                assert peer.recv_from == rank, (rank, i, e, peer)
                assert peer[:4] == e[:4], (rank, i, e, peer)
            if e.recv_from is not None:
                peer = per_rank[e.recv_from][i]
                assert peer.send_to == rank, (rank, i, e, peer)
                assert peer[:4] == e[:4], (rank, i, e, peer)
    # every rank sends and receives (two blocks along a closed axis: each
    # call posts one way only)
    for plan in per_rank:
        assert any(e.send_to is not None for e in plan)
        assert any(e.recv_from is not None for e in plan)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_the_receive_buffers_stay_where_they_were(plans, name, shape):
    for rank, out in enumerate(plans[shape]):
        first, second = ([e[-1] for e in p] for p in out[name]["plans"])
        assert first == second, f"rank {rank}: a receive buffer moved"
        assert any(ptr is not None for ptr in first)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_a_decomposed_step_reads_nothing_back_from_the_device(plans, name, shape):
    """Step 2 ran with every host read patched to raise, on every rank, and
    gave bitwise what the unpatched step gives."""
    for rank, out in enumerate(plans[shape]):
        res = out[name]
        assert res["patched"], f"rank {rank}: the host reads were not patched"
        assert res["same"] and res["ok"], rank


def _stand_in(transport, device):
    backend = "gloo" if transport.startswith("gloo") else "nccl"
    return Decomposition(shape=(1, 2), rank=0, backend=backend, transport=transport,
                         device=torch.device(device))


def test_step_impl_follows_the_transport():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    nccl = _stand_in("nccl", "cuda:0")
    assert resolve_step_impl(None, nccl, cuda) == "graph"
    assert resolve_step_impl("eager", nccl, cuda) == "eager"
    staged = _stand_in("gloo-host-staged", "cuda:0")
    assert resolve_step_impl(None, staged, cuda) == "eager"
    with pytest.raises(ValueError, match="gloo-host-staged"):
        resolve_step_impl("graph", staged, cuda)
    gloo = _stand_in("gloo", "cpu")
    assert resolve_step_impl(None, gloo, cpu) == "eager"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        resolve_step_impl("graph", gloo, cpu)
    # without a decomposition, as before
    assert resolve_step_impl(None, None, cuda) == "graph"
    assert resolve_step_impl(None, None, cpu) == "eager"
    with pytest.raises(ValueError, match="must be one of"):
        resolve_step_impl("replay", nccl, cuda)


def test_a_model_over_gloo_steps_eagerly_and_refuses_the_graph():
    """On the CPU (gloo) a decomposed model's default is eager, and "graph"
    raises as on one device (no longer NotImplementedError)."""
    gloo = _stand_in("gloo", "cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        Model(R.bump_config(), device="cpu", decomp=gloo, step_impl="graph")
    m = Model(R.bump_config(), device="cpu", decomp=gloo)
    assert m.step_impl == "eager"
