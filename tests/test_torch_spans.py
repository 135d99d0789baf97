"""The port's host spans (hnumo_tpu_torch/spans.py): off and free without a
profiler, and under the CPU profiler the tree that Model.step and
Runner.run make; the attribution of device activities to spans
(tools/_measure.py) on handmade records. What runs only on the card (a
graphed step's copy-in, replay and clone-out spans, `kernels_by_span`
against the captured graph) is checked there by
`python -m hnumo_tpu_torch.tools.bench --spans`."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hnumo_tpu_torch import spans
from hnumo_tpu_torch.config import Config
from hnumo_tpu_torch.driver import Runner
from hnumo_tpu_torch.model import Model
from hnumo_tpu_torch.tools import _measure
from test_torch_common import one_thread  # noqa: F401  (autouse)

# a tiny double gyre: 3x2 elements, p=2, two barotropic sub-steps a solve
TINY = dict(nelx=3, nely=2, nopx=2, nopy=2, xdims=(0.0, 3e6), ydims=(0.0, 2e6),
            nlayers=2, dt=400.0, dt_btp=200.0, time_final=800.0, time_restart=400.0,
            test_case="double_gyre", f0=9.3e-5, beta=2e-11, botfr=1, cd_mlswe=1e-7,
            method_visc=2, visc_mlswe=100.0, dtype="float64")

# the momentum update takes evaluate_bcl / _v1 with it; the corrector starts
# with the traces of the averaged primes
HALF = ["hnumo.bcl.faces", "hnumo.coupling", "hnumo.btp.solve", "hnumo.bcl.thickness",
        "hnumo.bcl.momentum"]
CORRECTOR = ["hnumo.bcl.faces", "hnumo.coupling", "hnumo.btp.solve", "hnumo.bcl.thickness",
             "hnumo.bcl.faces", "hnumo.bcl.momentum"]


def tiny_model(**over):
    return Model(Config(**{**TINY, **over}), device="cpu")


def profiled(fn):
    """fn()'s result and its hnumo ranges [(name, start, end)] in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(spans.PREFIX)]
    return out, sorted(ranges, key=lambda r: (r[1], -r[2]))


def tree(ranges):
    """The path ("outer/.../name") of each range, in start order: the ranges
    that hold it whole, outermost first."""
    return ["/".join(o[0] for o in ranges if o[1] <= s and e <= o[2])
            for _, s, e in ranges]


def test_without_a_profiler_span_is_the_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    assert spans.span("hnumo.step") is spans.span("hnumo.run.output") is spans._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("hnumo.step") is not spans._OFF


def test_without_a_profiler_no_range_is_entered(monkeypatch, tmp_path):
    def refuse(name):
        raise AssertionError(f"a range {name!r} was entered with no profiler recording")

    monkeypatch.setattr(spans, "_Range", refuse)
    m = tiny_model()
    m.step(m.state0)
    Runner(m, outdir=str(tmp_path)).run(quiet=True)
    with pytest.raises(AssertionError, match="was entered"):
        with profile(activities=[ProfilerActivity.CPU]):
            m.step(m.state0)


@pytest.mark.parametrize("mega", ["off", "on"])
def test_an_eager_step_makes_the_span_tree(mega):
    m = tiny_model(mega=mega)
    _, ranges = profiled(lambda: m.step(m.state0))
    pred, corr = "hnumo.step/hnumo.bcl.predictor", "hnumo.step/hnumo.bcl.corrector"
    assert tree(ranges) == (["hnumo.step", pred] + [f"{pred}/{n}" for n in HALF]
                            + [corr] + [f"{corr}/{n}" for n in CORRECTOR])


@pytest.mark.parametrize("mega", ["off", "on"])
def test_the_spans_change_no_number_of_the_step(mega):
    m = tiny_model(mega=mega)
    plain = m.step(m.state0)
    traced, _ = profiled(lambda: m.step(m.state0))
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_a_runner_with_two_output_points(tmp_path):
    m = tiny_model()
    _, ranges = profiled(lambda: Runner(m, outdir=str(tmp_path)).run(quiet=True))
    paths = tree(ranges)
    out = "hnumo.run.output"
    assert paths.count(out) == 2 and paths.count("hnumo.run.ok_read") == 2
    assert paths.count("hnumo.step") == 2
    for child in ("hnumo.run.gather", "hnumo.io.snapshot", "hnumo.io.diagnostics",
                  "hnumo.run.mass_log"):
        assert paths.count(f"{out}/{child}") == 2, child
    # the snapshot's formatting, inside the snapshot
    assert paths.count(f"{out}/hnumo.io.snapshot/hnumo.io.snapshot.format") == 2
    # each point holds one of each, in the order the Runner writes them
    points = [r for r in ranges if r[0] == out]
    for _, s, e in points:
        inner = [n for n, s2, e2 in ranges if s < s2 and e2 < e]
        assert inner == ["hnumo.run.gather", "hnumo.io.snapshot", "hnumo.io.snapshot.format",
                         "hnumo.io.diagnostics", "hnumo.run.mass_log"]
    assert paths[-2:] == ["hnumo.run.finish", "hnumo.run.finish/hnumo.io.diagnostics"]


def test_a_snapshot_is_spanned_only_where_one_is_written(tmp_path):
    m = tiny_model(dump_data=False)
    _, ranges = profiled(lambda: Runner(m, outdir=str(tmp_path)).run(quiet=True))
    paths = tree(ranges)
    assert paths.count("hnumo.run.output") == 2
    assert not any(p.endswith("hnumo.io.snapshot") for p in paths)


def test_each_activity_goes_to_the_innermost_span_of_its_launch():
    ranges = [("hnumo.step", 0.0, 10.0), ("hnumo.bcl.predictor", 1.0, 5.0),
              ("hnumo.btp.solve", 2.0, 3.0), ("hnumo.bcl.corrector", 5.5, 9.0)]
    launches = {1: 0.5, 2: 2.5, 3: 2.6, 4: 4.0, 5: 6.0, 6: 11.0}
    activities = [("k_self", 1.0, 1.5, 1), ("btp_mega_kernel", 3.0, 4.0, 2),
                  ("Memcpy DtoD (Device -> Device)", 4.0, 4.25, 3),
                  ("k_pred", 5.0, 5.5, 4), ("Memset (Device)", 7.0, 7.5, 5),
                  ("k_late", 12.0, 12.5, 6), ("k_lost", 13.0, 13.5, 99)]
    got = _measure.attribute(ranges, launches, activities)
    solve = "hnumo.step/hnumo.bcl.predictor/hnumo.btp.solve"
    assert set(got) == {"hnumo.step", "hnumo.step/hnumo.bcl.predictor", solve,
                        "hnumo.step/hnumo.bcl.corrector", _measure.OUTSIDE, _measure.NO_LAUNCH}
    assert got[solve]["launches"] == 2
    assert got[solve]["device_ms"] == pytest.approx(1250.0)
    assert got[solve]["kernels"] == {"btp_mega_kernel": 1, "(memcpy)": 1}
    assert got["hnumo.step"]["kernels"] == {"k_self": 1}
    assert got["hnumo.step/hnumo.bcl.corrector"]["kernels"] == {"(memset)": 1}
    assert got[_measure.OUTSIDE]["kernels"] == {"k_late": 1}
    assert got[_measure.NO_LAUNCH]["kernels"] == {"k_lost": 1}
    assert sum(r["launches"] for r in got.values()) == len(activities)


def test_span_path_names_the_ranges_that_hold_a_time():
    ranges = [("a", 0.0, 10.0), ("b", 1.0, 4.0), ("c", 2.0, 3.0)]
    assert _measure.span_path(ranges, 2.5) == "a/b/c"
    assert _measure.span_path(ranges, 5.0) == "a"
    assert _measure.span_path(ranges, 11.0) is None


def test_kernels_by_span_takes_a_graphed_model():
    m = tiny_model()
    with pytest.raises(ValueError, match="graphed model"):
        _measure.kernels_by_span(m, m.state0)


@pytest.mark.parametrize("symbol,name", [
    ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfEESt5arrayIPcLm1EEEEv"
     "iT0_T1_",
     "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
     "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n", "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n"),
    ("(memcpy)", "(memcpy)"),
])
def test_graph_symbols_demangle_as_the_profiler_names_kernels(symbol, name):
    assert _measure.demangle(symbol) == name
