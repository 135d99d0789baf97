"""The readers of the port's own spans on handmade run records: what each
counts, what it leaves out, and that each reads nothing from a trace that
holds none of its spans (a program without them)."""
import pytest

from portbench import metrics


def record(host):
    return {"trace": {"host": host, "device": [], "window": (0.0, 100.0), "steps": 2}}


def steady_host():
    """Two steps: each 5 copies in, a graph launch (and a kernel launch
    inside the replay, which the graph's launch does not make but must not
    count), 5 clones out; one step nested in a same-named range; launches
    outside every step."""
    host = [("cudaMemcpyAsync", 0.1, 0.2), ("cudaLaunchKernel", 0.3, 0.4)]
    for t0 in (1.0, 10.0):
        host.append(("hnumo.step", t0, t0 + 5.0))
        host += [("cudaMemcpyAsync", t0 + 0.1 * i, t0 + 0.1 * i + 0.05) for i in range(1, 6)]
        host.append(("hnumo.step.replay", t0 + 1.0, t0 + 2.0))
        host += [("cudaGraphLaunch", t0 + 1.1, t0 + 1.5), ("cudaLaunchKernel", t0 + 1.6, t0 + 1.7)]
        host += [("cudaMemcpyAsync", t0 + 2.1 + 0.1 * i, t0 + 2.15 + 0.1 * i) for i in range(5)]
    host.append(("hnumo.step", 10.0, 15.0))               # the same step, nested in itself
    host.append(("cudaLaunchKernelExC", 14.0, 14.2))      # a launch in the step's own code
    host.append(("cuLaunchKernel", 14.05, 14.1))          # its driver call: a part of it
    host.append(("aten::copy_", 2.1, 2.6))
    return host


def test_launches_outside_the_graph_are_counted_per_step():
    assert metrics.read("launches_outside_graph_per_step", record(steady_host())) == 10.5


def test_a_launch_inside_the_replay_is_not_counted():
    host = [("hnumo.step", 0.0, 3.0), ("hnumo.step.replay", 1.0, 2.0),
            ("cudaLaunchKernel", 1.5, 1.6), ("cudaMemsetAsync", 2.5, 2.6)]
    assert metrics.read("launches_outside_graph_per_step", record(host)) == 1.0


def points_host():
    """Three output points of 200, 300 and 400 ms, one holding a nested
    output range of its own name; their snapshots 150, 250, 350 ms."""
    host = []
    for t0, ms in ((1.0, 0.2), (5.0, 0.3), (9.0, 0.4)):
        host.append(("hnumo.run.output", t0, t0 + ms))
        host.append(("hnumo.run.gather", t0, t0 + 0.01))
        host.append(("hnumo.io.snapshot", t0 + 0.01, t0 + ms - 0.04))
        host.append(("portbench.snapshot", t0 + 0.005, t0 + ms - 0.035))
        host.append(("hnumo.io.diagnostics", t0 + ms - 0.03, t0 + ms - 0.01))
    host.append(("hnumo.run.output", 5.1, 5.2))
    host.append(("hnumo.io.diagnostics", 20.0, 20.5))     # the final summary, no point
    return host


def test_output_and_snapshot_ms_are_means_over_the_points():
    run = record(points_host())
    assert metrics.read("output_ms_per_point", run) == pytest.approx(300.0)
    assert metrics.read("snapshot_ms_per_point", run) == pytest.approx(250.0)


@pytest.mark.parametrize("name", ["launches_outside_graph_per_step", "output_ms_per_point",
                                  "snapshot_ms_per_point"])
@pytest.mark.parametrize("run", [
    {"trace": None},
    {},
    record([("portbench.step", 0.0, 1.0), ("cudaGraphLaunch", 0.1, 0.2),
            ("portbench.snapshot", 1.0, 2.0)]),
], ids=["untraced", "no_trace_key", "no_hnumo_spans"])
def test_a_reader_reads_nothing_without_its_spans(name, run):
    assert metrics.read(name, run) is None
