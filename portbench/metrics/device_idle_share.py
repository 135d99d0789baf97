"""Share of the measured window in which the device did nothing, in
percent: 1 - (busy device time a step) / (the window's time a step). The
busy time is the union of the device's activity intervals in the traced
window over its steps; the time a step is the untraced window's, all its
wall time over all its steps. Under the profiler the host launches each
step later (the graph's launch is instrumented node by node), so the
traced window's own span would count the profiler's cost as idle. Where
the device is the limit the share reads near 0, and may read a little
under it: the profiler lengthens the device's busy time a step by some
tenths of a percent."""
from __future__ import annotations


def read(run):
    tr = run.get("trace")
    if not tr or not tr["steps"] or not run["steps"] or run["wall_s"] <= 0:
        return None
    busy_per_step = tr["busy_s"] / tr["steps"]
    return 100.0 * (1.0 - busy_per_step / (run["wall_s"] / run["steps"]))
