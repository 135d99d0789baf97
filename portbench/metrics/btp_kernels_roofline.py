"""The five barotropic kernels' share of their roofline, in percent: the
sum over their launches in the traced window of each launch's least time
(bounds.py: operands once over the published HBM rate against flops over
the published float32 peak of one H100 SXM at 700 W) over the sum of their
device times."""
from __future__ import annotations

from ..bounds import kernel_bounds, shape_of
from ._common import kernel_of


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    launches, device_s = {}, 0.0
    for name, s, e in tr["device"]:
        k = kernel_of(name)
        if k:
            launches[k] = launches.get(k, 0) + 1
            device_s += e - s
    if not launches or device_s <= 0:
        return None
    bounds = kernel_bounds(shape_of(run["config"]), launches)
    least_s = sum(n * bounds[k]["bound_ms"] / 1e3 for k, n in launches.items())
    return 100.0 * least_s / device_s
