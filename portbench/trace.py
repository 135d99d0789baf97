"""A traced window: torch.profiler (CUPTI) over a stretch of the timed
path, reduced to device intervals, host spans and the breakdown."""
from __future__ import annotations

import contextlib

from . import stats

WINDOW_SPAN = "portbench.window"


@contextlib.contextmanager
def span(name: str):
    """A host span named `name` in a traced window (nothing otherwise)."""
    from torch.profiler import record_function

    with record_function(name):
        yield


def traced(fn):
    """Run `fn()` under torch.profiler (CPU and CUDA activities) inside a
    span of its own; returns (fn's result, the reduced trace): device
    intervals [(name, start_s, end_s)] and host events on one clock, the
    window (the span's start and end) and the device's busy seconds in it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span(WINDOW_SPAN):
            out = fn()
            torch.cuda.synchronize()
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e9
        item = (e.name(), s, s + e.duration_ns() / 1e9)
        if e.name().startswith("portbench.") and e.device_type() != DeviceType.CPU:
            continue                  # a span's copy on the device's timeline
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            device.append(item)
        elif e.name() == WINDOW_SPAN:
            window = item[1:]
        else:
            host.append(item)
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    w0, w1 = window
    device = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    busy = stats.union_length((s, e) for _, s, e in device)
    return out, {"device": device, "host": host, "window": window,
                 "window_s": w1 - w0, "busy_s": busy}


def breakdown(tr: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the innermost host event open at its middle."""
    per_op = {}
    for name, s, e in tr["device"]:
        key = name if len(name) <= 96 else name[:93] + "..."
        per_op[key] = per_op.get(key, 0.0) + (e - s)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    w0, w1 = tr["window"]
    idle = stats.gaps([(s, e) for _, s, e in tr["device"]], w0, w1)[:top]
    host = sorted(tr["host"], key=lambda h: h[1])
    named = []
    for g0, g1 in idle:
        mid = 0.5 * (g0 + g1)
        inner = [h for h in host if h[1] <= mid <= h[2]]
        label = max(inner, key=lambda h: h[1])[0] if inner else "host: Python, no traced call"
        named.append([f"idle during {label}", g1 - g0])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
