"""What the readers of the port's own spans share. The port's spans
(hnumo_tpu_torch/spans.py) are CPU ranges named "hnumo.*" in the traced
window's host events [(name, start_s, end_s)]; a reader finds none in a
program that has no such span, and then reads nothing."""
from __future__ import annotations


def nested_out(ranges) -> list[tuple[float, float]]:
    """The ranges (start, end) that no other of them holds."""
    out = []
    for s, e in sorted(ranges, key=lambda r: (r[0], -r[1])):
        if out and out[-1][0] <= s and e <= out[-1][1]:
            continue
        out.append((s, e))
    return out


def outermost(host, name: str) -> list[tuple[float, float]]:
    """(start, end) of the ranges named `name` that no other range of that
    name holds: a range nested in a same-named one is a part of it."""
    return nested_out((s, e) for n, s, e in host if n == name)


def inside(t: float, ranges) -> bool:
    return any(s <= t <= e for s, e in ranges)


def mean_ms(run, name: str):
    """Mean host milliseconds of the outermost ranges named `name` in the
    traced window; None where it holds none."""
    tr = run.get("trace")
    ranges = outermost(tr["host"], name) if tr else []
    if not ranges:
        return None
    return sum(e - s for s, e in ranges) * 1e3 / len(ranges)
