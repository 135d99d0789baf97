"""Device milliseconds a step of the five barotropic kernels (btp_mega,
btp_volume, btp_volume_uni, btp_faces, btp_update) in the traced window."""
from __future__ import annotations

from ._common import kernel_of


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    ms = [(e - s) * 1e3 for name, s, e in tr["device"] if kernel_of(name)]
    return sum(ms) / tr["steps"] if ms else None
