"""Host milliseconds of one snapshot the Runner writes (its
`hnumo.io.snapshot` span, inside Runner._write_snapshot), the mean over
the traced window's snapshots."""
from __future__ import annotations

from ._spans import mean_ms


def read(run):
    return mean_ms(run, "hnumo.io.snapshot")
