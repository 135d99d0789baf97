"""Host milliseconds of one output point of the Runner (its `hnumo.run.output`
span: the gather, the snapshot, the diagnostics, the mass-log line and the
printed summary), the mean over the traced window's points."""
from __future__ import annotations

from ._spans import mean_ms


def read(run):
    return mean_ms(run, "hnumo.run.output")
