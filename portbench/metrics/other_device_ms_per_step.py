"""Busy device milliseconds a step outside the five barotropic kernels
(the baroclinic step, the generic kernels of the faces and the copies):
the union of the other activities' intervals over the traced steps."""
from __future__ import annotations

from ..stats import union_length
from ._common import kernel_of


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    other = [(s, e) for name, s, e in tr["device"] if not kernel_of(name)]
    return union_length(other) * 1e3 / tr["steps"] if other else None
