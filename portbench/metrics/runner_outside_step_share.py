"""Share of the Runner's wall time outside its steps, in percent:
1 - rhs_time / wall, both from the run's own time.csv (the steps'
time includes the read of `ok` after each)."""
from __future__ import annotations


def read(run):
    tc = run.get("time_csv")
    if not tc or tc[1] <= 0:
        return None
    rhs, wall = tc
    return 100.0 * (1.0 - rhs / wall)
