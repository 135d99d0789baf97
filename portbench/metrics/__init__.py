"""One reader per per-layer quantity, found by the metric's name:
metrics/<quantity>.py defines `read(run) -> float | None` and reads the
metric `<quantity>` and every `<quantity>.<cells>` (the same quantity,
split because its cells report another end-to-end metric). `run` is the
record a run of a cell leaves (entries/): None where the reader finds
nothing to read, and the metric is then left out of the result."""
from __future__ import annotations

import importlib


def read(name: str, run: dict):
    return importlib.import_module(f"{__name__}.{name.split('.')[0]}").read(run)
