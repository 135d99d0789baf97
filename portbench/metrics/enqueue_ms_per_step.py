"""Host milliseconds a step inside the step calls of the measured window
(the copy-in, the replay's launch and the clone-out, before the window's
synchronize)."""
from __future__ import annotations


def read(run):
    if run.get("enqueue_s") is None or not run["steps"]:
        return None
    return run["enqueue_s"] * 1e3 / run["steps"]
