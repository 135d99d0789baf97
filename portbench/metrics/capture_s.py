"""Seconds of the first step: kernel load (and build, in a fresh
checkout), the eager warm-up and the graph capture."""
from __future__ import annotations


def read(run):
    return run.get("capture_s")
