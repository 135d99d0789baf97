"""The driven entries of the port, one module each, found by the name that
a traffic mix gives under `entry` (traffic/<mix>.json): entries/<entry>.py
defines

    run(cell, seed, seconds, trace, devices, t_start, model_step_hook=None) -> dict

which runs the cell once, from set-up through the measured window (and,
with `trace`, a traced window), on `devices` (one torch.device for each
card the cell asks for; the CPU in the tests), and returns what the run
produced for the judge and the readers: `run` (the record the readers
take), `s0_fields`, `start`, `start_steps`, `prev`, `last`, and for the
run layer `written` and `prev_of_written`. `t_start` is the host clock's
reading at the process's start, from which `setup_s` is taken.
"""
from __future__ import annotations

import importlib


def find(name: str):
    """The `run` of entries/<name>.py."""
    return importlib.import_module(f"{__name__}.{name}").run
