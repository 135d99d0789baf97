"""Model.step in a closed loop, graphed on the card, with no host read of
the state between steps; the host runs ahead of the device by at most the
steps that fill the traffic's `inflight_seconds`."""
from __future__ import annotations

from time import perf_counter as now

import torch

from .. import state as seeded
from ..drive import (StepClock, after_window, closed_loop, first_steps, program_config,
                     setup_parts, steps_in_flight, warm_up)
from ..trace import traced


def run(cell: dict, seed: int, seconds: float, trace: bool, devices: list, t_start: float,
        model_step_hook=None) -> dict:
    from hnumo_tpu_torch.core.types import State
    from hnumo_tpu_torch.model import Model

    t_entry = now()
    device = devices[0]
    cuda = device.type == "cuda"
    cfg, traffic = cell["config"]["config"], cell["traffic"]
    fields = seeded.initial_fields(cfg, seed, traffic["perturbation"])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    m = Model(program_config(cfg), device=device)
    t_model = now()
    m.keep_graph = cuda
    if model_step_hook is not None:
        m.step = model_step_hook(m)
    s0 = seeded.as_state(State, fields, m.dtype, device)
    s_start, times = first_steps(m, s0, traffic["start_steps"], cuda, read_ok=False)
    setup_s = now() - t_start
    inflight = steps_in_flight(traffic, min(times[1:] or times))
    warm = warm_up(m, s_start, traffic, inflight, cuda)
    clock = StepClock(cuda)
    steps, wall, prev, last = closed_loop(m.step, warm, seconds, inflight, clock)
    run = {"steps": steps, "wall_s": wall, "setup_s": setup_s, "capture_s": times[0],
           "step_ms": clock.step_ms(), "enqueue_s": clock.enqueue_s, "inflight": inflight,
           "dt": cfg["dt"], "config": cfg, "trace": None,
           "setup_parts": setup_parts(t_start, t_entry, t_model, times)}
    if trace:
        tclock = StepClock(cuda)
        (tsteps, _, prev, last), tr = traced(lambda: closed_loop(
            m.step, last, traffic["trace_seconds"], inflight, tclock,
            traffic["trace_min_steps"]))
        run["trace"] = {**tr, "steps": tsteps}
    run.update(after_window(m, cuda))
    return {"run": run, "s0_fields": fields, "start": s_start, "prev": prev, "last": last,
            "start_steps": traffic["start_steps"]}
