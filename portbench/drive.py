"""What the driven entries (entries/<entry>.py) share: the step's clock,
the closed loop, the first steps, the warm-up and the graph's proof.

The port is imported here and in entries/, and nowhere else in the
benchmark.
"""
from __future__ import annotations

import math
from time import perf_counter as now

import torch

from . import stats
from .trace import span


def program_config(cfg: dict, **over):
    from hnumo_tpu_torch.config import Config

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}
    return Config(**{**kw, **over})


def sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


class StepClock:
    """Stamps after each step on the device's stream (CUDA events; on the
    CPU, the host clock after the step returns, for the tests), and the
    host's time inside the step calls."""

    def __init__(self, cuda: bool):
        self.cuda, self.stamps, self.enqueue_s = cuda, [], 0.0

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.stamps.append(ev)
        else:
            self.stamps.append(now())

    def wait(self, i: int) -> None:
        """Block until the step that stamp `i` closes has run."""
        if self.cuda:
            self.stamps[i].synchronize()

    def step_ms(self) -> list[float]:
        """The time of each step: from one stamp to the next."""
        s = self.stamps
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(s, s[1:])]
        return [x * 1e3 for x in stats.intervals_between(s)]


def closed_loop(step, state, seconds: float, inflight: int, clock: StepClock,
                min_steps: int = 1):
    """Step `state` until `seconds` have passed on the host (at least
    `min_steps`), with at most `inflight` steps ahead of the device; then
    wait for the device. Returns (steps, wall seconds, the state before
    the last step, the last state)."""
    clock.mark()
    t0 = now()
    n, prev = 0, None
    while True:
        if n >= inflight:
            with span("portbench.wait"):
                clock.wait(n - inflight + 1)
        a = now()
        with span("portbench.step"):
            prev, state = state, step(state)
        clock.enqueue_s += now() - a
        clock.mark()
        n += 1
        if n >= min_steps and now() - t0 >= seconds:
            break
    sync(clock.cuda)
    return n, now() - t0, prev, state


class Wrapped:
    """A model's step seen from outside: stamps each step on a StepClock
    and keeps the state before the last step and the last state. Set as
    the instance's `step`, so that whatever calls `model.step` (the Runner)
    goes through it."""

    def __init__(self, model, clock: StepClock | None = None):
        self.inner, self.clock = model.step, clock
        self.prev = self.last = None
        self.steps = 0

    def __call__(self, state):
        with span("portbench.step"):
            out = self.inner(state)
        if self.clock is not None:
            self.clock.mark()
        self.prev, self.last = state, out
        self.steps += 1
        return out


def first_steps(m, s0, count: int, cuda: bool, read_ok: bool):
    """`count` steps from `s0`, each waited for: (state, seconds of each).
    The first builds or loads the kernels and captures the step's graph."""
    times, s = [], s0
    for _ in range(count):
        t = now()
        s = m.step(s)
        if read_ok and not bool(s.ok):
            raise RuntimeError("the state's ok flag fell in the first steps")
        sync(cuda)
        times.append(now() - t)
    return s, times


def setup_parts(t_start, t_entry, t_model, times) -> dict:
    """Where `setup_s` went: up to the entry (the harness's imports and the
    look for the cards), the port's imports, the seeded state and the
    model's build, and the start steps (the first loads the kernels and
    captures the graph)."""
    return {"imports_s": t_entry - t_start, "model_s": t_model - t_entry,
            "start_steps_s": sum(times)}


def warm_up(m, state, traffic: dict, inflight: int, cuda: bool):
    """Step for the traffic's `warmup_seconds` after set-up and before the
    window, counted in neither. On the H100 machines that run the
    benchmark, a process's graph replays run in a slow mode (~0.35 us more
    a graph node: at 25x25 9.2 ms/step against 7.76) for the first 4 to 33
    s or more after its first replay, then fast for good, whether the card
    is busy or idle meanwhile, at the same SM and memory clocks; the window
    measures the steady state that a long run lives in."""
    return closed_loop(m.step, state, traffic["warmup_seconds"], inflight,
                       StepClock(cuda))[3]


def steps_in_flight(traffic: dict, step_s: float) -> int:
    return max(2, min(64, math.ceil(traffic["inflight_seconds"] / max(step_s, 1e-6))))


def after_window(m, cuda: bool) -> dict:
    """The peak memory and the captured graph's kernel nodes, against the
    path that the model says it takes."""
    from .graphs import expected_from_static, graph_kernels, path_counts

    out = {"memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
           "graph_nodes": None, "path": None}
    if cuda:
        nodes = graph_kernels(m._graph[0])
        got, want = path_counts(nodes), expected_from_static(m.static)
        if got != want:
            raise AssertionError(f"the captured graph launches {got} of the five kernels; "
                                 f"the path the model reports runs {want}")
        out["graph_nodes"] = nodes
        out["path"] = {k: n for k, n in got.items() if n}
    return out

