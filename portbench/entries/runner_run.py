"""driver.Runner.run from a namelist, which reads `state.ok` after every
step and writes a snapshot, the diagnostics and a mass-log line every
`time_restart`."""
from __future__ import annotations

import dataclasses
import math
import shutil
import tempfile
from pathlib import Path
from time import perf_counter as now

import torch

from .. import state as seeded
from ..compare import last_mass_line, read_txt
from ..drive import (StepClock, Wrapped, after_window, first_steps, setup_parts,
                     steps_in_flight, sync, warm_up)
from ..trace import span, traced


def _namelist(cfg: dict, extra: dict) -> str:
    def fmt(v):
        if isinstance(v, bool):
            return ".true." if v else ".false."
        if isinstance(v, str):
            return f"'{v}'"
        if isinstance(v, (list, tuple)):
            return ", ".join(fmt(x) for x in v)
        return repr(v)

    lines = [f" {k} = {fmt(v)}" for k, v in {**cfg, **extra}.items()]
    return "&input\n" + "\n".join(lines) + "\n/\n"


def _span_snapshots(runner) -> None:
    """Each snapshot the Runner writes inside a host span of its own."""
    inner = runner._write_snapshot

    def write(*args, **kwargs):
        with span("portbench.snapshot"):
            return inner(*args, **kwargs)

    runner._write_snapshot = write


def run(cell: dict, seed: int, seconds: float, trace: bool, devices: list, t_start: float,
        model_step_hook=None) -> dict:
    """Runner.run from a namelist in a directory of its own under TMPDIR
    (deleted before the return), from the state after the start steps and
    the warm-up."""
    from hnumo_tpu_torch.config import config_from_namelist
    from hnumo_tpu_torch.core.types import State
    from hnumo_tpu_torch.driver import Runner
    from hnumo_tpu_torch.model import Model

    t_entry = now()
    device = devices[0]
    cuda = device.type == "cuda"
    cfg, traffic = cell["config"]["config"], cell["traffic"]
    fields = seeded.initial_fields(cfg, seed, traffic["perturbation"])
    outdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        nml = Path(outdir) / "numo3d.in"
        extra = {"time_final": 0.0, "time_restart": traffic["time_restart"],
                 "out_type": traffic["out_type"], "dump_data": True,
                 "lprint_diagnostics": True}
        nml.write_text(_namelist(cfg, extra))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        m = Model(config_from_namelist(nml), device=device)
        t_model = now()
        m.keep_graph = cuda
        if model_step_hook is not None:
            m.step = model_step_hook(m)
        s0 = seeded.as_state(State, fields, m.dtype, device)
        s_start, times = first_steps(m, s0, traffic["start_steps"], cuda, read_ok=True)
        setup_s = now() - t_start
        warm = warm_up(m, s_start, traffic, steps_in_flight(traffic, min(times[1:] or times)),
                       cuda)
        # a short run of the same Runner, its output included, times a step
        # for the window's time_final, so that the run fills the window
        cal_steps = traffic["calibration_steps"]
        m.cfg = dataclasses.replace(m.cfg, time_final=cal_steps * cfg["dt"])
        t = now()
        warm, _ = Runner(m, outdir=str(Path(outdir) / "calibration")).run(state=warm, quiet=True)
        per_step = (now() - t) / cal_steps
        nsteps = max(1, math.ceil(seconds / per_step))
        m.cfg = dataclasses.replace(m.cfg, time_final=nsteps * cfg["dt"])
        clock = StepClock(cuda)
        wrapped = Wrapped(m, clock)
        m.step = wrapped
        runner = Runner(m, outdir=outdir)
        _span_snapshots(runner)
        clock.mark()
        t0 = now()
        runner.run(state=warm, quiet=True)
        sync(cuda)
        wall = now() - t0
        rhs, run_wall = (float(v) for v in
                         (Path(outdir) / "time.csv").read_text().split("\n")[0].split(","))
        written = {"snapshot": read_txt(Path(outdir) / f"mlswe{wrapped.steps:04d}"),
                   "mass_log": last_mass_line(Path(outdir) / "mass_mlswe.cons"),
                   "bytes": sum(p.stat().st_size for p in Path(outdir).rglob("*") if p.is_file())}
        run = {"steps": wrapped.steps, "wall_s": wall, "setup_s": setup_s,
               "capture_s": times[0], "step_ms": clock.step_ms(), "enqueue_s": None,
               "dt": cfg["dt"], "config": cfg, "time_csv": (rhs, run_wall), "trace": None,
               "bytes_written": written["bytes"],
               "setup_parts": setup_parts(t_start, t_entry, t_model, times)}
        prev, last = wrapped.prev, wrapped.last
        written["state"] = last
        prev_of_written = prev
        if trace:
            tr_steps = max(traffic["trace_min_steps"],
                           math.ceil(traffic["trace_seconds"] / per_step))
            m.cfg = dataclasses.replace(m.cfg, time_final=tr_steps * cfg["dt"])
            wrapped.steps, wrapped.clock = 0, None
            truns = Runner(m, outdir=str(Path(outdir) / "traced"))
            _span_snapshots(truns)
            _, tr = traced(lambda: truns.run(state=last, quiet=True))
            run["trace"] = {**tr, "steps": wrapped.steps}
            prev, last = wrapped.prev, wrapped.last
        run.update(after_window(m, cuda))
        return {"run": run, "s0_fields": fields, "start": s_start, "prev": prev,
                "last": last, "written": written, "prev_of_written": prev_of_written,
                "start_steps": traffic["start_steps"]}
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
