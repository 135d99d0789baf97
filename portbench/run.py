"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. Set-up (imports, the port's model and tables,
the seeded initial state, the first steps, which build the kernels and
capture the step's graph) is timed from the start of this process to the
first timed step (`setup_s`); then the cell's traffic runs for `--seconds`;
with `--trace 1` a traced window follows. Once the window has closed and
the peak memory has been read, the port's state is judged against the
plain reference (reference/) on the same device, and each number compared
is printed beside its limit (checks/<workload>.json): as the last lines on
standard error, and last in the result's line. The last line on standard
output is one JSON object: correct, attempted, failed, metrics, device,
[breakdown], checks. Exits 1 without a result where CUDA or the cell's
cards are missing, and where jax, jaxlib, flax or hnumo_tpu has been
loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    # one host thread for the CPU's math libraries: the card's host shares
    # its cores with other machines' work, and threads that wait on each
    # other there spread the set-up from run to run
    os.environ.update({k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                        "MKL_NUM_THREADS")})

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    __package__ = "portbench"

import torch  # noqa: E402

from portbench import cells, compare, metrics, stats, trace as tracing  # noqa: E402
from portbench.state import as_state, ref_config  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hnumo_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or
    hnumo_tpu, compared whole (hnumo_tpu_torch is not hnumo_tpu)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def judge(cell: dict, out: dict, device: torch.device) -> tuple[bool, dict]:
    """Every number compared, against the reference in float64 on `device`:
    the first steps from the seeded state, the last step of the window
    from the state before it, the total mass, the ok flag, and for the run
    layer its last snapshot and mass-log line against the state."""
    from portbench.reference import Reference, State as RState

    cfg = cell["config"]["config"]
    ref = Reference(ref_config(cfg), device, torch.float64)
    f64 = dict(dtype=torch.float64, device=device)
    s0 = as_state(RState, out["s0_fields"], torch.float64, device)
    values = compare.state_gaps("start", out["start"], ref.run(s0, out["start_steps"]))
    values.update(compare.state_gaps("last", out["last"], ref.step(out["prev"])))
    dp_ref = torch.tensor(out["s0_fields"]["dp_ref"], **f64)
    wjac = ref.g.wjac_df.to(**f64)
    m0 = compare.total_mass(s0, dp_ref, wjac)
    values["mass_drift"] = abs(compare.total_mass(out["last"], dp_ref, wjac) - m0) / m0
    values["not_ok"] = 0.0 if bool(out["last"].ok) else 1.0
    written = out.get("written")
    if written is not None:
        ini = ref.init_fields
        want = compare.derived(written["state"], dp_ref, ini.alpha, ini.gravity)
        values["snapshot"] = compare.snapshot_gap(written["snapshot"], want)
        step, logged = written["mass_log"]
        h = torch.tensor(want["h"], **f64).reshape(len(logged), *wjac.shape)
        mass = (wjac[None] * h).sum(dim=tuple(range(1, h.dim()))).tolist()
        values["masslog"] = (max(abs(a - b) / abs(b) for a, b in zip(logged, mass))
                             if step == out["run"]["steps"] else float("inf"))
    return compare.judge(values, cell["limits"])


def end_to_end(cell: dict, run: dict) -> dict:
    """The cell's end-to-end metrics. A metric `<quantity>.<cells>` is
    `<quantity>` under a bound of its own, for the cells it lists."""
    values = {"sypd": stats.sypd(run["steps"], run["dt"], run["wall_s"]),
              "setup_s": run["setup_s"],
              "step_ms_p95": stats.percentile(run["step_ms"], 95.0)}
    return {m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
            for m in cell["end_to_end"]}


def per_layer(cell: dict, run: dict) -> dict:
    out = {}
    for m in cell["per_layer"]:
        value = metrics.read(m["name"], run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             root: Path = cells.ROOT, here: Path = cells.HERE, model_step_hook=None,
             t_start: float = T_START) -> tuple[dict, dict]:
    """One run of workload `name`: the result's object, and the record the
    run left (entries/). `device` None: the cards, which must be there, as
    many as the cell asks for; the entry runs on cuda:0 up to the cell's
    count, and the judge on the first."""
    from portbench import entries

    cell = cells.cell(name, root, here)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{name} runs on {cell['chips']} CUDA device(s); this machine "
                             f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    else:
        devices = [torch.device(device)]
    device = devices[0]
    entry = entries.find(cell["traffic"]["entry"])
    out = entry(cell, seed, seconds, trace, devices, t_start, model_step_hook=model_step_hook)
    run = out["run"]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    correct, checks = judge(cell, out, device)
    result = {"correct": correct, "attempted": run["steps"],
              "failed": 0 if checks.get("not_ok", {}).get("value", 0.0) == 0.0 else run["steps"],
              "metrics": per_layer(cell, run) if trace else end_to_end(cell, run),
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                  else "cpu"),
                         "count": cell["chips"],
                         "memory_peak_bytes": run["memory_peak_bytes"]}}
    if trace:
        tr = run["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = tracing.breakdown(tr)
    result["checks"] = checks
    return result, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result, run = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; nothing it runs may load "
              "jax, jaxlib, flax or hnumo_tpu", file=sys.stderr)
        return 1
    print(f"portbench: {args.workload} seed {args.seed}: {run['steps']} steps in "
          f"{run['wall_s']!r} s, set-up {run['setup_s']!r} s "
          f"({', '.join(f'{k} {v!r}' for k, v in run['setup_parts'].items())}), step p95 "
          f"{stats.percentile(run['step_ms'], 95.0)!r} ms, "
          f"{run.get('bytes_written', 0)} bytes written", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
