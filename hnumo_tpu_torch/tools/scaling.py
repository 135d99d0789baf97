"""Strong and weak scaling of the decomposed step, graphed over NCCL, one GPU
per rank.

    python3 hnumo_tpu_torch/tools/scaling.py [--gpus 1 2 4] [--steps 10] \
        [--out chiprun_out/scaling.jsonl]

The counterpart of the JAX package's tools/overlap_probe.py (strong
scaling) and tools/weak_scaling.py (weak scaling), which time its sharded
step on a fake multi-device CPU mesh. Here every rank is a process with a
GPU of its own (parallel/launch.start_function, backend "nccl"), and its
model steps through the captured CUDA graph that is the default over NCCL.
The configuration is the JAX package's bench basin (the double gyre, f32,
p=4, 2 layers, dt = 500 s * 25 / nel) on the fused path (kernels A, F and
U), whose step is the same on every block:

- strong: 256x256 elements on 1, 2 (split 1x2) and 4 GPUs (2x2);
- weak: 128x128 elements per rank: 128x128 on 1 GPU, 128x256 on 2 (1x2),
  256x256 on 4 (2x2).

One GPU runs the serial model (a 1x1 decomposition posts no exchange) in a
rank process of its own. Each rank takes WARM_STEPS untimed steps (the
first captures the graph), then `--steps` steps timed between barriers.
One JSON line per run: ms/step of every rank (the run's is the slowest),
grid-point-steps/s as bench.py counts them, the efficiency against one GPU
(strong: t1 / (n * tn); weak: t1 / tn), the exchange calls per step, and the
card's name and power limit as nvidia-smi gives them. A run needs as many
GPUs as ranks and raises where the host shows fewer: two ranks never share
a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

if __package__ in (None, ""):          # run as a script
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

# the split of each GPU count, and the (nely, nelx) grids
SHAPES = {1: (1, 1), 2: (1, 2), 4: (2, 2)}
STRONG_NEL = 256
WEAK_NEL = 128         # elements per rank along each axis
WARM_STEPS = 2
RANK_TIMEOUT = 600.0


def bench_config(nely: int, nelx: int):
    """The bench basin on the fused path, its time step scaled by the
    elements along y (bench.py's `dt = 500 * 25 / nel`) whatever the grid."""
    from hnumo_tpu_torch.config import Config

    scale = 25.0 / nely
    return Config(nelx=nelx, nely=nely, nopx=4, nopy=4,
                  xdims=(0.0, 2.0e6 * nelx / nely), ydims=(0.0, 2.0e6), nlayers=2,
                  dt=500.0 * scale, dt_btp=25.0 * scale, time_final=1e9,
                  test_case="double_gyre", f0=9.3e-5, beta=2.0e-11, botfr=1,
                  cd_mlswe=1.0e-7, method_visc=2, visc_mlswe=100.0, dtype="float32",
                  mega="off", fused_tail="on")


def runs(gpus) -> list[tuple[str, int, tuple[int, int], tuple[int, int]]]:
    """(kind, GPUs, split, (nely, nelx)) of every run, strong then weak.
    Raises for a GPU count without a split."""
    bad = [n for n in gpus if n not in SHAPES]
    if bad:
        raise ValueError(f"GPU counts must be among {sorted(SHAPES)}, got {bad}")
    out = []
    for n in gpus:
        out.append(("strong", n, SHAPES[n], (STRONG_NEL, STRONG_NEL)))
    for n in gpus:
        py, px = SHAPES[n]
        out.append(("weak", n, SHAPES[n], (WEAK_NEL * py, WEAK_NEL * px)))
    return out


def check_gpus(gpus, available: int) -> None:
    """Raise unless the host shows a GPU for every rank of every run."""
    need = max(gpus)
    if available < need:
        raise RuntimeError(
            f"a run on {need} GPUs needs {need} CUDA devices, this host shows "
            f"{available}: the ranks would share a card, which is not scaling")


def rank_run(dec, grid, steps):
    """A rank's side: its block's model, graphed; WARM_STEPS steps, then
    `steps` timed between barriers. Returns ms/step and the exchange calls
    of a step: counted in the first step, which makes them twice (the eager
    warm-up and the capture); a replay runs no Python and counts none."""
    import torch

    from hnumo_tpu_torch.model import Model

    cfg = bench_config(*grid)
    m = Model(cfg, decomp=None if dec.size == 1 else dec)
    if m.step_impl != "graph" or not m.static.fused_tail or m.static.mega:
        raise RuntimeError(f"rank {dec.rank}: expected the graphed fused path")
    s = m.run(m.state0, WARM_STEPS)
    calls = dec.exchange_calls / 2
    torch.cuda.synchronize()
    dec.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = m.run(s, steps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    return {"ms_per_step": ms, "exchange_calls_per_step": calls,
            "block": list(m.g.wjac.shape[:2]), "ok": bool(s.ok)}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gpus", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    if args.steps < 1:
        raise ValueError(f"--steps must be positive, got {args.steps}")
    plan = runs(args.gpus)
    import torch

    check_gpus(args.gpus, torch.cuda.device_count() if torch.cuda.is_available() else 0)
    from hnumo_tpu_torch.parallel.launch import run_function

    smi = card()
    base = {}
    for kind, n, shape, grid in plan:
        t0 = time.perf_counter()
        ranks = run_function("hnumo_tpu_torch.tools.scaling:rank_run", shape, "nccl",
                             device="cuda", kwargs=dict(grid=grid, steps=args.steps),
                             timeout=RANK_TIMEOUT)
        if not all(r["ok"] for r in ranks):
            raise RuntimeError(f"{kind} {n} GPUs: a rank's state is not ok")
        ms = max(r["ms_per_step"] for r in ranks)
        cfg = bench_config(*grid)
        gp = grid[0] * grid[1] * (2 * cfg.nopx + 1) ** 2 * cfg.nlayers
        base.setdefault(kind, ms if n == 1 else None)
        t1 = base[kind]
        eff = None if t1 is None else (t1 / (n * ms) if kind == "strong" else t1 / ms)
        line = {"kind": kind, "gpus": n, "split": list(shape), "grid": list(grid),
                "block": ranks[0]["block"], "steps": args.steps,
                "ms_per_step": ms, "ms_per_step_ranks": [r["ms_per_step"] for r in ranks],
                "gp_steps_per_s": gp / ms * 1e3, "efficiency_vs_1_gpu": eff,
                "exchange_calls_per_step": ranks[0]["exchange_calls_per_step"],
                "step_impl": "graph", "transport": "nccl" if n > 1 else "none",
                "wall_s": time.perf_counter() - t0, "card": smi}
        print(json.dumps(line), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
