"""The control of `correct`: the plain reference put in the port's place
and computed in the precision below the configuration's (float32 products
in TF32, where the configuration states float32 with TF32 off), read by
the same comparison as the port. Where it does not fail a limit, the
limits cannot tell a sound run from one in the lower precision.

    python3 portbench/control.py --workload NAME --seeds 1 2 3 [--seconds 2] [--out FILE]

For each seed, in one process on the card: one run of the cell's entry
with a short window (the port's readings of that seed, judged as a run
judges them), then the control from the same inputs: the first steps
from the seeded state, and the last step from the port's state before
its last step; beside it the same reference in full float32, which reads
what float32 alone costs. One JSON line per seed. The benchmark's own
runs do not run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    __package__ = "portbench"

import torch  # noqa: E402

from portbench import cells, compare  # noqa: E402
from portbench.run import judge  # noqa: E402
from portbench.state import as_state, ref_config  # noqa: E402


def control_values(cell: dict, out: dict, device, tf32: bool = True) -> dict:
    """The control's numbers: the float32 reference, its products in TF32,
    against the float64 one. With `tf32` False, the float32 reference in
    full float32: a witness of what float32 alone reads."""
    from portbench.reference import Reference, State as RState

    cfg = ref_config(cell["config"]["config"])
    ref = Reference(cfg, device, torch.float64)
    low = Reference(cfg, device, torch.float32, tf32=tf32)
    n = out["start_steps"]
    values = compare.state_gaps(
        "start", low.run(as_state(RState, out["s0_fields"], torch.float32, device), n),
        ref.run(as_state(RState, out["s0_fields"], torch.float64, device), n))
    values.update(compare.state_gaps("last", low.step(out["prev"]), ref.step(out["prev"])))
    written = out.get("written")
    if written is not None:
        # the run layer's numbers under two faults of its own: the snapshot
        # of the step before the last written in its place, and the mass
        # log's layers in the wrong order
        ini = ref.init_fields
        dp_ref = torch.tensor(out["s0_fields"]["dp_ref"], dtype=torch.float64, device=device)
        last = compare.derived(written["state"], dp_ref, ini.alpha, ini.gravity)
        stale = compare.derived(out["prev_of_written"], dp_ref, ini.alpha, ini.gravity)
        values["snapshot"] = compare.snapshot_gap(stale, last)
        wjac = ref.g.wjac_df.double().cpu().numpy()
        mass = [float((wjac * h.reshape(wjac.shape)).sum()) for h in last["h"]]
        values["masslog"] = max(abs(a - b) / abs(b) for a, b in zip(mass[::-1], mass))
    return values


def main(argv=None) -> int:
    from portbench import entries

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = cells.cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.perf_counter()
        out = entries.find(cell["traffic"]["entry"])(cell, seed, args.seconds, False, [device],
                                                     time.perf_counter())
        gc.collect()
        torch.cuda.empty_cache()
        _, program = judge(cell, out, device)
        line = {"workload": args.workload, "seed": seed,
                "program": {k: c["value"] for k, c in program.items()},
                "control": control_values(cell, out, device),
                "witness_f32": control_values(cell, out, device, tf32=False),
                "steps": out["run"]["steps"], "seconds": time.perf_counter() - t}
        del out
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
