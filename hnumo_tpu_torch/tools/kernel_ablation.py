"""What limits the four streaming kernels of hnumo_tpu_torch on a GPU: the two
barotropic volume kernels and the fused stage's face and update kernels.

    python3 hnumo_tpu_torch/tools/kernel_ablation.py [--kernels NAME ...]
        [--grids 64 256] [--steps N] [--out FILE]

Needs one CUDA device and nvcc. Builds `ops/csrc/btp_volume.cu`,
`btp_volume_uni.cu`, `btp_faces.cu` and `btp_update.cu` (or those named by
`--kernels`) three times each — as they are, with `BTP_ABLATE=1` (the
contractions compiled out: loads, pointwise physics and stores only, the
memory-only time) and with `BTP_ABLATE=2` (every global read replaced by a
value computed from the thread index, stores kept: the compute-only time) —
and times all of them in one process on the double-gyre configuration of
`chip_smoke.py` (f32, p=4, viscous, flat bottom): CUDA events around launches
queued ahead of the device, rotating over operand sets larger than the L2
("cold"). The ablated builds compute wrong numbers on purpose; only the
unablated build is held against the plain version (by `chip_smoke.py`).
Order per grid and kernel: full, memory-only, compute-only, full again.
`--steps N` also drives N baroclinic steps of the fused path (after one
untimed step) at each grid through `Model.run`, as `chip_smoke.py` does.
`chip_smoke.py` takes the same readings among its phases; this script takes
them alone and back to back, and so also serves to time two checkouts in
turns on one card (run it from each).

Prints one JSON line per kernel and grid, then the card's name and power
limit and what ptxas said of each build; `--out` also writes them to a file.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402

VARIANTS = (("full", ()),) + tuple((name, (define,)) for name, define in cs.ABLATIONS)
KERNELS = ("btp_volume", "btp_volume_uni", "btp_faces", "btp_update")


def time_variants(launch, sets, n):
    """{variant: device ms per launch}, the unablated build once more at the end."""
    from hnumo_tpu_torch.ops._build import variant

    out = {}
    for name, defines in VARIANTS + (("full_again", ()),):
        with variant(*defines):
            out[name] = cs.time_launches(launch, sets, n, device_only=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS))
    ap.add_argument("--grids", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 2

    from hnumo_tpu_torch.model import Model
    from hnumo_tpu_torch.ops import _build
    from hnumo_tpu_torch.ops import btp_volume as bv

    for _, defines in VARIANTS:     # the sources of a variant side by side
        with _build.variant(*defines):
            _build.build_libraries(args.kernels)

    wrappers = cs.kernel_wrappers()
    lines = []
    for nel in args.grids:
        n = 60 if nel <= 64 else 20
        if "btp_volume" in args.kernels:
            m = Model(cs.main_path_config(nel, "float32"))
            kw = cs.volume_kwargs(m.static)
            sets = cs.cold_sets(cs.volume_operands(m, seed=11), most=6 if nel <= 64 else 2)
            vol_ops = m.vol_ops
            before = bv.btp_volume_cuda.launches
            t = time_variants(lambda *o: bv.btp_volume_cuda(vol_ops, *o, **kw), sets, n)
            bv.btp_volume_cuda.launches = before
            lines.append({"kernel": "btp_volume", "grid": nel, "bound_ms":
                          cs.volume_bound(m)["bound_ms"], **t})
            del m, sets, vol_ops
            torch.cuda.empty_cache()

        fused = [k for k in args.kernels if k != "btp_volume"]
        if fused or args.steps:
            m = Model(cs.fused_config(nel, "float32"))
            calls = cs.fused_kernel_calls(m)
            bounds = cs.fused_bounds(m)
            for name in fused:
                kernel, _, sets = calls[name]
                before = wrappers[name].launches
                t = time_variants(kernel, sets, n)
                wrappers[name].launches = before
                lines.append({"kernel": name, "grid": nel,
                              "bound_ms": bounds[name]["bound_ms"], **t})
            del calls
            torch.cuda.empty_cache()
            if args.steps:
                run, _ = cs.drive(m, warm=1, steps=args.steps)
                lines.append({"path": "fused", "grid": nel, "steps": args.steps,
                              "ms_per_step": run["ms_per_step"],
                              "gp_steps_per_s": run["gp_steps_per_s"]})
            del m
            torch.cuda.empty_cache()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    text = "\n".join(json.dumps(line) for line in lines) + "\n" + smi + "\n"
    for name in args.kernels:
        for vname, defines in VARIANTS:
            with _build.variant(*defines):
                text += f"ptxas {name} {vname}: " + "; ".join(_build.resource_usage(name)) + "\n"
    print(text, end="")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
