"""What limits the CUDA kernels of hnumo_tpu_torch on a GPU: the two
barotropic volume kernels, the fused stage's face and update kernels and the
whole-solve megakernel.

    python3 hnumo_tpu_torch/tools/kernel_ablation.py [--kernels NAME ...]
        [--grids 64 256] [--steps N] [--out FILE]
    python3 hnumo_tpu_torch/tools/kernel_ablation.py --kernels btp_mega --grids 25 32

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
`btp_mega` (`ops/csrc/btp_mega.cu`, not in the default list) is one launch
per barotropic solve, timed at each grid through `ops.mega.mega_launch` on
the same configuration with `mega="on"` (f32, p=4, viscous, 100 stages; its
working set stays in the L2, so it is timed hot): full, memory-only,
compute-only (no global reads after the first), barrier-only
(`BTP_ABLATE=3`: the 100 stages left empty but for their grid barriers),
grid-barrier (`BTP_ABLATE=4`: the resident route's stages ordered by one grid
barrier each instead of the neighbours' counters) and full again. Only the
functions that the megakernel's wrapper had before its redesign are called,
so the script also times that older kernel when it is run from a checkout of
it with the same switches patched in.
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
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from hnumo_tpu_torch.tools._measure import (card, fused_bounds, mega_bound,  # noqa: E402
                                            volume_bound)

VARIANTS = (("full", ()),) + tuple((name, (define,)) for name, define in cs.ABLATIONS)
KERNELS = ("btp_volume", "btp_volume_uni", "btp_faces", "btp_update")
MEGA_VARIANTS = (("full", ()),) + tuple((name, (define,)) for name, define in cs.MEGA_ABLATIONS)


def time_variants(launch, sets, n, variants=VARIANTS):
    """{variant: device ms per launch}, the unablated build once more at the end."""
    from hnumo_tpu_torch.ops._build import variant

    out = {}
    for name, defines in variants + (("full_again", ()),):
        with variant(*defines):
            out[name] = cs.time_launches(launch, sets, n, device_only=True)
    return out


def time_mega(nel, n=20):
    """The megakernel's variants at an nel x nel grid (MEGA_VARIANTS): one
    launch = one f32 p=4 solve (`mega="on"`) on fixed operands, accumulating
    into one set of accumulators. Only functions the megakernel's wrapper
    had before its redesign are called (see the module's note)."""
    from hnumo_tpu_torch.model import Model
    from hnumo_tpu_torch.ops import mega

    counters = dict(vars(mega.barotropic_solve_mega_cuda))
    m = Model(cs.main_path_config(nel, "float32", mega="on"))
    _, qb, qp, coup = cs.perturbed_inputs(m, seed=13)
    E, (ngl, nq) = nel * nel, m.g.psiq.shape
    opts = dict(dtype=qb.dtype, device=qb.device)
    op = mega.solve_operands(m.static, m.g, coup, qb, qp, m.mega_ops)
    acc = mega.new_accumulators(E, ngl, nq, **opts)
    bufs = mega.new_state_buffers(E, ngl, **opts)
    t = time_variants(lambda: mega.mega_launch(m.static, m.mega_ops, op, acc, *bufs), [()], n,
                      MEGA_VARIANTS)
    vars(mega.barotropic_solve_mega_cuda).update(counters)   # timing launches are not the path's
    line = {"kernel": "btp_mega", "grid": nel, "bound_ms": mega_bound(m)["bound_ms"], **t}
    layout = getattr(mega, "btp_mega_layout", None)     # absent before the redesign
    if layout is not None:
        line["layout"] = layout(torch.float32, E, ngl, nq)
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", nargs="+", choices=KERNELS + ("btp_mega",),
                    default=list(KERNELS))
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

    for _, defines in MEGA_VARIANTS:     # the sources of a variant side by side
        with _build.variant(*defines):
            _build.build_libraries([k for k in args.kernels
                                    if k == "btp_mega" or defines in dict(VARIANTS).values()])

    wrappers = cs.kernel_wrappers()
    lines = []
    for nel in args.grids:
        n = 60 if nel <= 64 else 20
        if "btp_mega" in args.kernels:
            lines.append(time_mega(nel))
            torch.cuda.empty_cache()
        if "btp_volume" in args.kernels:
            m = Model(cs.main_path_config(nel, "float32"))
            kw = cs.volume_kwargs(m.static)
            sets = cs.cold_sets(cs.volume_operands(m, seed=11), most=6 if nel <= 64 else 2)
            vol_ops = m.vol_ops
            before = bv.btp_volume_cuda.launches
            t = time_variants(lambda *o: bv.btp_volume_cuda(vol_ops, *o, **kw), sets, n)
            bv.btp_volume_cuda.launches = before
            lines.append({"kernel": "btp_volume", "grid": nel, "bound_ms":
                          volume_bound(m)["bound_ms"], **t})
            del m, sets, vol_ops
            torch.cuda.empty_cache()

        fused = [k for k in args.kernels if k not in ("btp_volume", "btp_mega")]
        if fused or args.steps:
            m = Model(cs.fused_config(nel, "float32"))
            calls = cs.fused_kernel_calls(m)
            bounds = fused_bounds(m)
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

    usage = []
    for name in args.kernels:
        for vname, defines in MEGA_VARIANTS if name == "btp_mega" else VARIANTS:
            with _build.variant(*defines):
                usage.append((f"{name} {vname}", _build.resource_usage(name)))
    return report(lines, usage, args.out)


def report(lines, usage, out) -> int:
    """Print the JSON lines, the card's name and power limit and what ptxas
    said of each build; also write them to `out` when given."""
    smi = card()
    text = "\n".join(json.dumps(line) for line in lines) + "\n" + smi + "\n"
    text += "".join(f"ptxas {label}: " + "; ".join(u) + "\n" for label, u in usage)
    print(text, end="")
    if out:
        pathlib.Path(out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
