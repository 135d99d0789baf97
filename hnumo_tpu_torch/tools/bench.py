"""Time the port's graphed baroclinic step, one barotropic path at a time.

    python -m hnumo_tpu_torch.tools.bench [--nel 32] [--nop 4] [--steps 10] \
        [--repeats 5] [--variant default] [--f64] [--out FILE]
    python -m hnumo_tpu_torch.tools.bench --table [--grids 25 32 64 128 256 16:8 32:8] \
        [--variants NAME ...] [--steps 10] [--repeats 5] [--out FILE]
    python -m hnumo_tpu_torch.tools.bench --spans ...  # and the step's launches by span
    python -m hnumo_tpu_torch.tools.bench --cpu ...   # eager on the CPU, for the tests

The counterpart of the JAX package's bench.py (one grid, one JSON line of
grid-point-steps/s) and of its tools/ab_bench.py (ms/step of each
barotropic path variant in turn). The configuration is bench.py's basin
(`bench_config`): the double gyre in a 2000 km square, 2 layers, f32,
SSP(5,3), linear bottom drag, nodal-family viscosity, with bench.py's time
step `dt = 500 s * (25/nel) * (4/nop)^2` and `dt_btp = dt/20` (N_btp = 20:
200 barotropic stages a step). A variant is a named set of `Config` fields:

    default  none changed: what core/init.py dispatches (the megakernel up
             to 1024 elements at nop <= 7, else the per-stage path)
    mega     mega="on": the whole-solve megakernel at any size (raises at
             nop > 7)
    stage    mega="off": the per-stage path, general volume kernel
    uni      mega="off", uni_volume="on": the per-stage path, uniform-geometry
             volume kernel
    fused    mega="off", fused_tail="on": kernels A, F, U every stage
    flat     mega="off", batched_faces="on": per stage, one flat face axis
    dir      mega="off", batched_faces="off": per stage, faces per direction

Every variant but `default` and `mega` says mega="off": under 1024
elements the megakernel is asked first and would take the step whatever
else is set. Under "auto" the per-stage path takes the per-direction faces
above 8192 elements, so at 128x128 and 256x256 `stage` and `dir` are one
path; each run prints the face pipeline it took. The port counts a brick
as uniform by a tolerance that grows with the elements across
(core/init.py), so `uni` and `fused` run at 256x256, where the JAX
package's constant tolerance would quietly leave them; the tool times the
port, and follows the port's dispatch. ab_bench.py's `xla` and `bf_xla`
(the plain versions, no yardstick and on no path where a card is present),
`ss_on`/`ss_off` and `mega_bf16` (scan_stages and bf16 stages, TPU plumbing
the port does not have) are not ported. An unknown variant raises, and so
does a variant outside its envelope (through the Config and core/init.py
checks); the tool never times another path in its place.

Each (grid, nop, variant) run builds `Model(cfg)` on the card (step_impl
"graph"), takes one untimed step (kernel build, eager warm-up, capture),
then `--repeats` windows of `--steps` steps, each window between two
`torch.cuda.synchronize()`. As in bench.py the steps are `Model.step` in a
loop, with no host read between them. The runs of one grid are built
together and their windows taken in turns (A, B, A, B, ...); each grid's
models are dropped before the next grid's are built. Every run is held to
its gates, and a failed gate raises (nothing is caught):

- its captured graph's kernel nodes (`Model.keep_graph`) are exactly its
  variant's kernels a step (`expected_kernels`: 2 btp_mega, or 200
  btp_volume, or 200 btp_volume_uni, or 200 each of A, F, U at p=4), and
  none of the other three; the flat and dir variants took their face
  pipeline;
- after the windows `ok` is true, the fields are finite and the relative
  total-mass change from the initial state is at most 1e-6.

It reports the median and every window's ms/step, the spread ((max - min)
/ median), grid-point-steps/s as bench.py counts them (nelem * nq^2 *
nlayers * steps / wall, nq = 2p+1) from the median, the first step's
seconds, the model's peak device memory, for each window the host's time
in the step calls (the enqueue: a window whose steps the host cannot
enqueue faster than the device runs them is host-bound) and the SM clock
after it, and from one profiled replay the device busy ms and each
kernel's device ms per launch beside its bound (tools/_measure.py). With
--spans (on the card) each record also holds `kernels_by_span`: one eager
step's device activities by the span of the port that launched them
(_measure.kernels_by_span; the eager step's launches are held to the captured
graph's nodes, name for name), and without --table its table goes to stderr.

Without --table the tool works as bench.py: its last line on stdout is
bench.py's four keys, `vs_baseline` against the same BASELINE_GPS (the JAX
package's f64 single-core CPU rate, not a device's), and a `# device=...`
line on stderr names the card and its power limit. With --table it prints
one JSON line per run, with the card, the host load, torch's and CUDA's
versions; without --grids it runs the grids of the port's roadmap (p=4:
25, 32, 64, 128, 256 elements a side; p=8: 16, 32), each with every
variant its envelope admits, flat and dir at 128 and 256 only. --out
appends the lines (every run's whole record) to a file. Without a CUDA
device the tool raises unless --cpu asks for the CPU, where the models step
eagerly and the plain versions' call counters prove the path.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time
from pathlib import Path

import torch

from hnumo_tpu_torch.config import Config
from hnumo_tpu_torch.core.init import MEGA_AUTO_MAX_ELEMENTS, MEGA_MAX_NOP
from hnumo_tpu_torch.tools._measure import (KERNEL_SYMBOLS, card, gates, graph_kernels,
                                            graph_path_counts, kernels_by_span, path_bounds,
                                            replay_profile, sm_clock_mhz)

BASELINE_GPS = 28.4e3   # bench.py's: the JAX package's f64 single-core CPU rate

VARIANTS = {
    "default": {},
    "mega": dict(mega="on"),
    "stage": dict(mega="off"),
    "uni": dict(mega="off", uni_volume="on"),
    "fused": dict(mega="off", fused_tail="on"),
    "flat": dict(mega="off", batched_faces="on"),
    "dir": dict(mega="off", batched_faces="off"),
}
# the face pipeline each face variant must take
VARIANT_FACES = {"flat": "flat", "dir": "per direction"}
# (elements a side, nop) of --table without --grids; the face variants only
# at FACE_GRIDS (p=4)
TABLE_GRIDS = ((25, 4), (32, 4), (64, 4), (128, 4), (256, 4), (16, 8), (32, 8))
FACE_GRIDS = (128, 256)


def bench_config(nel: int, nop: int = 4, dtype: str = "float32", nelx: int | None = None,
                 **over) -> Config:
    """bench.py's basin (bench.py:53-65), with its time step: `nel` elements
    along y, and along x too unless `nelx` says otherwise (the basin then
    stretches in x to keep the element square; dt follows the elements along
    y). `over` replaces any field (the variants' switches among them)."""
    nelx = nel if nelx is None else nelx
    scale = (25.0 / nel) * (4.0 / nop) ** 2
    kw = dict(nelx=nelx, nely=nel, nopx=nop, nopy=nop,
              xdims=(0.0, 2.0e6 * nelx / nel), ydims=(0.0, 2.0e6), nlayers=2,
              dt=500.0 * scale, dt_btp=25.0 * scale, time_final=1e9,
              test_case="double_gyre", f0=9.3e-5, beta=2.0e-11,
              botfr=1, cd_mlswe=1.0e-7, method_visc=2, visc_mlswe=100.0, dtype=dtype)
    return Config(**{**kw, **over})


def variant_config(nel: int, nop: int, variant: str, dtype: str = "float32",
                   **over) -> Config:
    """`bench_config` with the variant's switches; an unknown variant raises."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; the variants are {sorted(VARIANTS)}")
    return bench_config(nel, nop, dtype, **{**VARIANTS[variant], **over})


def expected_kernels(variant: str, cfg: Config) -> dict:
    """{kernel: launches a step} of the five kernels on the variant's path,
    from the variant and the grid alone (not from the model's dispatch)."""
    stages = 2 * cfg.n_btp * cfg.kstages
    auto_mega = (cfg.nelx * cfg.nely <= MEGA_AUTO_MAX_ELEMENTS and cfg.nopx <= MEGA_MAX_NOP)
    if variant == "mega" or (variant == "default" and auto_mega):
        want = {"btp_mega": 2}
    elif variant == "fused":
        want = dict.fromkeys(("btp_volume_uni", "btp_faces", "btp_update"), stages)
    elif variant == "uni":
        want = {"btp_volume_uni": stages}
    else:
        want = {"btp_volume": stages}
    return {name: want.get(name, 0) for name in KERNEL_SYMBOLS}


def table_plan(grids=TABLE_GRIDS, variants=None) -> list[tuple[int, int, list[str]]]:
    """(nel, nop, variants) of each grid of --table: `variants` where given,
    else every variant the grid's envelope admits (`mega` up to nop 7), the
    face variants at FACE_GRIDS only."""
    plan = []
    for nel, nop in grids:
        names = list(variants) if variants is not None else [
            v for v in VARIANTS
            if not (v == "mega" and nop > MEGA_MAX_NOP)
            and not (v in VARIANT_FACES and nel not in FACE_GRIDS)]
        plan.append((nel, nop, names))
    return plan


def parse_grid(text: str) -> tuple[int, int]:
    """"NEL" (p=4) or "NEL:NOP"."""
    nel, _, nop = text.partition(":")
    return int(nel), int(nop or 4)


def gridpoint_steps_per_s(cfg: Config, steps: int, wall_s: float) -> float:
    """bench.py:94-96: nelem * nq^2 * nlayers * steps / wall, nq = 2p+1."""
    nq = 2 * cfg.nopx + 1
    return cfg.nelx * cfg.nely * nq * nq * cfg.nlayers * steps / wall_s


def host_load() -> dict:
    """The 1-minute load average and the CPU count; warns on stderr, as
    bench.py does, when the load exceeds half the CPUs."""
    load1, ncpu = os.getloadavg()[0], os.cpu_count() or 1
    if load1 > 0.5 * ncpu:
        print(f"# WARNING: host load average {load1:.2f} on {ncpu} CPUs "
              "— concurrent work will contaminate this benchmark", file=sys.stderr)
    return {"load1": load1, "cpus": ncpu}


def _plain_calls() -> dict:
    """{kernel: calls so far} of the five plain versions (eager, on the CPU)."""
    from hnumo_tpu_torch.ops import btp_tail, btp_volume, btp_volume_uni, mega

    fns = {"btp_volume": btp_volume.btp_volume_plain,
           "btp_mega": mega.barotropic_solve_mega_plain,
           "btp_volume_uni": btp_volume_uni.btp_volume_uni_plain,
           "btp_faces": btp_tail.btp_faces_plain, "btp_update": btp_tail.btp_update_plain}
    return {name: fn.calls for name, fn in fns.items()}


def _mega_routes() -> dict:
    from hnumo_tpu_torch.ops.mega import ROUTES, barotropic_solve_mega_cuda

    return {r: getattr(barotropic_solve_mega_cuda, f"launches_{r}") for r in ROUTES}


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def _first_step(variant: str, cfg: Config, cuda: bool) -> dict:
    """The run's model, built and stepped once (untimed by the windows),
    its path proven and its first step's seconds and peak memory read."""
    from hnumo_tpu_torch.model import Model

    label = f"{cfg.nelx}x{cfg.nely} p={cfg.nopx} {variant}"
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    m = Model(cfg, device=None if cuda else "cpu")
    m.keep_graph = cuda
    calls, routes = None if cuda else _plain_calls(), _mega_routes()
    t0 = time.perf_counter()
    s = m.step(m.state0)
    _sync(cuda)
    first_s = time.perf_counter() - t0
    if cuda:
        got = graph_path_counts(graph_kernels(m._graph[0]))
        proof = "the captured graph's kernel nodes"
    else:
        got = {k: n - calls[k] for k, n in _plain_calls().items()}
        proof = "the plain versions' calls in an eager step"
    want = expected_kernels(variant, cfg)
    if got != want:
        raise AssertionError(f"{label}: {proof} are {got}; the {variant} path runs {want}")
    st = m.static
    faces = None if st.mega or st.fused_tail else (
        "flat" if st.batched_faces else "per direction")
    if variant in VARIANT_FACES and faces != VARIANT_FACES[variant]:
        raise AssertionError(f"{label}: took the {faces} faces, not the "
                             f"{VARIANT_FACES[variant]} ones")
    routes = {r: n - routes[r] for r, n in _mega_routes().items()}
    return {"label": label, "variant": variant, "cfg": cfg, "model": m, "state": s,
            "first_step_s": first_s, "kernels": got, "proof": proof, "faces": faces,
            "mega_route": next((r for r, n in routes.items() if n), None),
            "peak_gib": ((torch.cuda.max_memory_allocated() - base) / 2**30
                         if cuda else None)}


def time_in_turns(runs, steps: int, repeats: int, cpu: bool = False,
                  spans: bool = False) -> list[dict]:
    """Each (variant, cfg) of `runs` built and stepped once (`_first_step`),
    then `repeats` windows of `steps` steps of each, in turns; then each
    run's gates and one profiled replay (with `spans`, one profiled eager
    step by span too). Returns a record per run. The models are dropped
    before the return."""
    if steps < 1 or repeats < 1:
        raise ValueError(f"steps and repeats must be positive, got {steps}, {repeats}")
    if spans and cpu:
        raise ValueError("--spans puts the card's activities down to the spans; "
                         "it needs a CUDA device, not --cpu")
    cuda = not cpu
    built = [_first_step(variant, cfg, cuda) for variant, cfg in runs]
    windows, enqueue, clocks = ([[] for _ in built] for _ in range(3))
    for _ in range(repeats):
        for r, w, e, c in zip(built, windows, enqueue, clocks):
            m, s = r["model"], r["state"]
            _sync(cuda)
            t0 = time.perf_counter()
            for _ in range(steps):
                s = m.step(s)
            t1 = time.perf_counter()
            _sync(cuda)
            w.append((time.perf_counter() - t0) / steps * 1e3)
            e.append((t1 - t0) / steps * 1e3)
            if cuda:
                c.append(sm_clock_mhz())
            r["state"] = s
    records = []
    for r, w, e, c in zip(built, windows, enqueue, clocks):
        m, s, cfg = r.pop("model"), r.pop("state"), r.pop("cfg")
        try:
            drift = gates(m, s)
        except AssertionError as err:
            raise AssertionError(f"{r['label']}: {err}") from None
        ms = statistics.median(w)
        bounds = path_bounds(m)
        rec = {"tool": "hnumo_tpu_torch.tools.bench", "variant": r["variant"],
               "switches": VARIANTS[r["variant"]], "nel": [cfg.nely, cfg.nelx],
               "nop": cfg.nopx, "nlayers": cfg.nlayers, "dtype": cfg.dtype,
               "n_btp": m.static.n_btp, "kstages": m.static.kstages, "dt": cfg.dt,
               "dt_btp": cfg.dt_btp, "step_impl": m.step_impl, "faces": r["faces"],
               "mega_route": r["mega_route"], "steps": steps, "repeats": repeats,
               "ms_per_step": ms, "ms_per_step_windows": w, "enqueue_ms_per_step_windows": e,
               "spread": (max(w) - min(w)) / ms,
               "gp_steps_per_s": gridpoint_steps_per_s(cfg, 1, ms / 1e3),
               "first_step_s": r["first_step_s"], "peak_gib": r["peak_gib"],
               "kernels_per_step": {k: n for k, n in r["kernels"].items() if n},
               "path_proven_by": r["proof"], "ok": True, "finite": True,
               "mass_drift": drift,
               "bound_ms": {k: b["bound_ms"] for k, b in bounds.items()},
               "bound_by": {k: b["bound_by"] for k, b in bounds.items()}}
        if cuda:
            prof = replay_profile(m, s, check=False)
            traced, busy = prof["replay_kernels"], prof["replay_device_busy_ms"]
            rec.update({
                "sm_mhz_windows": c, "replay_device_busy_ms": busy,
                "replay_device_activities": prof["replay_device_activities"],
                "replay_kernels_traced": {k: n for k, n in traced.items() if n},
                "kernel_ms_per_launch": {k: t / traced[k] for k, t
                                         in prof["replay_kernel_ms"].items() if traced[k]}})
            if spans:
                rec["kernels_by_span"] = kernels_by_span(m, s)
        else:
            rec["replay_device_busy_ms"] = None
        records.append(rec)
        del m, s
    del built
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    return records


def format_spans(table: dict) -> str:
    """`kernels_by_span`'s table as lines: each span's launches and device
    ms, and its most launched kernel."""
    lines = [f"# {'span':<56} {'launches':>8} {'device ms':>10}  most launched"]
    for path, row in table.items():
        name, n = max(row["kernels"].items(), key=lambda kv: kv[1])
        lines.append(f"# {path:<56} {row['launches']:>8d} {row['device_ms']:>10.4f}  "
                     f"{n} x {name[:60]}")
    total = sum(r["launches"] for r in table.values())
    ms = sum(r["device_ms"] for r in table.values())
    lines.append(f"# {'all':<56} {total:>8d} {ms:>10.4f}")
    return "\n".join(lines)


def _device(cpu: bool) -> dict:
    if cpu:
        return {"device": "cpu", "card": "cpu"}
    return {"device": torch.cuda.get_device_name(0), "card": card()}


def _append(path, records) -> None:
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in records)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nel", type=int, default=32, help="elements per side (bench.py's)")
    ap.add_argument("--nop", type=int, default=4)
    ap.add_argument("--nlayers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10, help="steps of each timed window")
    ap.add_argument("--repeats", type=int, default=5, help="timed windows of each run")
    ap.add_argument("--variant", default="default", help=f"one of {', '.join(VARIANTS)}")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="eager on the CPU (tests)")
    ap.add_argument("--table", action="store_true",
                    help="one JSON line per (grid, nop, variant), ab_bench.py's counterpart")
    ap.add_argument("--grids", nargs="+", metavar="NEL[:NOP]", default=None,
                    help="--table's grids (default 25 32 64 128 256 16:8 32:8)")
    ap.add_argument("--variants", nargs="+", default=None,
                    help="--table's variants (default every one a grid's envelope admits)")
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    ap.add_argument("--spans", action="store_true",
                    help="also put one eager step's device activities down to the spans")
    args = ap.parse_args(argv)
    if not args.table and (args.grids or args.variants):
        raise ValueError("--grids and --variants go with --table; without it say "
                         "--nel, --nop and --variant")
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("the bench times the step on a CUDA device and none is "
                           "available; --cpu runs it eagerly on the CPU (tests)")
    dtype = "float64" if args.f64 else "float32"
    versions = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if not args.table:
        cfg = variant_config(args.nel, args.nop, args.variant, dtype, nlayers=args.nlayers)
        load = host_load()
        rec = {**time_in_turns([(args.variant, cfg)], args.steps, args.repeats,
                               args.cpu, args.spans)[0], **_device(args.cpu),
               "host_load": load, **versions}
        _append(args.out, [rec])
        gps = rec["gp_steps_per_s"]
        print(f"# device={'cpu' if args.cpu else 'gpu'} {rec['device']} | {rec['card']} "
              f"grid={args.nel}x{args.nel} p={args.nop} L={args.nlayers} "
              f"N_btp={rec['n_btp']} ({2 * rec['n_btp'] * rec['kstages']} btp RHS/dt) "
              f"dtype={dtype} variant={args.variant} "
              f"{json.dumps(rec['kernels_per_step'])}: {rec['ms_per_step']:.2f} ms/step "
              f"(median of {args.repeats} x {args.steps} steps, spread "
              f"{rec['spread']:.3f}), first step (build, warm-up, capture) "
              f"{rec['first_step_s']:.1f} s, ok=True", file=sys.stderr)
        if args.spans:
            print(format_spans(rec["kernels_by_span"]), file=sys.stderr)
        print(json.dumps({
            "metric": "dg_gridpoint_steps_per_s",
            "value": round(gps, 1),
            "unit": "grid-points*baroclinic-steps/s/chip",
            "vs_baseline": round(gps / BASELINE_GPS, 2),
        }))
        return 0
    grids = [parse_grid(g) for g in args.grids] if args.grids else TABLE_GRIDS
    for nel, nop, names in table_plan(grids, args.variants):
        runs = [(v, variant_config(nel, nop, v, dtype, nlayers=args.nlayers)) for v in names]
        load = host_load()
        records = [{**r, **_device(args.cpu), "host_load": load, **versions}
                   for r in time_in_turns(runs, args.steps, args.repeats, args.cpu,
                                          args.spans)]
        for r in records:
            print(json.dumps(r), flush=True)
        _append(args.out, records)
    return 0


if __name__ == "__main__":
    sys.exit(main())
