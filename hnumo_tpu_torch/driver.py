"""Run driver: time loop with periodic snapshots/diagnostics + restart + CLI.

Counterpart of hnumo_tpu/driver.py, writing the same files. Replaces the
reference runtime layer (src/amain.F90:12-73, src/mod_time_loop.F90:26-285):
snapshot-0 write, restart branch, conservation baseline, the
while(time < time_final) loop with periodic output, RHS timing accumulation
dumped to time.csv, and the final mlswe_FIN.txt summary (the CI golden-file
contract). Snapshots are written between steps only, and the state is read
back from the device once a step (its `ok` flag), as in the JAX package.

CLI:  python -m hnumo_tpu_torch <numo3d.in> [--outdir DIR] [--f32] [--cpu] [--quiet]
(on a CUDA device unless --cpu is given).
"""
from __future__ import annotations

import math
import os
import time as _time

from .io import diagnostics as diag
from .io import snapshots as snap


class Runner:
    def __init__(self, model, outdir="."):
        self.model = model
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        cfg = model.cfg
        # absolute step count (reference ntime=ceiling(time_final/dt),
        # src/mod_time_loop.F90:63; restart resumes at itime=irestart_file_number)
        self.ntime = math.ceil(cfg.t_final / cfg.dt)
        self.irestart = max(1, round(cfg.t_restart / cfg.dt))
        self.rhs_time = 0.0
        self.mass0 = None

    def _write_snapshot(self, state, itime):
        cfg = self.model.cfg
        if not cfg.dump_data:
            return
        if cfg.out_type == "nc":
            snap.write_nc(self.model, state, itime, outdir=self.outdir)
        elif cfg.out_type == "vtk":
            from .io.vtk import write_vtk

            write_vtk(self.model, state, itime, outdir=self.outdir,
                      fmt=cfg.format_vtk)
            # restart needs a readable prognostic snapshot alongside VTK
            snap.write_txt(self.model, state, itime, outdir=self.outdir)
        else:
            snap.write_txt(self.model, state, itime, outdir=self.outdir)

    def run(self, state=None, quiet=False):
        """Step from `state` (default: the initial state, or the snapshot
        named by the restart settings) to time_final; returns the final
        state and its diagnostic summary."""
        m = self.model
        cfg = m.cfg
        itime = 0
        if not quiet:
            # run-config banner (reference src/print_header.F90)
            print(diag.print_header(m, flag=0, numproc=1))

        if state is None:
            if cfg.time_initial > 0:
                # restart branch (reference src/mod_time_loop.F90:122-148)
                itime = cfg.irestart_file_number
                ext = ".nc" if cfg.out_type == "nc" else ""
                path = os.path.join(self.outdir, f"mlswe{itime:04d}{ext}")
                data = snap.read_nc(path) if cfg.out_type == "nc" else snap.read_txt(path)
                state = snap.restore_state(m, data, t=cfg.t_initial)
            else:
                state = m.state0
                self._write_snapshot(state, 0)

        self.mass0 = diag.compute_mass(m, state)
        t_wall0 = _time.perf_counter()
        with open(os.path.join(self.outdir, "mass_mlswe.cons"), "a") as mass_log:
            while itime < self.ntime:
                itime += 1
                t0 = _time.perf_counter()
                state = m.step(state)
                if not bool(state.ok):   # forces sync, matching reference fail-stop
                    raise RuntimeError(
                        f"Negative mass in thickness (itime={itime}) — aborting, "
                        "as the reference does (src/mod_splitting.F90:74-77)")
                self.rhs_time += _time.perf_counter() - t0

                if itime % self.irestart == 0 or itime == self.ntime:
                    self._write_snapshot(state, itime)
                    s = diag.summary(m, state, self.mass0)
                    mass_log.write(f"{itime:8d} " +
                                   " ".join(f"{v:24.16e}" for v in s["mass"]) + "\n")
                    if cfg.lprint_diagnostics and not quiet:
                        print(diag.print_summary(s, itime, cfg.dt, cfg.dt_btp_eff,
                                                 cfg.time_scale))
        wall = _time.perf_counter() - t_wall0

        # final summary + FIN file (reference print_diagnostics idone=1 path)
        s = diag.summary(m, state, self.mass0)
        diag.write_fin(os.path.join(self.outdir, "mlswe_FIN.txt"), s)
        with open(os.path.join(self.outdir, "time.csv"), "a") as f:
            f.write(f"{self.rhs_time:.6f}, {wall:.6f}\n")
        if not quiet:
            print(" **Simulation Finished**")
            print(f"steps={itime} wall={wall:.2f}s rhs_time={self.rhs_time:.2f}s")
            print(diag.print_header(m, flag=1, numproc=1))
        return state, s


def main(argv=None):
    """Run a namelist to its end; returns (runner, final state, summary)."""
    import argparse

    from .config import config_from_namelist
    from .model import Model

    p = argparse.ArgumentParser(prog="hnumo_tpu_torch",
                                description="PyTorch/CUDA multilayer SWE DG solver")
    p.add_argument("input", help="numo3d.in namelist file")
    p.add_argument("--outdir", default=".")
    p.add_argument("--mesh", default=None,
                   help="PYxPX device mesh; only 1x1 (one device) is supported")
    p.add_argument("--f32", action="store_true", help="run in float32")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch path on the CPU (default: the CUDA device)")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    if args.mesh is not None:
        py, px = (int(v) for v in args.mesh.lower().split("x"))
        if (py, px) != (1, 1):
            raise NotImplementedError(
                f"--mesh {args.mesh}: domain decomposition is not ported yet "
                "(ROADMAP.md, queue 1, item 7); run on one device")

    overrides = {"dtype": "float32"} if args.f32 else {}
    cfg = config_from_namelist(args.input, **overrides)
    model = Model(cfg, device="cpu" if args.cpu else None)
    runner = Runner(model, outdir=args.outdir)
    state, summ = runner.run(quiet=args.quiet)
    return runner, state, summ
