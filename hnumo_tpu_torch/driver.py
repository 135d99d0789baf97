"""Run driver: time loop with periodic snapshots/diagnostics + restart + CLI.

Counterpart of hnumo_tpu/driver.py, writing the same files. Replaces the
reference runtime layer (src/amain.F90:12-73, src/mod_time_loop.F90:26-285):
snapshot-0 write, restart branch, conservation baseline, the
while(time < time_final) loop with periodic output, RHS timing accumulation
dumped to time.csv, and the final mlswe_FIN.txt summary (the CI golden-file
contract). Snapshots are written between steps only, and the state is read
back from the device once a step (its `ok` flag), as in the JAX package.

Under a domain decomposition (`--mesh PYxPX`) every rank steps its block;
the state is gathered to rank 0 at each output point, and rank 0 alone
prints and writes the files, which are those of a serial run.

CLI:  python -m hnumo_tpu_torch <numo3d.in> [--outdir DIR] [--mesh PYxPX]
      [--backend nccl|gloo] [--f32] [--cpu] [--quiet]
(on a CUDA device unless --cpu is given). With --mesh, under torchrun
(`torchrun --nproc-per-node N -m hnumo_tpu_torch numo3d.in --mesh PYxPX`)
each process joins the group as one rank; started by hand, the command
starts the py*px ranks itself (parallel/launch.py): NCCL with a GPU per rank
when the host has that many, gloo on the CPU under --cpu, and gloo with the
halos staged through host memory when `--backend gloo` is given on fewer
GPUs (ranks then share a GPU); anything else raises.
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
        self.nproc = 1 if model.decomp is None else model.decomp.size

    def _write_snapshot(self, state, itime):
        """`state`: the whole grid's (gathered), on the writing rank."""
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
        state and its diagnostic summary (the summary on the writing rank
        only, None on the others; the state is the model's block)."""
        m = self.model
        cfg = m.cfg
        writer = m.is_writer
        quiet = quiet or not writer
        itime = 0
        if not quiet:
            # run-config banner (reference src/print_header.F90)
            print(diag.print_header(m, flag=0, numproc=self.nproc))

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
                whole = m.gather(state)
                if writer:
                    self._write_snapshot(whole, 0)

        whole = m.gather(state)
        if writer:
            self.mass0 = diag.compute_mass(m, whole)
        t_wall0 = _time.perf_counter()
        mass_log = (open(os.path.join(self.outdir, "mass_mlswe.cons"), "a")
                    if writer else None)
        try:
            while itime < self.ntime:
                itime += 1
                t0 = _time.perf_counter()
                state = m.step(state)
                # forces sync, matching reference fail-stop (the flag is
                # and-reduced over the blocks: every rank stops together)
                if not bool(state.ok):
                    raise RuntimeError(
                        f"Negative mass in thickness (itime={itime}) — aborting, "
                        "as the reference does (src/mod_splitting.F90:74-77)")
                self.rhs_time += _time.perf_counter() - t0

                if itime % self.irestart == 0 or itime == self.ntime:
                    whole = m.gather(state)
                    if not writer:
                        continue
                    self._write_snapshot(whole, itime)
                    s = diag.summary(m, whole, self.mass0)
                    mass_log.write(f"{itime:8d} " +
                                   " ".join(f"{v:24.16e}" for v in s["mass"]) + "\n")
                    if cfg.lprint_diagnostics and not quiet:
                        print(diag.print_summary(s, itime, cfg.dt, cfg.dt_btp_eff,
                                                 cfg.time_scale))
        finally:
            if mass_log is not None:
                mass_log.close()
        wall = _time.perf_counter() - t_wall0

        # final summary + FIN file (reference print_diagnostics idone=1 path)
        whole = m.gather(state)
        if not writer:
            return state, None
        s = diag.summary(m, whole, self.mass0)
        diag.write_fin(os.path.join(self.outdir, "mlswe_FIN.txt"), s)
        with open(os.path.join(self.outdir, "time.csv"), "a") as f:
            f.write(f"{self.rhs_time:.6f}, {wall:.6f}\n")
        if not quiet:
            print(" **Simulation Finished**")
            print(f"steps={itime} wall={wall:.2f}s rhs_time={self.rhs_time:.2f}s")
            print(diag.print_header(m, flag=1, numproc=self.nproc))
        return state, s


def _local_backend(nranks: int, cpu: bool, backend: str | None) -> str:
    """The backend of ranks this command starts itself: the one asked for,
    else gloo on the CPU and NCCL where the host has a GPU per rank.
    Raises where that cannot serve, instead of switching."""
    import torch

    if cpu:
        if backend not in (None, "gloo"):
            raise ValueError(f"--cpu runs over gloo, not {backend}")
        return "gloo"
    ngpu = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if ngpu == 0:
        raise RuntimeError("--mesh without --cpu needs CUDA devices, and none is "
                           "available; add --cpu to run the ranks on the CPU")
    backend = backend or "nccl"
    if backend == "nccl" and ngpu < nranks:
        raise RuntimeError(
            f"--mesh asks for {nranks} ranks; NCCL needs a GPU per rank and this "
            f"host has {ngpu}. Use torchrun across hosts, or --backend gloo to "
            "share the GPUs (halos staged through host memory)")
    return backend


def main(argv=None):
    """Run a namelist to its end; returns (runner, final state, summary).
    A command that started the ranks of a decomposed run itself returns
    (None, None, None) once they have finished (rank 0 wrote the files and
    its output is printed)."""
    import argparse
    import sys

    from .config import config_from_namelist
    from .model import Model

    p = argparse.ArgumentParser(prog="hnumo_tpu_torch",
                                description="PyTorch/CUDA multilayer SWE DG solver")
    p.add_argument("input", help="numo3d.in namelist file")
    p.add_argument("--outdir", default=".")
    p.add_argument("--mesh", default=None,
                   help="PYxPX domain decomposition, one rank per block "
                        "(default: one device)")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="process-group backend under --mesh (default: nccl on "
                        "GPUs, gloo on the CPU)")
    p.add_argument("--f32", action="store_true", help="run in float32")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch path on the CPU (default: the CUDA device)")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    overrides = {"dtype": "float32"} if args.f32 else {}
    cfg = config_from_namelist(args.input, **overrides)

    decomp = None
    if args.mesh is not None:
        py, px = (int(v) for v in args.mesh.lower().split("x"))
        if (py, px) != (1, 1):
            from .parallel.sharding import block_bounds, init_decomposition

            if not cfg.lread_external_grid:
                # refused before any rank starts (an external mesh's size is
                # known once it is read: each rank checks it then)
                block_bounds(cfg.nely, py, 0)
                block_bounds(cfg.nelx, px, 0)
            if "RANK" not in os.environ:
                # started by hand: start the ranks, each this same command
                from .parallel.launch import run_command

                argv = sys.argv[1:] if argv is None else list(argv)
                backend = _local_backend(py * px, args.cpu, args.backend)
                logs = run_command(["-m", "hnumo_tpu_torch", *argv, "--backend", backend],
                                   py * px)
                print(logs[0], end="")
                return None, None, None
            decomp = init_decomposition((py, px), backend=args.backend,
                                        device="cpu" if args.cpu else None)

    model = Model(cfg, device="cpu" if args.cpu else None, decomp=decomp)
    runner = Runner(model, outdir=args.outdir)
    state, summ = runner.run(quiet=args.quiet)
    return runner, state, summ
