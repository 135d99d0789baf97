"""Start the ranks of a decomposed run on this host, as `torchrun` would.

Two uses:
- `run_command(argv, nranks, ...)`: py*px copies of a command (the CLI's
  `python -m hnumo_tpu_torch ... --mesh PYxPX` when it was not started by
  torchrun), each with the environment torchrun gives a rank;
- `run_function("module:function", shape, ...)`: py*px processes that each
  join the group (`init_decomposition`), call `function(dec, **kwargs)` and
  send its return value (anything pickle takes) back; a list in rank order.
  `start_function` returns at once, so that the caller can work while the
  ranks run. The tests and chip_smoke.py drive their decomposed cases
  through these.

The rendezvous is a file in a directory of the caller's (never a fixed
port). Every run is joined with two time limits: a generous start-up limit
(`STARTUP_TIMEOUT`) until every rank has joined the group, which each marks
with a file `ready{rank}` of that directory (`init_decomposition`), and
the caller's `timeout` from then on, so that the caller's limit never pays
for importing torch or for a host under load. A rank that fails or hangs
fails the whole run, and the other ranks, which would wait on it forever,
are killed. Each rank's output goes to a log file of that directory, whose
end is quoted in the error.

`python -m hnumo_tpu_torch.parallel.launch JOB` is a rank's side of
`run_function`.
"""
from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

_PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])
# seconds from the ranks' start until every rank has joined the group
STARTUP_TIMEOUT = 600.0
# seconds the other ranks get to end on their own once one has failed
FAIL_GRACE = 2.0


def _rank_env(rank: int, nranks: int, workdir: Path, pythonpath=()) -> dict:
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(nranks), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(nranks),
               HNUMO_DIST_INIT=f"file://{workdir / 'rendezvous'}",
               HNUMO_READY_FILE=str(workdir / f"ready{rank}"))
    paths = [_PACKAGE_ROOT, *map(str, pythonpath)]
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(paths)
    return env


def _join(procs, logs, ready, timeout: float) -> None:
    """Wait for every rank; on a failure or at a time limit kill the rest
    and raise with the end of the failed ranks' logs, the first seen first
    (after a failure the others get FAIL_GRACE seconds to end on their own,
    so that each rank that fails with it is quoted too). `ready`: each
    rank's mark that it joined the group. Until every rank has marked, the
    limit is STARTUP_TIMEOUT seconds from now; from then, `timeout`."""
    deadline = time.monotonic() + STARTUP_TIMEOUT
    joined, failed, fail_by = False, [], None
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed += [r for r, c in enumerate(codes) if c not in (None, 0)
                       and r not in failed]
            if failed:
                fail_by = fail_by or time.monotonic() + FAIL_GRACE
                if None not in codes or time.monotonic() > fail_by:
                    raise RuntimeError("\n".join(
                        f"rank {r} of {len(procs)} exited with code {codes[r]}:\n"
                        + _tail(logs[r]) for r in failed))
            elif all(c == 0 for c in codes):
                return
            elif not joined and all(m.exists() for m in ready):
                joined = True
                deadline = time.monotonic() + timeout
            elif time.monotonic() > deadline:
                waiting = [r for r, c in enumerate(codes) if c is None]
                if joined:
                    what = f"{timeout:.0f} s after every rank joined the group"
                else:
                    unjoined = [r for r, m in enumerate(ready) if not m.exists()]
                    what = (f"after {STARTUP_TIMEOUT:.0f} s of start-up, ranks {unjoined} "
                            "not joined to the group")
                raise TimeoutError(
                    f"ranks {waiting} of {len(procs)} still running {what}; "
                    f"killed. Rank {waiting[0]}:\n" + _tail(logs[waiting[0]]))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


def _tail(path: Path, n: int = 4000) -> str:
    text = path.read_text(errors="replace") if path.exists() else ""
    return text[-n:]


def _start(cmds_envs, workdir: Path):
    # a file rendezvous must not find a file of an earlier run, nor the
    # launcher an earlier run's marks
    (workdir / "rendezvous").unlink(missing_ok=True)
    ready = [workdir / f"ready{rank}" for rank in range(len(cmds_envs))]
    for mark in ready:
        mark.unlink(missing_ok=True)
    procs, logs = [], []
    for rank, (cmd, env) in enumerate(cmds_envs):
        log = workdir / f"rank{rank}.log"
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd, env=env, stdout=f,
                                          stderr=subprocess.STDOUT))
        logs.append(log)
    return procs, logs, ready


class Ranks:
    """The processes of one decomposed run, started; `join` waits for them
    (see `_join`) and removes their working directory if it made one."""

    def __init__(self, cmds_envs, workdir: Path, tmp=None):
        self.workdir, self._tmp = workdir, tmp
        self.procs, self.logs, self.ready = _start(cmds_envs, workdir)

    def join(self, timeout: float) -> list[str]:
        """Wait for every rank (raising as `_join`: `timeout` counts from
        the moment every rank has joined the group); the logs' texts in rank
        order."""
        try:
            _join(self.procs, self.logs, self.ready, timeout)
            return [log.read_text(errors="replace") for log in self.logs]
        finally:
            if self._tmp is not None:
                self._tmp.cleanup()


def _workdir(workdir):
    tmp = None if workdir else tempfile.TemporaryDirectory()
    wd = Path(workdir or tmp.name)
    wd.mkdir(parents=True, exist_ok=True)
    return wd, tmp


def run_command(argv, nranks: int, timeout: float = 3600.0, workdir=None) -> list[str]:
    """Run `python *argv` as `nranks` ranks and wait for them; returns
    their logs' texts in rank order (rank 0's is the run's output). The
    command must join the group through `init_decomposition`, which marks
    the rank as joined."""
    wd, tmp = _workdir(workdir)
    cmd = [sys.executable, *argv]
    ranks = Ranks([(cmd, _rank_env(r, nranks, wd)) for r in range(nranks)], wd, tmp)
    return ranks.join(timeout)


class FunctionRanks(Ranks):
    """`start_function`'s run; `result` joins it and returns the ranks'
    return values in rank order."""

    def result(self, timeout: float) -> list:
        n = len(self.procs)
        wd, tmp, self._tmp = self.workdir, self._tmp, None
        try:
            self.join(timeout)
            return [pickle.loads((wd / f"result{r}.pkl").read_bytes()) for r in range(n)]
        finally:
            if tmp is not None:
                tmp.cleanup()


def start_function(target: str, shape, backend: str, device: str | None = None,
                   kwargs: dict | None = None, workdir=None,
                   pythonpath=()) -> FunctionRanks:
    """Start py*px ranks that each call the function `target`
    ("module:function") as `function(dec, **kwargs)`, and return at once:
    the caller can work while they run, then collect with `.result(timeout)`.
    `pythonpath`: directories the ranks need to import `target`."""
    py, px = shape
    nranks = py * px
    wd, tmp = _workdir(workdir)
    job = wd / "job.pkl"
    job.write_bytes(pickle.dumps(dict(target=target, shape=(py, px), backend=backend,
                                      device=device, kwargs=kwargs or {})))
    for r in range(nranks):
        (wd / f"result{r}.pkl").unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "hnumo_tpu_torch.parallel.launch", str(job)]
    return FunctionRanks([(cmd, _rank_env(r, nranks, wd, pythonpath))
                          for r in range(nranks)], wd, tmp)


def run_function(target: str, shape, backend: str, device: str | None = None,
                 kwargs: dict | None = None, timeout: float = 600.0,
                 workdir=None, pythonpath=()) -> list:
    """start_function, then wait for its result."""
    return start_function(target, shape, backend, device, kwargs, workdir,
                          pythonpath).result(timeout)


def _rank_main(job_path: str) -> None:
    import torch.distributed as dist

    from .sharding import init_decomposition

    job_path = Path(job_path)
    job = pickle.loads(job_path.read_bytes())
    module, name = job["target"].split(":")
    fn = getattr(importlib.import_module(module), name)
    dec = init_decomposition(job["shape"], backend=job["backend"], device=job["device"])
    try:
        result = fn(dec, **job["kwargs"])
    except BaseException:
        # a rank that fails inside an NCCL group can hang at exit, in the
        # group's teardown, while its peers wait in a collective: the
        # launcher would see it only at its time limit. Leave at once.
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    (job_path.parent / f"result{dec.rank}.pkl").write_bytes(pickle.dumps(result))
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1])
