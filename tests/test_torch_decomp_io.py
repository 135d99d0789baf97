"""The run layer of the port under a domain decomposition, on the CPU over
gloo: `python -m hnumo_tpu_torch <namelist> --mesh 2x2 --cpu` (the command
starts its four ranks itself) writes the files of the serial run — the FIN
file, the txt snapshots and the mass log byte for byte (the per-stage path
of a split model is bitwise the serial one's, tests/test_torch_decomp_step.py)
— and restarts from a txt snapshot as the serial run does; an npz
checkpoint saved by a decomposed run restarts a serial one bit-exactly, and
the reverse."""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_decomp_ranks as R
from hnumo_tpu_torch.io import snapshots as snap
from hnumo_tpu_torch.model import Model as TorchModel
from hnumo_tpu_torch.parallel.launch import start_function

TESTS = pathlib.Path(__file__).resolve().parent
ROOT = TESTS.parent
NAMELIST = """&gridnl
 nelx = 8
 nely = 8
 nopx = 3
 nopy = 3
 nlayers = 2
 xdims = 0, 2d3
 ydims = 0, 2d3
 x_boundary = 2, 0
 y_boundary = 4, 4
/
&input
 dt = 20
 dt_btp = 2
 time_initial = {t0}
 time_final = 100
 time_restart = 40
 irestart_file_number = {irestart}
 test_case = 'bump'
 mega = 'off'
/
"""
FILES = ("mlswe0000", "mlswe0002", "mlswe0004", "mlswe0005", "mlswe_FIN.txt",
         "mass_mlswe.cons")
# mega="off": the serial run on the path of the split one (which never takes
# the megakernel), so that the two are bitwise the same
CKPT = dict(x_boundary=(2, 0), method_visc=2, visc_mlswe=10.0, mega="off")


def _cli(tmp_path, outdir, *extra, t0=0, irestart=0, seed_from=None):
    nl = tmp_path / f"numo3d_{outdir}.in"
    nl.write_text(NAMELIST.format(t0=t0, irestart=irestart))
    out = tmp_path / outdir
    if seed_from is not None:
        out.mkdir()
        name = f"mlswe{irestart:04d}"
        (out / name).write_bytes((tmp_path / seed_from / name).read_bytes())
    r = subprocess.run([sys.executable, "-m", "hnumo_tpu_torch", str(nl), "--outdir",
                        str(out), "--cpu", *extra], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return out, r.stdout


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Serial and 2x2 runs of one namelist from t=0, then each restarted from
    the serial run's snapshot 2; the checkpoint ranks run meanwhile."""
    tmp = tmp_path_factory.mktemp("cli")
    ck = _checkpoints_start(tmp)
    runs = {"serial": _cli(tmp, "serial", "--quiet"),
            "mesh": _cli(tmp, "mesh", "--mesh", "2x2")}
    runs["serial_restart"] = _cli(tmp, "serial_restart", "--quiet", t0=40, irestart=2,
                                  seed_from="serial")
    runs["mesh_restart"] = _cli(tmp, "mesh_restart", "--mesh", "2x2", "--quiet", t0=40,
                                irestart=2, seed_from="serial")
    return runs, _checkpoints_finish(tmp, ck)


@pytest.mark.parametrize("name", FILES)
def test_decomposed_cli_writes_the_serial_files(cli_runs, name):
    runs, _ = cli_runs
    a = (runs["serial"][0] / name).read_bytes()
    b = (runs["mesh"][0] / name).read_bytes()
    assert a == b, name


def test_decomposed_cli_reports_its_ranks(cli_runs):
    runs, _ = cli_runs
    out = runs["mesh"][1]
    assert "decomposition 2x2: 4 ranks, backend gloo, transport gloo" in out
    assert "numproc =      4" in out and " **Simulation Finished**" in out
    assert out.count("Begin Simulation") == 1      # rank 0 prints, alone
    assert "numproc =      1" in runs["serial"][1] or runs["serial"][1] == ""


@pytest.mark.parametrize("name", ("mlswe0004", "mlswe0005", "mlswe_FIN.txt"))
def test_decomposed_restart_from_a_txt_snapshot(cli_runs, name):
    runs, _ = cli_runs
    a = (runs["serial_restart"][0] / name).read_bytes()
    b = (runs["mesh_restart"][0] / name).read_bytes()
    assert a == b, name


def test_mesh_without_cpu_or_gpus_is_refused(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    nl = tmp_path / "n.in"
    nl.write_text(NAMELIST.format(t0=0, irestart=0))
    r = subprocess.run([sys.executable, "-m", "hnumo_tpu_torch", str(nl), "--outdir",
                        str(tmp_path), "--mesh", "2x2"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and "--cpu" in r.stderr


# ---- npz checkpoints across decompositions --------------------------------------

def _checkpoints_start(tmp):
    """Serial: 2 steps from the start, checkpoint A, 2 more (the reference);
    the 2x2 ranks meanwhile: 2 steps from the start to B, and 2 steps from
    A to C."""
    a, b, c = (str(tmp / f"{k}.npz") for k in "ABC")
    m = TorchModel(R.bump_config(**CKPT), device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s2 = m.run(m.state0, 2)
        snap.save_checkpoint(a, s2, 2)
        ranks = start_function("torch_decomp_ranks:checkpoint_ranks", (2, 2), "gloo",
                               device="cpu", pythonpath=[TESTS],
                               kwargs=dict(over=CKPT, runs=[(None, 2, b, 2), (a, 2, c, 4)]))
        s4 = m.run(s2, 2)
    finally:
        torch.set_num_threads(threads)
    return m, s2, s4, ranks, (a, b, c)


def _checkpoints_finish(tmp, started):
    m, s2, s4, ranks, (a, b, c) = started
    ranks.result(300.0)
    from_b = m.run(snap.load_checkpoint(b, m)[0], 2)
    return dict(s2=s2, s4=s4, b=snap.load_checkpoint(b, m), c=snap.load_checkpoint(c, m),
                serial_from_b=from_b)


def _equal(s, t):
    return all(torch.equal(getattr(s, f), getattr(t, f)) for f in ("qb_df", "q_df",
                                                                    "qprime_df", "t", "ok"))


def test_checkpoint_of_a_decomposed_run_is_the_serial_state(cli_runs):
    _, ck = cli_runs
    state, itime = ck["b"]
    assert itime == 2 and _equal(state, ck["s2"])


def test_decomposed_checkpoint_restarts_a_serial_run_bit_exactly(cli_runs):
    _, ck = cli_runs
    assert _equal(ck["serial_from_b"], ck["s4"])


def test_serial_checkpoint_restarts_a_decomposed_run_bit_exactly(cli_runs):
    _, ck = cli_runs
    state, itime = ck["c"]
    assert itime == 4 and _equal(state, ck["s4"])
    assert float(np.abs(state.q_df[1].numpy()).max()) > 0.0
