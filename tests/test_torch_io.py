"""The run layer of the port against the JAX package's: the namelist parser,
the txt / NetCDF / VTK snapshots and the npz checkpoint, the diagnostics
and the FIN file, the Runner with its restart, and the CLI.

Output formats are contracts: given the very numbers the JAX package's
writers were given (a state stepped by the JAX model, carried across as
numpy), the port's writers must produce the same bytes. Only what the two
models compute is compared within a tolerance: the FIN values of one f64
Runner run of each to 1e-10 relative (their steps agree to ~1e-14, and the
FIN file keeps 12 digits). A restarted run tracks a straight run to 1e-11
(tests/test_io.py's gate: txt snapshots store derived fields, so the restart
is exact to derive/reconstruct roundoff, not bitwise).
"""
import dataclasses
import pathlib
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from hnumo_tpu.config import Config as JaxConfig
from hnumo_tpu.config import config_from_namelist as jax_from_namelist
from hnumo_tpu.config import parse_namelist as jax_parse
from hnumo_tpu.driver import Runner as JaxRunner
from hnumo_tpu.io import diagnostics as jdiag
from hnumo_tpu.io import snapshots as jsnap
from hnumo_tpu.io import vtk as jvtk
from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu_torch import driver
from hnumo_tpu_torch.config import Config as TorchConfig
from hnumo_tpu_torch.config import config_from_namelist, parse_namelist
from hnumo_tpu_torch.core.types import State
from hnumo_tpu_torch.io import diagnostics as diag
from hnumo_tpu_torch.io import snapshots as snap
from hnumo_tpu_torch.io import vtk
from hnumo_tpu_torch.model import Model as TorchModel
from test_torch_common import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# tests/test_io.py's configuration: 3 steps, a snapshot after each
CFG = dict(nelx=6, nely=6, nopx=3, nopy=3, xdims=(0.0, 2e3), ydims=(0.0, 2e3),
           nlayers=2, dt=20.0, dt_btp=2.0, time_final=60.0, time_restart=20.0,
           test_case="bump", dtype="float64")
FIELDS = ("qb_df", "q_df", "qprime_df")

NAMELIST = """! a reference-style input
&gridnl
 nelx = 6
 nely = 6
 nopx = 3
 nopy = 3
 xdims = 0.0, 2.0d3
 ydims = 0.0D0, 2000
 nlayers = 2
 x_boundary = 4, 4
 y_boundary = 4
/
&input
 dt = 20.0
 dt_btp = 2.0d0
 time_final = 6.0e1   ! three steps
 time_restart = 20.0
 test_case = 'bump'
 ti_method_btp = "rk35"
 out_type = 'txt',
 dump_data = T
 lcheck_conserved = .f.
 lprint_diagnostics = .true.
 eqn_set = 'mlswe'
 nelz = 1
 {extra}
/
"""


def write_namelist(path, extra=""):
    path.write_text(NAMELIST.format(extra=extra))
    return path


@pytest.fixture(scope="module")
def models():
    """The JAX model and its state after 3 steps; the port's model and the
    same state carried across as numpy (the numbers both writers get)."""
    jm = JaxModel(JaxConfig(**CFG))
    js = jm.state0
    for _ in range(3):
        js = jm.step(js)
    tm = TorchModel(TorchConfig(**CFG), device="cpu")
    ts = State(*[torch.tensor(np.asarray(a)) for a in js])
    return jm, js, tm, ts


def test_namelist_parses_as_in_jax(tmp_path):
    """One namelist, bc.inp included: the parsed values and every field of
    the port's Config equal the JAX package's."""
    nml = write_namelist(tmp_path / "numo3d.in", "lread_bc = .true.")
    (tmp_path / "bc.inp").write_text('2\n"west.dat" 2\n"north.dat" 5\n')

    def patch(pts):
        return "header\nheader\n{} 1\n{}\n".format(
            len(pts), "\n".join(f"{x} {y} 0.0" for x, y in pts))

    (tmp_path / "west.dat").write_text(patch([(0.0, y) for y in np.linspace(0, 2e3, 7)]))
    (tmp_path / "north.dat").write_text(patch([(x, 2e3) for x in np.linspace(0, 2e3, 7)]))
    assert parse_namelist(nml) == jax_parse(nml)
    with warnings.catch_warnings():
        warnings.simplefilter("error")            # inert reference keys: silent
        tcfg = config_from_namelist(nml)
    jcfg = jax_from_namelist(nml)
    for f in dataclasses.fields(TorchConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert (tcfg.x_boundary, tcfg.y_boundary) == ((2, 4), (4, 5))
    assert (tcfg.xdims, tcfg.ydims, tcfg.time_final) == ((0.0, 2e3), (0.0, 2000), 60.0)
    assert tcfg.lcheck_conserved is False and tcfg.dump_data is True
    assert tcfg.t_restart == jcfg.t_restart == 20.0


def test_namelist_warnings(tmp_path):
    """An unknown key warns, as in the JAX package; a backend switch of the
    JAX package is read with a warning that it has no effect here, and
    `batched_faces`, which the port honours, is read without one."""
    nml = write_namelist(tmp_path / "numo3d.in",
                         "vis_mlswe = 10.0\n use_pallas = 'on'\n scan_stages = 'auto'\n"
                         " batched_faces = 'off'")
    with pytest.warns(UserWarning) as rec:
        cfg = config_from_namelist(nml)
    msgs = [str(w.message) for w in rec]
    assert sum("unrecognized namelist key 'vis_mlswe'" in m for m in msgs) == 1
    for key in ("use_pallas", "scan_stages"):
        assert sum(f"{key!r} is a switch of the JAX package and has no effect" in m
                   for m in msgs) == 1
    assert not any("batched_faces" in m for m in msgs)
    assert cfg.visc_mlswe == 0.0
    with pytest.warns(UserWarning, match="vis_mlswe"):
        jax_from_namelist(nml)


@pytest.mark.parametrize("value,flat", [("'off'", False), ("'on'", True), ("'auto'", True)])
def test_namelist_batched_faces_takes_effect(tmp_path, value, flat):
    """A namelist's batched_faces reaches the port's face path as it
    reaches the JAX package's: "auto" on a grid under 8192 elements, and
    "on", batch both face directions on one axis; "off" keeps one pipeline
    per direction."""
    nml = write_namelist(tmp_path / "numo3d.in", f"batched_faces = {value}")
    cfg = config_from_namelist(nml)
    assert cfg.batched_faces == value.strip("'") == jax_from_namelist(nml).batched_faces
    m = TorchModel(cfg, device="cpu")
    assert m.static.batched_faces is flat


@pytest.mark.parametrize("key,value", [("mega", "'maybe'"), ("fused_tail", "'auto'"),
                                       ("uni_volume", "'yes'"), ("dtype", "'float16'"),
                                       ("batched_faces", "'of'"),
                                       ("ti_method_btp", "'rk4'")])
def test_port_switches_reject_unknown_values(tmp_path, key, value):
    nml = write_namelist(tmp_path / "numo3d.in", f"{key} = {value}")
    with pytest.raises(ValueError, match=key):
        config_from_namelist(nml)


def test_txt_snapshot_restart_roundtrip(models, tmp_path):
    _, _, tm, _ = models
    stepped = tm.run(tm.state0, 3)
    snap.write_txt(tm, stepped, 7, outdir=tmp_path)
    s2 = snap.restore_state(tm, snap.read_txt(tmp_path / "mlswe0007"))
    # thickness channels store δdp; the snapshot holds the derived h, so the
    # round trip is exact relative to the FULL thickness
    dp_scale = float(tm.P.dpp_ref_df.abs().max())
    for name in FIELDS:
        a, b = getattr(stepped, name).numpy(), getattr(s2, name).numpy()
        assert np.abs(a - b).max() / max(np.abs(a).max(), dp_scale) < 1e-13, name


def test_f32_restore_rebuilds_all_but_pb_prime_to_rounding(tmp_path):
    """In float32 the restart subtracts, in float64, the float64 rest state
    that the writer added: the thickness perturbation comes back to its own
    rounding (one ulp of its max), not to that of the float32 copy of the
    rest state or of g/alpha in float32 (~one ulp of the full thickness).
    dp' is rebuilt as dp / (sum dp / pbprime), with which the model's own dp'
    agrees to two roundings of the full thickness. pb' = pb - pbprime keeps
    the rounding of pb, which the file holds in place of pb': up to one ulp
    of max|pb|."""
    m = TorchModel(TorchConfig(**{**CFG, "dtype": "float32"}), device="cpu")
    s = m.run(m.state0, 3)
    snap.write_txt(m, s, 3, outdir=tmp_path)
    r = snap.restore_state(m, snap.read_txt(tmp_path / "mlswe0003"))

    def ulp(t):
        return float(np.spacing(t.abs().max().numpy()))

    full = m.P.dpp_ref_df + s.q_df[0]
    assert float((s.q_df[0] - r.q_df[0]).abs().max()) <= ulp(s.q_df[0])
    assert float((s.qprime_df[0] - r.qprime_df[0]).abs().max()) <= 2 * ulp(full)
    pb_ulp = ulp(s.qb_df[0])
    assert float((s.qb_df[1] - r.qb_df[1]).abs().max()) <= pb_ulp
    for c in (0, 2, 3):
        assert torch.equal(s.qb_df[c], r.qb_df[c])


def test_restored_state_fits_the_model(models, tmp_path):
    """restore_state builds every field, t and ok included, in the model's
    dtype, on its device, shaped as its initial state: what a captured step
    takes."""
    jm, js, tm, ts = models
    snap.write_txt(tm, ts, 3, outdir=tmp_path)
    s2 = snap.restore_state(tm, snap.read_txt(tmp_path / "mlswe0003"), t=60.0)
    for name, a, b in zip(State._fields, s2, tm.state0):
        assert (a.shape, a.dtype, a.device) == (b.shape, b.dtype, b.device), name
    assert float(s2.t) == 60.0 and bool(s2.ok)
    # the same numbers as the JAX package's restore of the same file
    j2 = jsnap.restore_state(jm, jsnap.read_txt(tmp_path / "mlswe0003"), t=60.0)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(s2, name).numpy(), np.asarray(getattr(j2, name)))


def test_txt_snapshot_bytes_match_jax(models, tmp_path):
    jm, js, tm, ts = models
    a = jsnap.write_txt(jm, js, 3, outdir=str(tmp_path), root="a")
    b = snap.write_txt(tm, ts, 3, outdir=str(tmp_path), root="b")
    assert open(a, "rb").read() == open(b, "rb").read()
    for k, v in snap.read_txt(b).items():
        np.testing.assert_array_equal(v, jsnap.read_txt(a)[k], err_msg=k)


def test_nc_snapshot_roundtrip_and_bytes(models, tmp_path):
    jm, js, tm, ts = models
    b = snap.write_nc(tm, ts, 3, outdir=str(tmp_path))
    a = jsnap.write_nc(jm, js, 3, outdir=str(tmp_path), root="jax")
    assert open(a, "rb").read() == open(b, "rb").read()
    d = snap.read_nc(b)
    ref = snap.snapshot_arrays(tm, ts)
    for name in ("h", "u", "v", "eta", "pb", "pbub", "pbvb", "zbot", "x", "y"):
        np.testing.assert_array_equal(d[name], ref[name], err_msg=name)
    assert (d["time"], d["dt"], d["nlayers"], d["npoin"]) == (60.0, 20.0, 2, 576)
    s2 = snap.restore_state(tm, d)
    dp_scale = float(tm.P.dpp_ref_df.abs().max())
    np.testing.assert_allclose(s2.q_df.numpy(), ts.q_df.numpy(), rtol=1e-12,
                               atol=1e-12 * dp_scale)
    assert float(s2.t) == 60.0


def test_checkpoint_bit_exact(models, tmp_path):
    _, _, tm, _ = models
    stepped = tm.run(tm.state0, 2)
    snap.save_checkpoint(tmp_path / "ck.npz", stepped, 42)
    s2, itime = snap.load_checkpoint(tmp_path / "ck.npz", tm)
    assert itime == 42
    for name, a, b in zip(State._fields, stepped, s2):
        assert (a.dtype, a.shape, a.device) == (b.dtype, b.shape, b.device), name
        assert torch.equal(a, b), name


def test_diagnostics_and_fin_bytes_match_jax(models, tmp_path):
    """summary (per-layer extrema, mass loss, CFL) of the same numbers equals
    the JAX package's; the FIN file, the printed block and the banners are
    the same text."""
    jm, js, tm, ts = models
    jmass0 = jdiag.compute_mass(jm, jm.state0)
    mass0 = diag.compute_mass(tm, tm.state0)
    np.testing.assert_array_equal(mass0, jmass0)
    js_sum, ts_sum = jdiag.summary(jm, js, jmass0), diag.summary(tm, ts, mass0)
    assert ts_sum == js_sum
    jdiag.write_fin(tmp_path / "j.txt", js_sum)
    diag.write_fin(tmp_path / "t.txt", js_sum)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    assert diag.print_summary(js_sum, 3, 20.0, 2.0) == jdiag.print_summary(js_sum, 3, 20.0, 2.0)
    for flag in (0, 1):
        assert diag.print_header(tm, flag) == jdiag.print_header(jm, flag)
    for x in (0.0, 1.0, -2.5e-7, 123456.789, 9.999999999999e-3):
        assert diag._e(x, 12) == jdiag._e(x, 12)


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_vtk_bytes_match_jax(models, tmp_path, fmt):
    jm, js, tm, ts = models
    a = jvtk.write_vtk(jm, js, 3, root="jax", outdir=str(tmp_path), fmt=fmt)
    b = vtk.write_vtk(tm, ts, 3, outdir=str(tmp_path), fmt=fmt)
    assert len(a) == len(b) == 2
    for pa, pb in zip(a, b):
        assert open(pa, "rb").read() == open(pb, "rb").read()
    ga = jvtk.write_grid_vtk(jm.geom, str(tmp_path / "jgrid.vtk"))
    gb = vtk.write_grid_vtk(tm.geom, str(tmp_path / "grid.vtk"))
    assert open(ga, "rb").read() == open(gb, "rb").read()


def fin_numbers(path):
    return np.array([float(v) for v in re.findall(r"-?0\.\d+E[+-]\d+", path.read_text())])


@pytest.mark.parametrize("out_type,files", [
    ("txt", ["mlswe0000", "mlswe0001", "mlswe0002", "mlswe0003"]),
    ("nc", ["mlswe0000.nc", "mlswe0003.nc"]),
    ("vtk", ["mlswe0000", "mlswe0003", "mlswe0000_l1.vtk", "mlswe0003_l2.vtk"])])
def test_runner_produces_outputs(tmp_path, out_type, files):
    m = TorchModel(TorchConfig(**CFG, out_type=out_type, format_vtk="binary"),
                   device="cpu")
    state, summ = driver.Runner(m, outdir=str(tmp_path)).run(quiet=True)
    for name in files + ["mlswe_FIN.txt", "time.csv", "mass_mlswe.cons"]:
        assert (tmp_path / name).exists(), name
    assert all(layer["mass_loss"] < 1e-12 for layer in summ["layers"])
    assert float(state.t) == 60.0
    mass_lines = (tmp_path / "mass_mlswe.cons").read_text().splitlines()
    assert [int(ln.split()[0]) for ln in mass_lines] == [1, 2, 3]


def test_runner_fin_agrees_with_jax(models, tmp_path):
    """One f64 Runner run of each package: the FIN files agree number by
    number to 1e-10 relative (mass losses: both below 1e-12)."""
    jm, _, tm, _ = models
    JaxRunner(jm, outdir=str(tmp_path / "jax")).run(quiet=True)
    driver.Runner(tm, outdir=str(tmp_path / "port")).run(quiet=True)
    a = fin_numbers(tmp_path / "jax" / "mlswe_FIN.txt")
    b = fin_numbers(tmp_path / "port" / "mlswe_FIN.txt")
    assert len(a) == len(b) == 2 * 9
    mass = np.zeros(len(a), bool)
    mass[[0, 9]] = True
    assert np.abs(a[mass]).max() < 1e-12 and np.abs(b[mass]).max() < 1e-12
    np.testing.assert_allclose(b[~mass], a[~mass], rtol=1e-10, atol=0)


def test_restart_continuation_matches_straight_run(tmp_path):
    """Resume from a txt snapshot: tracks the straight run to 1e-11."""
    cfg = TorchConfig(**{**CFG, "time_final": 120.0, "time_restart": 40.0})
    final, _ = driver.Runner(TorchModel(cfg, device="cpu"),
                             outdir=str(tmp_path)).run(quiet=True)  # snapshots 2, 4, 6
    cfg2 = dataclasses.replace(cfg, time_initial=80.0, irestart_file_number=4)
    r2 = driver.Runner(TorchModel(cfg2, device="cpu"), outdir=str(tmp_path))
    final2, _ = r2.run(quiet=True)                  # resumes at itime=4, runs 2 steps
    assert r2.ntime == 6 and float(final2.t) == float(final.t) == 120.0
    for name in ("q_df", "qb_df"):
        a, b = getattr(final, name).numpy(), getattr(final2, name).numpy()
        assert np.abs(a - b).max() / np.abs(a).max() < 1e-11, name


def test_cli_runs_a_namelist_on_the_cpu(tmp_path, capsys):
    nml = write_namelist(tmp_path / "numo3d.in")
    runner, state, summ = driver.main([str(nml), "--outdir", str(tmp_path / "out"),
                                       "--cpu"])
    out = capsys.readouterr().out
    assert "Begin Simulation" in out and "**Simulation Finished**" in out
    for name in ("mlswe0000", "mlswe0001", "mlswe0003", "mlswe_FIN.txt", "time.csv",
                 "mass_mlswe.cons"):
        assert (tmp_path / "out" / name).exists(), name
    assert runner.model.device.type == "cpu" and runner.model.dtype == torch.float64
    assert bool(state.ok) and len(summ["layers"]) == 2
    # --f32 runs the same namelist in float32
    runner32, _, _ = driver.main([str(nml), "--outdir", str(tmp_path / "out32"), "--cpu",
                                  "--f32", "--quiet", "--mesh", "1x1"])
    assert runner32.model.dtype == torch.float32
    assert capsys.readouterr().out == ""


def test_cli_refuses_a_device_mesh(tmp_path):
    nml = write_namelist(tmp_path / "numo3d.in")
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        driver.main([str(nml), "--mesh", "2x2", "--cpu", "--outdir", str(tmp_path)])
    assert not (tmp_path / "mlswe0000").exists()


def test_cli_needs_cuda_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    nml = write_namelist(tmp_path / "numo3d.in")
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.main([str(nml), "--outdir", str(tmp_path)])


def test_python_dash_m_entry_point(tmp_path):
    """`python -m hnumo_tpu_torch numo3d.in --cpu` runs to its end."""
    nml = write_namelist(tmp_path / "numo3d.in")
    r = subprocess.run([sys.executable, "-m", "hnumo_tpu_torch", str(nml), "--cpu",
                        "--quiet", "--outdir", str(tmp_path / "out")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "out" / "mlswe_FIN.txt").exists()
