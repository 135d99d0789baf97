"""hnumo_tpu_torch/tools/bench.py on the CPU: its configuration against the
JAX package's bench.py, its metric and output, its variants and their
paths, and its refusals. The timed runs themselves need the card (the tool
raises without one unless --cpu asks for the CPU); here they step eagerly
at 4x4 and 6x6 elements, the plain versions' calls proving each path."""
import ast
import dataclasses
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from hnumo_tpu.config import Config as JaxConfig
from hnumo_tpu_torch.tools import _measure, bench, scaling
from test_torch_common import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_PY = ROOT / "bench.py"


def jax_bench_config(nel, nop, nlayers=2, f64=False):
    """bench.py:53-65, written out (bench.py builds it inside main)."""
    scale = (25.0 / nel) * (4.0 / nop) ** 2
    return JaxConfig(
        nelx=nel, nely=nel, nopx=nop, nopy=nop,
        xdims=(0.0, 2.0e6), ydims=(0.0, 2.0e6), nlayers=nlayers,
        dt=500.0 * scale, dt_btp=25.0 * scale, time_final=1e9,
        test_case="double_gyre", f0=9.3e-5, beta=2.0e-11,
        botfr=1, cd_mlswe=1.0e-7, method_visc=2, visc_mlswe=100.0,
        dtype="float64" if f64 else "float32",
    )


def bench_py_json_keys():
    """The keys of the dict bench.py prints last, read from its source."""
    tree = ast.parse(BENCH_PY.read_text())
    dicts = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", None) == "dumps" and isinstance(n.args[0], ast.Dict)]
    assert len(dicts) == 1
    return [k.value for k in dicts[0].args[0].keys]


def bench_py_baseline():
    tree = ast.parse(BENCH_PY.read_text())
    for n in tree.body:
        if isinstance(n, ast.Assign) and n.targets[0].id == "BASELINE_GPS":
            return ast.literal_eval(n.value)
    raise AssertionError("bench.py has no BASELINE_GPS")


def run_main(capsys, *argv):
    assert bench.main(list(argv)) == 0
    out = capsys.readouterr()
    return out.out.strip().splitlines(), out.err


@pytest.mark.parametrize("nel,nop", [(25, 4), (32, 4), (25, 8), (32, 8)])
def test_bench_config_is_bench_pys_basin(nel, nop):
    """Field for field the Config bench.py builds (every field both
    packages' Configs have; the port's has no other)."""
    ours, theirs = bench.bench_config(nel, nop), jax_bench_config(nel, nop)
    names = [f.name for f in dataclasses.fields(ours)]
    assert set(names) <= {f.name for f in dataclasses.fields(theirs)}
    for name in names:
        assert getattr(ours, name) == getattr(theirs, name), name
    f64 = bench.bench_config(nel, nop, "float64", nlayers=3)
    assert (f64.dtype, f64.nlayers) == (jax_bench_config(nel, nop, 3, True).dtype, 3)


@pytest.mark.parametrize("nel,nop", [(4, 2), (6, 4)])
def test_both_packages_step_the_bench_basin_alike(nel, nop):
    from hnumo_tpu.model import Model as JaxModel
    from hnumo_tpu_torch.model import Model

    jm = JaxModel(jax_bench_config(nel, nop))
    tm = Model(bench.bench_config(nel, nop), device="cpu")
    assert (tm.static.n_btp, tm.static.kstages) == (jm.static.n_btp, jm.static.kstages)
    assert (tm.cfg.dt, tm.cfg.dt_btp) == (jm.cfg.dt, jm.cfg.dt_btp)
    assert tm.static.n_btp == 20 and tm.static.kstages == 5


@pytest.mark.parametrize("nel,nop", bench.TABLE_GRIDS)
def test_every_table_grid_takes_200_barotropic_stages(nel, nop):
    cfg = bench.bench_config(nel, nop)
    assert 2 * cfg.n_btp * cfg.kstages == 200


@pytest.mark.parametrize("nel,nop,nlayers,steps,wall", [(32, 4, 2, 10, 0.12),
                                                        (16, 8, 2, 3, 1.7), (25, 4, 3, 1, 0.01)])
def test_gridpoint_steps_are_counted_as_bench_py_counts_them(nel, nop, nlayers, steps, wall):
    """bench.py:94-96: gp = nel*nel*nq*nq*nlayers, gps = gp*steps/dt_wall."""
    nq = 2 * nop + 1
    gp = nel * nel * nq * nq * nlayers
    cfg = bench.bench_config(nel, nop, nlayers=nlayers)
    assert bench.gridpoint_steps_per_s(cfg, steps, wall) == pytest.approx(gp * steps / wall,
                                                                          rel=1e-15)


def test_the_last_line_is_bench_pys(capsys, tmp_path):
    """Without --table: exactly bench.py's four keys last on stdout, the
    value from the median window as bench.py counts it, vs_baseline against
    bench.py's own baseline; the `# device=` line on stderr."""
    out = tmp_path / "bench.jsonl"
    lines, err = run_main(capsys, "--cpu", "--nel", "4", "--nop", "2", "--steps", "1",
                          "--repeats", "2", "--out", str(out))
    last = json.loads(lines[-1])
    assert list(last) == bench_py_json_keys() == ["metric", "value", "unit", "vs_baseline"]
    assert last["metric"] == "dg_gridpoint_steps_per_s"
    assert bench.BASELINE_GPS == bench_py_baseline()
    rec = json.loads(out.read_text().splitlines()[-1])
    assert len(rec["ms_per_step_windows"]) == 2
    gps = bench.gridpoint_steps_per_s(bench.bench_config(4, 2), 1, rec["ms_per_step"] / 1e3)
    assert last["value"] == round(gps, 1) == round(rec["gp_steps_per_s"], 1)
    assert last["vs_baseline"] == round(gps / bench_py_baseline(), 2)
    assert err.splitlines()[-1].startswith("# device=cpu") and "ok=True" in err
    assert rec["variant"] == "default" and rec["kernels_per_step"] == {"btp_mega": 2}


@pytest.mark.parametrize("grid,variants", [("4:2", None), ("4:4", None),
                                           ("6:2", ["flat", "dir"])])
def test_the_table_prints_a_line_per_variant(capsys, grid, variants):
    """--table --cpu: one parseable line per variant the grid admits (or
    those named), each on its variant's path, gated and timed."""
    argv = ["--table", "--cpu", "--grids", grid, "--steps", "1", "--repeats", "1"]
    lines, _ = run_main(capsys, *argv, *(["--variants", *variants] if variants else []))
    recs = [json.loads(line) for line in lines]
    nel, nop = bench.parse_grid(grid)
    want = variants or ["default", "mega", "stage", "uni", "fused"]
    assert [r["variant"] for r in recs] == want
    for r in recs:
        cfg = bench.variant_config(nel, nop, r["variant"])
        expected = {k: n for k, n in bench.expected_kernels(r["variant"], cfg).items() if n}
        assert r["kernels_per_step"] == expected
        assert r["ok"] and r["finite"] and r["mass_drift"] <= _measure.MASS_TOL
        assert r["nel"] == [nel, nel] and r["nop"] == nop and r["step_impl"] == "eager"
        assert len(r["ms_per_step_windows"]) == 1 and r["ms_per_step"] > 0
        assert r["spread"] == 0.0 and r["host_load"]["cpus"] >= 1
        assert r["faces"] == bench.VARIANT_FACES.get(r["variant"], r["faces"])
        assert set(r["bound_ms"]) == set(expected)


def test_the_table_plan():
    """Without --grids: the roadmap's grids, every variant a grid's envelope
    admits, the face variants at 128 and 256 only, no megakernel at p=8."""
    plan = {(nel, nop): names for nel, nop, names in bench.table_plan()}
    assert list(plan) == [(25, 4), (32, 4), (64, 4), (128, 4), (256, 4), (16, 8), (32, 8)]
    five = ["default", "mega", "stage", "uni", "fused"]
    for nel in (25, 32, 64):
        assert plan[(nel, 4)] == five
    for nel in (128, 256):
        assert plan[(nel, 4)] == five + ["flat", "dir"]
    for nel in (16, 32):
        assert plan[(nel, 8)] == ["default", "stage", "uni", "fused"]


@pytest.mark.parametrize("variant,nel,nop,want", [
    ("default", 32, 4, {"btp_mega": 2}), ("default", 25, 4, {"btp_mega": 2}),
    ("default", 64, 4, {"btp_volume": 200}), ("default", 32, 8, {"btp_volume": 200}),
    ("mega", 256, 4, {"btp_mega": 2}), ("stage", 32, 4, {"btp_volume": 200}),
    ("uni", 256, 4, {"btp_volume_uni": 200}),
    ("fused", 16, 8, {"btp_volume_uni": 200, "btp_faces": 200, "btp_update": 200}),
    ("flat", 128, 4, {"btp_volume": 200}), ("dir", 256, 4, {"btp_volume": 200})])
def test_each_variant_names_its_kernels(variant, nel, nop, want):
    got = bench.expected_kernels(variant, bench.variant_config(nel, nop, variant))
    assert got == {k: want.get(k, 0) for k in _measure.KERNEL_SYMBOLS}


@pytest.mark.parametrize("argv,exc,match", [
    (["--variant", "xla"], ValueError, "unknown variant"),
    (["--table", "--grids", "4", "--variants", "bf_xla"], ValueError, "unknown variant"),
    (["--variant", "mega", "--nop", "8"], ValueError, "mega='on' is outside"),
    (["--table", "--grids", "4:8", "--variants", "mega"], ValueError, "mega='on' is outside"),
    (["--grids", "4"], ValueError, "--table"),
    (["--steps", "0"], ValueError, "positive"),
    (["--spans"], ValueError, "needs a CUDA device"),
])
def test_what_the_tool_refuses(argv, exc, match):
    with pytest.raises(exc, match=match):
        bench.main(["--cpu", "--nel", "4", "--steps", "1", "--repeats", "1", *argv])


@pytest.mark.parametrize("argv", [["--nel", "4", "--nop", "2", "--steps", "1"],
                                  ["--table", "--grids", "4:2", "--steps", "1"]])
def test_without_a_gpu_it_raises_rather_than_run_on_the_cpu(argv):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(argv)


@pytest.mark.parametrize("fault", ["path", "mass"])
def test_a_failed_gate_raises(monkeypatch, fault):
    """A path whose kernels are not its variant's, or a mass change over
    the limit, raises; nothing is caught."""
    if fault == "path":
        monkeypatch.setattr(bench, "expected_kernels",
                            lambda variant, cfg: dict.fromkeys(_measure.KERNEL_SYMBOLS, 0))
        match = "the plain versions' calls"
    else:
        monkeypatch.setattr(_measure, "MASS_TOL", -1.0)
        match = "total-mass change"
    with pytest.raises(AssertionError, match=match):
        bench.main(["--cpu", "--nel", "4", "--nop", "2", "--steps", "1", "--repeats", "1"])


@pytest.mark.parametrize("argv,match", [(["--cpu", "--variant", "nope"], "unknown variant"),
                                        (["--nel", "4"], "CUDA")])
def test_the_command_exits_non_zero(argv, match):
    if "--cpu" not in argv and torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    r = subprocess.run([sys.executable, "-m", "hnumo_tpu_torch.tools.bench", *argv],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and match in r.stderr
    assert r.stdout == ""


@pytest.mark.parametrize("grid", [(128, 128), (128, 256), (256, 256), (25, 40)])
def test_the_scaling_configuration_is_unchanged(grid):
    """scaling.bench_config, now built on bench.bench_config, gives the
    Config its own formula gave before."""
    from hnumo_tpu_torch.config import Config

    nely, nelx = grid
    scale = 25.0 / nely
    before = Config(nelx=nelx, nely=nely, nopx=4, nopy=4,
                    xdims=(0.0, 2.0e6 * nelx / nely), ydims=(0.0, 2.0e6), nlayers=2,
                    dt=500.0 * scale, dt_btp=25.0 * scale, time_final=1e9,
                    test_case="double_gyre", f0=9.3e-5, beta=2.0e-11, botfr=1,
                    cd_mlswe=1.0e-7, method_visc=2, visc_mlswe=100.0, dtype="float32",
                    mega="off", fused_tail="on")
    assert scaling.bench_config(*grid) == before


def test_chip_smokes_basin_is_the_bench_basin():
    import chip_smoke

    assert chip_smoke.main_path_config(32, "float32") == bench.bench_config(32)
    assert (chip_smoke.main_path_config(16, "float64", nop=8, mega="off", fused_tail="on")
            == bench.variant_config(16, 8, "fused", "float64"))
