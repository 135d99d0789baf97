"""Tests of the port's benchmark. They run on the CPU; those marked `cuda`
need a CUDA device and skip without one, deciding inside the test:

    JAX_PLATFORMS=cpu python -m pytest portbench/tests -q
"""
import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_tiny_cell(tmp: Path, limits_from: str = "dgyre25.steady") -> Path:
    """A directory that adds two cells made of data files alone (a config,
    two traffic mixes and their limits) to the benchmark: a 3x2 basin of
    the double gyre, stepped for a short window on the CPU. Returns the
    root to pass to cells.cell."""
    here = tmp / "portbench"
    for d in ("configs", "traffic", "checks"):
        (here / d).mkdir(parents=True)
    cfg = json.loads((ROOT / "portbench/configs/dgyre_p4_25.json").read_text())
    cfg["name"] = "tiny"
    cfg["config"].update(nelx=3, nely=2, xdims=[0.0, 3.0e6], ydims=[0.0, 2.0e6])
    (here / "configs/tiny.json").write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "https://example.org/tiny",
                         "file": "portbench/configs/tiny.json", "reduced": [], "why": "a test"}]
    bench["workloads"] = []
    for mix in ("steady", "campaign"):
        traffic = json.loads((ROOT / f"portbench/traffic/{mix}.json").read_text())
        traffic.update(warmup_seconds=0.0, calibration_steps=2, start_steps=2)
        (here / f"traffic/tiny_{mix}.json").write_text(json.dumps(traffic))
        bench["workloads"].append({"name": f"tiny.{mix}", "config": "tiny",
                                   "traffic": f"tiny_{mix}", "chips": 1, "why": "a test"})
        src = ROOT / f"portbench/checks/{limits_from.split('.')[0]}.{mix}.json"
        if src.exists():
            shutil.copy(src, here / f"checks/tiny.{mix}.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
