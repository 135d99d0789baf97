"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package
(top-level names compared whole), and the reference loads nothing of the
port."""
import json
import subprocess
import sys

from portbench.tests.conftest import ROOT, make_tiny_cell

FORBIDDEN = ("jax", "jaxlib", "flax", "hnumo_tpu")


def _loaded(code: str, tmp=None) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                              "PYTHONPATH": str(ROOT)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_every_mix_loads_no_jax(tmp_path):
    root = make_tiny_cell(tmp_path)
    code = ("import torch; torch.set_num_threads(1)\n"
            "from pathlib import Path\nfrom portbench import run\n"
            f"root = Path({str(root)!r})\n"
            "for mix in ('steady', 'campaign'):\n"
            "    run.run_cell('tiny.' + mix, 3, 0.2, False, device='cpu', root=root,"
            " here=root / 'portbench')\n"
            "assert not run.forbidden_modules(), run.forbidden_modules()\n")
    loaded = _loaded(code)
    assert "hnumo_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded("import portbench.reference, portbench.state, portbench.compare, "
                     "portbench.bounds, portbench.stats")
    assert not loaded & set(FORBIDDEN + ("hnumo_tpu_torch",))


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "hnumo_tpu_torch_fake", sys)
    assert "hnumo_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in run.forbidden_modules()
