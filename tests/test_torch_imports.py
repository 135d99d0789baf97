"""The PyTorch package stands alone: it imports torch and numpy, never jax
and nothing of the JAX package; it refuses to run silently on the CPU."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from test_torch_common import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "hnumo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+hnumo_tpu(\s|\.|$)|"
                       r"from\s+hnumo_tpu(\s|\.))", re.M)


@pytest.mark.parametrize("module", ["hnumo_tpu_torch", "hnumo_tpu_torch.model",
                                    "hnumo_tpu_torch.convert",
                                    "hnumo_tpu_torch.ops.btp_volume",
                                    "hnumo_tpu_torch.ops.mega",
                                    "hnumo_tpu_torch.ops.btp_volume_uni",
                                    "hnumo_tpu_torch.ops.btp_tail",
                                    "hnumo_tpu_torch.core.btp",
                                    "hnumo_tpu_torch.io.diagnostics",
                                    "hnumo_tpu_torch.tools.goldens",
                                    "hnumo_tpu_torch.tools.dgyre_campaign",
                                    "hnumo_tpu_torch.tools.bench",
                                    "hnumo_tpu_torch.tools._measure",
                                    "hnumo_tpu_torch.tools.scaling",
                                    "hnumo_tpu_torch.config",
                                    "hnumo_tpu_torch.driver",
                                    "hnumo_tpu_torch.__main__",
                                    "hnumo_tpu_torch.io.snapshots",
                                    "hnumo_tpu_torch.io.vtk",
                                    "hnumo_tpu_torch.mesh.gmsh",
                                    "hnumo_tpu_torch.mesh.bcinp",
                                    "hnumo_tpu_torch.mesh._native",
                                    "hnumo_tpu_torch.parallel.sharding",
                                    "hnumo_tpu_torch.parallel.launch",
                                    "hnumo_tpu_torch.basis.filter",
                                    "hnumo_tpu_torch.mesh.flatfaces",
                                    "hnumo_tpu_torch.spans"])
def test_import_pulls_in_no_jax(module):
    code = (f"import sys, {module}; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'hnumo_tpu' or m.startswith('hnumo_tpu.')]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax(path):
    text = path.read_text()
    assert not FORBIDDEN.search(text), f"{path} imports jax or hnumo_tpu"
    assert "torch.compile" not in text


def test_native_front_end_builds_the_ports_own_source():
    """The port's C++ mesh front end compiles its own copy of the source,
    hnumo_tpu_torch/mesh/csrc/qmesh.cpp, into hnumo_tpu_torch/_build/; it
    never reads the JAX package's native/src/."""
    from hnumo_tpu_torch.mesh import _native

    assert _native.SOURCE == ROOT / "hnumo_tpu_torch" / "mesh" / "csrc" / "qmesh.cpp"
    assert _native.SOURCE.is_file()
    assert _native.BUILD_DIR == ROOT / "hnumo_tpu_torch" / "_build"
    for path in PORT_FILES + [_native.SOURCE]:
        assert "native/src" not in path.read_text(), path


def test_model_needs_cuda_unless_cpu_is_asked_for():
    import torch

    from hnumo_tpu_torch.config import Config
    from hnumo_tpu_torch.model import Model

    cfg = Config(nelx=2, nely=2, nlayers=2, xdims=(0.0, 2e6), ydims=(0.0, 2e6),
                 test_case="double_gyre")
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg, device="cuda")
    m = Model(cfg, device="cpu")
    assert m.static.impl == "plain"


def test_kernel_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the CUDA wrapper raises; it never swaps in the plain version."""
    import torch

    from hnumo_tpu_torch.config import Config
    from hnumo_tpu_torch.model import Model
    from hnumo_tpu_torch.ops.btp_volume import btp_volume_cuda, eflat

    cfg = Config(nelx=2, nely=2, nlayers=2, xdims=(0.0, 2e6), ydims=(0.0, 2e6),
                 test_case="double_gyre")
    m = Model(cfg, device="cpu")
    E, nqq, npts = 4, 81, 25
    z = lambda c, n: torch.zeros((c, E, n), dtype=m.dtype)
    before = btp_volume_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        btp_volume_cuda(m.vol_ops, eflat(m.state0.qb_df), z(3, nqq), z(4, nqq),
                        z(12, nqq), z(3, npts), grav=9.8, botfr=1, cd=0.0,
                        alpha_bot=1e-3)
    assert btp_volume_cuda.launches == before


@pytest.mark.parametrize("over,match", [
    (dict(x_boundary=(3, 3)), "periodic"),
    (dict(ti_method_btp="lsrk"), "ti_method_btp"),
    (dict(method_visc=1, visc_mlswe=10.0), "method_visc"),
    (dict(ad_mlswe=1e-3), "ad_mlswe"),
    (dict(nopy=3), "anisotropic"),
])
def test_ported_options_build_and_step(over, match):
    """The options that were refused before they were ported build a 2x2
    model on the CPU that takes one step with `ok`; an order that differs
    between x and y is refused, as the JAX package refuses it
    (`match`: what the option is about)."""
    from hnumo_tpu_torch.config import Config
    from hnumo_tpu_torch.model import Model

    cfg = Config(**{**dict(nelx=2, nely=2, nlayers=2, xdims=(0.0, 2e6),
                           ydims=(0.0, 2e6), test_case="double_gyre"), **over})
    if match == "anisotropic":
        with pytest.raises(NotImplementedError, match=match):
            Model(cfg, device="cpu")
        return
    m = Model(cfg, device="cpu")
    s = m.step(m.state0)
    assert bool(s.ok) and float(s.t) == cfg.dt
    for name in ("qb_df", "q_df", "qprime_df"):
        assert bool(torch.isfinite(getattr(s, name)).all()), (match, name)


@pytest.mark.parametrize("over,match", [
    (dict(x_boundary=(3, 3)), "periodic"),
    (dict(y_boundary=(4, 3)), "periodic"),
    (dict(ti_method_btp="lsrk"), "ti_method_btp"),
    (dict(method_visc=1, visc_mlswe=10.0), "method_visc"),
    (dict(ad_mlswe=1e-3), "ad_mlswe"),
])
def test_check_ported_accepts_what_is_now_ported(over, match):
    """With the external inputs switched on too, check_ported accepts each
    option that is ported now, and refuses an anisotropic order only."""
    from hnumo_tpu_torch.config import Config
    from hnumo_tpu_torch.core.init import check_ported

    external = dict(lread_external_grid=True, mesh_file="m.msh",
                    lread_external_bathy=True, lread_bc=True)
    check_ported(Config(**external))
    check_ported(Config(**{**external, **over}))
    with pytest.raises(NotImplementedError, match="anisotropic"):
        check_ported(Config(**{**external, **over, "nopy": 3}))
