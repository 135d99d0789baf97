"""How the PyTorch package chooses the barotropic path: the `mega` option of
Config, the envelope of StaticConfig.mega, and the implementation switch
`mega_impl`. Nothing here needs a CUDA device."""
import pytest
import torch

from hnumo_tpu_torch.config import Config
from hnumo_tpu_torch.model import Model

SMALL = dict(nelx=2, nely=2, nlayers=2, xdims=(0.0, 2e6), ydims=(0.0, 2e6),
             test_case="double_gyre")


@pytest.mark.parametrize("value", ["onn", "", "ON", "kernel", None, True])
def test_mega_option_is_validated(value):
    with pytest.raises(ValueError, match="mega"):
        Config(**SMALL, mega=value)


@pytest.mark.parametrize("value", ["auto", "on", "off"])
def test_mega_option_takes_its_three_values(value):
    assert Config(**SMALL, mega=value).mega == value


def test_mega_defaults_to_auto():
    assert Config(**SMALL).mega == "auto"


@pytest.mark.parametrize("nelx,nely,mega,want", [
    (32, 32, "auto", True),     # 1024 elements: the reference's cap, inclusive
    (33, 32, "auto", False),
    (32, 33, "auto", False),
    (6, 5, "auto", True),
    (6, 5, "off", False),
    (32, 32, "off", False),
    (64, 64, "on", True),       # "on" trusts the caller at any element count
    (64, 64, "auto", False),
])
def test_static_mega_follows_the_element_count(nelx, nely, mega, want):
    m = Model(Config(**{**SMALL, "nelx": nelx, "nely": nely, "nopx": 1, "nopy": 1},
                     mega=mega), device="cpu")
    assert m.static.mega is want
    assert (m.mega_ops is not None) is want
    assert m.static.mega_impl == "plain"


@pytest.mark.parametrize("nop,mega,want", [(7, "auto", True), (8, "auto", False),
                                           (7, "on", True)])
def test_static_mega_follows_the_order_cap(nop, mega, want):
    m = Model(Config(**{**SMALL, "nopx": nop, "nopy": nop}, mega=mega), device="cpu")
    assert m.static.mega is want


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_both_precisions_are_inside_the_envelope(dtype):
    assert Model(Config(**SMALL, dtype=dtype), device="cpu").static.mega


@pytest.mark.parametrize("over", [
    dict(x_boundary=(3, 3)),
    dict(y_boundary=(3, 3)),
    dict(ti_method_btp="lsrk"),
    dict(ti_method_btp="ssprk"),
    dict(method_visc=1, visc_mlswe=10.0),
    dict(nopx=8, nopy=8),
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_mega_on_outside_the_envelope_raises(over):
    """mega="on" never quietly takes the other path."""
    with pytest.raises((ValueError, NotImplementedError)):
        Model(Config(**{**SMALL, **over}, mega="on"), device="cpu")


def test_mega_on_with_order_8_names_the_envelope():
    with pytest.raises(ValueError, match="envelope"):
        Model(Config(**{**SMALL, "nopx": 8, "nopy": 8}, mega="on"), device="cpu")


def test_auto_outside_the_envelope_takes_the_per_stage_path():
    m = Model(Config(**SMALL, ti_method_btp="ssprk"), device="cpu")
    assert not m.static.mega and m.mega_ops is None


@pytest.mark.parametrize("impl", ["pallas", "", "cuda"])
def test_mega_impl_is_validated(impl):
    with pytest.raises(ValueError, match="mega_impl"):
        Model(Config(**SMALL), device="cpu", mega_impl=impl)


def test_mega_kernel_on_the_cpu_raises():
    with pytest.raises(ValueError, match="mega_impl='kernel' needs a CUDA device"):
        Model(Config(**SMALL), device="cpu", mega_impl="kernel")
    assert Model(Config(**SMALL), device="cpu", mega_impl="plain").static.mega_impl == "plain"


def test_mega_kernel_wrapper_refuses_cpu_tensors():
    """On CPU tensors the CUDA wrapper raises; it never swaps in the plain version."""
    import dataclasses

    from hnumo_tpu_torch.core.bcl import extract_qprime_faces
    from hnumo_tpu_torch.core.coupling import btp_bcl_coeffs
    from hnumo_tpu_torch.core.btp import barotropic_solve
    from hnumo_tpu_torch.ops.mega import barotropic_solve_mega_cuda

    m = Model(Config(**SMALL, dt=40.0, dt_btp=20.0), device="cpu")
    s = m.state0
    qp = s.qprime_df
    zq = torch.zeros(qp.shape[1:-2] + m.g.wjac.shape[-2:], dtype=qp.dtype)
    coup = btp_bcl_coeffs(m.static, m.P, m.g, m.bc, qp,
                          extract_qprime_faces(m.bc, qp), qp[0], zq)
    before = barotropic_solve_mega_cuda.launches
    st = dataclasses.replace(m.static, mega_impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        barotropic_solve(st, m.P, m.g, m.bc, coup, s.qb_df, qp, mega_ops=m.mega_ops)
    assert barotropic_solve_mega_cuda.launches == before


def test_static_config_rejects_unknown_mega_impl():
    import dataclasses

    m = Model(Config(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="mega_impl"):
        dataclasses.replace(m.static, mega_impl="fast")


# ---- the builder of the CUDA sources, driven with a stand-in compiler --------

_FAKE_NVCC = """#!/bin/sh
# stand-in for nvcc: writes the output file named after -o, talks like ptxas -v
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  src="$1"; shift
done
case "$src" in *broken.cu) echo "broken.cu(1): error: expected a declaration" >&2; exit 2;; esac
echo "ptxas info    : Function properties for kernel" >&2
echo "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" >&2
echo "ptxas info    : Used 40 registers, used 1 barriers" >&2
echo built > "$out"
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    from hnumo_tpu_torch.ops import _build

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("one", "two", "broken"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setenv("CUDA_HOME", str(nvcc.parents[1]))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return _build


def test_build_libraries_builds_each_source_once(fake_toolchain):
    b = fake_toolchain
    assert b.find_nvcc().endswith("cuda/bin/nvcc")
    assert b.resource_usage("one") == []
    b.build_libraries(["one", "two"])
    for name in ("one", "two"):
        assert b.library_path(name).read_text() == "built\n"
        usage = b.resource_usage(name)
        assert usage == ["40 registers, 0 B spill stores, 0 B spill loads"]
    assert not list(b.BUILD_DIR.glob("*.tmp*"))
    # a built library is not compiled again
    stamp = b.library_path("one").stat().st_mtime_ns
    b.build_libraries(["one"])
    assert b.library_path("one").stat().st_mtime_ns == stamp
    # the library's name follows its source
    before = b.library_path("one")
    (b.CSRC_DIR / "one.cu").write_text("// one, changed\n")
    assert b.library_path("one") != before


def test_failed_build_raises_and_leaves_no_library(fake_toolchain):
    b = fake_toolchain
    with pytest.raises(RuntimeError, match="nvcc failed on broken.cu"):
        b.build_libraries(["one", "broken"])
    assert not b.library_path("broken").exists()
    with pytest.raises(RuntimeError, match="nvcc failed on broken.cu"):
        b.load_library("broken")


def test_no_compiler_raises(tmp_path, monkeypatch):
    from hnumo_tpu_torch.ops import _build

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    if _build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this check is for a machine without the CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_libraries(["btp_mega"])
