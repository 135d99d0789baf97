"""How the PyTorch package chooses the barotropic path: the `mega`,
`fused_tail` and `uni_volume` options of Config, the envelopes of
StaticConfig.mega / .fused_tail / .uni_volume, the order in which they are
asked, and the implementation switches `mega_impl` and `tail_impl`. Nothing
here needs a CUDA device."""
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


# ---- fused_tail, uni_volume and tail_impl ------------------------------------------


@pytest.mark.parametrize("option", ["fused_tail", "uni_volume"])
@pytest.mark.parametrize("value", ["onn", "", "ON", "auto", None, True])
def test_on_off_options_are_validated(option, value):
    with pytest.raises(ValueError, match=option):
        Config(**SMALL, **{option: value})


@pytest.mark.parametrize("option", ["fused_tail", "uni_volume"])
def test_on_off_options_default_to_off_as_in_the_jax_package(option):
    from hnumo_tpu.config import Config as JaxConfig

    assert getattr(Config(**SMALL), option) == "off" == getattr(JaxConfig(), option)
    assert getattr(Config(**SMALL, **{option: "on"}), option) == "on"


@pytest.mark.parametrize("impl", ["pallas", "", "cuda"])
def test_tail_impl_is_validated(impl):
    with pytest.raises(ValueError, match="tail_impl"):
        Model(Config(**SMALL), device="cpu", tail_impl=impl)


def test_tail_kernel_on_the_cpu_raises():
    with pytest.raises(ValueError, match="tail_impl='kernel' needs a CUDA device"):
        Model(Config(**SMALL, mega="off", fused_tail="on"), device="cpu", tail_impl="kernel")
    m = Model(Config(**SMALL, mega="off", fused_tail="on"), device="cpu", tail_impl="plain")
    assert m.static.tail_impl == "plain"


def test_static_config_rejects_unknown_tail_impl():
    import dataclasses

    m = Model(Config(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="tail_impl"):
        dataclasses.replace(m.static, tail_impl="fast")


@pytest.mark.parametrize("nelx,nely,mega,want_mega", [
    (6, 5, "auto", True),       # under 1024 elements the megakernel is asked first
    (32, 32, "auto", True),
    (6, 5, "off", False),
    (33, 32, "auto", False),    # over the cap "auto" leaves the solve to fused_tail
    (6, 5, "on", True),
])
def test_mega_beats_fused_tail(nelx, nely, mega, want_mega):
    """Both flags can be up at once, as in the JAX package; barotropic_solve
    asks `mega` first, and Model builds the operands of the path that runs."""
    m = Model(Config(**{**SMALL, "nelx": nelx, "nely": nely, "nopx": 1, "nopy": 1},
                     mega=mega, fused_tail="on"), device="cpu")
    assert m.static.fused_tail
    assert m.static.mega is want_mega
    assert (m.mega_ops is not None) is want_mega
    assert (m.tail_ops is not None) is (not want_mega)


def test_solve_with_both_flags_up_runs_the_megakernel_path():
    from hnumo_tpu_torch.ops import btp_tail, btp_volume_uni

    m = Model(Config(**SMALL, dt=40.0, dt_btp=20.0, fused_tail="on"), device="cpu")
    assert m.static.mega and m.static.fused_tail
    before = (btp_volume_uni.btp_volume_uni_plain.calls, btp_tail.btp_faces_plain.calls,
              btp_tail.btp_update_plain.calls)
    s = m.step(m.state0)
    assert bool(s.ok)
    assert before == (btp_volume_uni.btp_volume_uni_plain.calls,
                      btp_tail.btp_faces_plain.calls, btp_tail.btp_update_plain.calls)
    # the same configuration with mega="off" does run the three stages
    m2 = Model(Config(**SMALL, dt=40.0, dt_btp=20.0, fused_tail="on", mega="off"),
               device="cpu")
    m2.step(m2.state0)
    nsub = 2 * m2.static.n_btp * m2.static.kstages
    assert btp_tail.btp_faces_plain.calls - before[1] == nsub
    assert btp_tail.btp_update_plain.calls - before[2] == nsub
    assert btp_volume_uni.btp_volume_uni_plain.calls - before[0] == nsub


@pytest.mark.parametrize("option", ["fused_tail", "uni_volume"])
@pytest.mark.parametrize("over", [
    dict(x_boundary=(3, 3)),
    dict(ti_method_btp="lsrk"),
    dict(method_visc=1, visc_mlswe=10.0),
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_fused_options_on_outside_what_is_ported_raise(option, over):
    with pytest.raises((ValueError, NotImplementedError)):
        Model(Config(**{**SMALL, **over}, mega="off", **{option: "on"}), device="cpu")


@pytest.mark.parametrize("option", ["fused_tail", "uni_volume"])
def test_on_outside_the_envelope_raises_and_names_it(option, monkeypatch):
    """`on` never quietly takes the other path: a grid whose metrics differ
    between elements (here: the uniformity tolerance set to nothing) raises."""
    import numpy as np

    from hnumo_tpu_torch.mesh import grid

    real = grid.build_geometry

    def stretched(*a, **k):
        geom = real(*a, **k)
        geom.ksiq_x[0, 0] *= 1.0 + 1e-6      # one element with another metric
        return geom

    monkeypatch.setattr("hnumo_tpu_torch.model.build_geometry", stretched)
    with pytest.raises(ValueError, match="envelope"):
        Model(Config(**SMALL, mega="off", **{option: "on"}), device="cpu")
    m = Model(Config(**SMALL, mega="off"), device="cpu")
    assert not m.static.uniform_geom and np.ptp(m.geom.ksiq_x) > 0


@pytest.mark.parametrize("replace,fused,uni", [
    (dict(), True, True),
    (dict(uniform_geom=False), False, False),
    (dict(ti_method_btp="lsrk"), False, True),
    (dict(method_visc=1, visc_mlswe=10.0), False, True),
    (dict(method_visc=1, visc_mlswe=0.0), True, True),    # no viscosity: family unused
    (dict(fused_tail_on=False), False, True),
    (dict(uni_volume_on=False), True, False),
])
def test_static_envelopes_are_the_jax_package_s(replace, fused, uni):
    import dataclasses

    m = Model(Config(**SMALL, mega="off", fused_tail="on", uni_volume="on",
                     method_visc=2, visc_mlswe=10.0), device="cpu")
    st = dataclasses.replace(m.static, **replace)
    assert st.fused_tail is fused and st.uni_volume is uni


@pytest.mark.parametrize("nel", [16, 64, 128, 256])
def test_brick_grids_count_as_uniform_at_every_size(nel):
    """The rounding of the metrics grows with the elements across the domain;
    the uniformity test allows for it (p=1 keeps this cheap)."""
    m = Model(Config(**{**SMALL, "nelx": nel, "nely": nel, "nopx": 1, "nopy": 1},
                     mega="off", fused_tail="on"), device="cpu")
    assert m.static.uniform_geom and m.static.fused_tail


# ---- the builder of the CUDA sources, driven with a stand-in compiler --------

PORT_SOURCES = ("btp_volume", "btp_mega", "btp_volume_uni", "btp_faces", "btp_update")

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
    for name in ("one", "two", "broken") + PORT_SOURCES:
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


def test_library_follows_the_headers_its_source_includes(fake_toolchain):
    """A header of csrc/ that a source includes, directly or through another
    header, enters the library's name: a changed header is built anew."""
    b = fake_toolchain
    (b.CSRC_DIR / "one.cu").write_text('// one\n#include "shared.cuh"\n#include <cuda_runtime.h>\n')
    (b.CSRC_DIR / "shared.cuh").write_text('#pragma once\n  #  include "deep.cuh"\n')
    (b.CSRC_DIR / "deep.cuh").write_text("// deep\n")
    assert [f.name for f in b.source_files("one")] == ["one.cu", "shared.cuh", "deep.cuh"]
    assert [f.name for f in b.source_files("two")] == ["two.cu"]
    first, other = b.library_path("one"), b.library_path("two")
    b.build_libraries(["one", "two"])
    (b.CSRC_DIR / "deep.cuh").write_text("// deep, changed\n")
    assert b.library_path("one") != first and not b.library_path("one").exists()
    assert b.library_path("two") == other
    b.build_libraries(["one"])
    assert b.library_path("one").read_text() == "built\n"
    (b.CSRC_DIR / "shared.cuh").write_text("#pragma once\n")
    assert b.library_path("one") not in (first,)
    assert [f.name for f in b.source_files("one")] == ["one.cu", "shared.cuh"]
    (b.CSRC_DIR / "one.cu").write_text('#include "missing.cuh"\n')
    with pytest.raises(RuntimeError, match="missing.cuh"):
        b.library_path("one")


def test_defines_build_a_variant_beside_the_default(fake_toolchain):
    """Inside `variant(...)` a source is built with the switches into a library
    of its own; outside, the default build is untouched."""
    b = fake_toolchain
    plain = b.library_path("one")
    with b.variant("FLAG=1"):
        variant = b.library_path("one")
        assert plain != variant
        b.build_libraries(["one"])
        assert variant.exists() and not plain.exists()
        assert "-DFLAG=1" in b.compile_command("one", variant)
        assert b.resource_usage("one")
        with pytest.raises(RuntimeError, match="nvcc failed"):
            b.build_libraries(["broken"])
    assert b.library_path("one") == plain
    assert not any(a.startswith("-D") for a in b.compile_command("one", plain))
    assert b.resource_usage("one") == []


def test_the_volume_sources_share_one_header():
    from hnumo_tpu_torch.ops import _build

    for name in ("btp_volume", "btp_volume_uni"):
        assert [f.name for f in _build.source_files(name)] == [f"{name}.cu",
                                                               "btp_volume_common.cuh"]
    for name in ("btp_faces", "btp_update"):
        assert [f.name for f in _build.source_files(name)] == [
            f"{name}.cu", "btp_tail_common.cuh", "btp_volume_common.cuh"]
    # the megakernel takes the launch plan and the cp.async primitives from it
    assert [f.name for f in _build.source_files("btp_mega")] == ["btp_mega.cu",
                                                                "btp_volume_common.cuh"]


def test_the_tail_header_enters_the_face_and_update_libraries(tmp_path, monkeypatch):
    """A change of btp_tail_common.cuh builds F and U anew and leaves the
    volume kernels' libraries as they were; a change of the volume kernels'
    header builds all four anew, and the megakernel, which includes it too."""
    import shutil

    from hnumo_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    names = ("btp_volume", "btp_volume_uni", "btp_faces", "btp_update", "btp_mega")
    first = {n: _build.library_path(n) for n in names}
    tail = csrc / "btp_tail_common.cuh"
    tail.write_text(tail.read_text() + "// changed\n")
    second = {n: _build.library_path(n) for n in names}
    assert [second[n] != first[n] for n in names] == [False, False, True, True, False]
    vol = csrc / "btp_volume_common.cuh"
    vol.write_text(vol.read_text() + "// changed\n")
    third = {n: _build.library_path(n) for n in names}
    assert [third[n] != second[n] for n in names] == [True, True, True, True, True]


def test_resource_usage_names_the_instantiations(fake_toolchain):
    b = fake_toolchain
    b.build_libraries(["one"])
    log = b.library_path("one").with_suffix(".log")
    log.write_text(
        "ptxas info    : Compiling entry function '_ZN3abc6kernelIfLi5ELi9EEEvNS_4ArgsIT_EE'"
        " for 'sm_90a'\n    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 80 registers\n"
        "ptxas info    : Compiling entry function '_ZN3abc6kernelIdLi0ELi0EEEvNS_4ArgsIT_EE'"
        " for 'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 144 registers\n")
    assert b.resource_usage("one") == [
        "f<5,9>: 80 registers, 8 B spill stores, 4 B spill loads",
        "d<0,0>: 144 registers, 0 B spill stores, 0 B spill loads"]


def test_build_libraries_builds_the_five_sources_side_by_side(fake_toolchain):
    b = fake_toolchain
    b.build_libraries(PORT_SOURCES)
    libs = {b.library_path(name) for name in PORT_SOURCES}
    assert len(libs) == 5 and all(p.read_text() == "built\n" for p in libs)
    for name in PORT_SOURCES:
        assert b.compile_command(name, b.library_path(name))[-1].endswith(f"{name}.cu")


def test_every_cuda_source_of_the_package_is_one_the_smoke_run_builds():
    import pathlib

    from hnumo_tpu_torch.ops import _build

    on_disk = {p.stem for p in pathlib.Path(_build.CSRC_DIR).glob("*.cu")}
    assert on_disk == set(PORT_SOURCES)
    smoke = (pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    for name in PORT_SOURCES:
        assert f'"{name}"' in smoke


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
