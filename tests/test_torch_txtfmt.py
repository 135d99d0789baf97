"""The txt snapshot's native formatter (hnumo_tpu_torch/io/_native.py on
io/csrc/txtfmt.cpp) against the Python path it replaces
(io/snapshots._column_plain, '{:23.16e}\\n'.format): byte for byte on the
values that take the edges of the format, on float32-rounded and random
float64 values, at every size around the one-thread limit and at a 25x25
p=4 snapshot's 218,750 values; whole write_txt files byte for byte with
HNUMO_NATIVE=0 and without; the counter of native calls; and the build,
shared with the mesh front end (hnumo_tpu_torch/_hostlib.py), from two
processes at once."""
import os
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hnumo_tpu_torch import _hostlib
from hnumo_tpu_torch.config import Config
from hnumo_tpu_torch.io import _native
from hnumo_tpu_torch.io import snapshots as snap
from hnumo_tpu_torch.model import Model
from test_torch_common import one_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++: the native formatter does not build")

ROOT = Path(__file__).resolve().parents[1]


def _bits(u: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", u))[0]


EDGES = {
    "zero": 0.0, "negative_zero": -0.0,
    "nan": float("nan"), "negative_nan": _bits(0xFFF8000000000000),
    "nan_payload": _bits(0x7FF0000000000001),
    "inf": float("inf"), "negative_inf": float("-inf"),
    "smallest_subnormal": 5e-324, "negative_smallest_subnormal": -5e-324,
    "largest_subnormal": _bits(0x000FFFFFFFFFFFFF), "smallest_normal": 2.2250738585072014e-308,
    "1e300": 1e300, "1e-300": 1e-300, "-1e300": -1e300, "-1e-300": -1e-300,
    "dbl_max": 1.7976931348623157e308, "negative_dbl_max": -1.7976931348623157e308,
    "below_1e100": 9.999999999999999e99, "rounds_to_1e100": 9.9999999999999999e99,
    "1e100": 1e100, "1e-100": 1e-100, "1e-99": 1e-99, "one": 1.0, "minus_one": -1.0,
    # ties at the seventeenth digit: exact values with eighteen, the last a 5
    "tie_down": 1 + 2.0 ** -17, "tie_up": 1 + 3 * 2.0 ** -17,
    "f32_max": float(np.finfo(np.float32).max), "f32_tiny": float(np.finfo(np.float32).tiny),
}
SIZES = (0, 1, 2, _native.THREADED_FROM - 1, _native.THREADED_FROM,
         _native.THREADED_FROM + 1, 218_750)


def native_bytes(values) -> bytes:
    v = np.asarray(values, np.float64)
    buf = np.empty(v.size * _native.value_bytes() + 3, np.uint8)
    buf[:3] = 7                                   # an offset, left as it was
    n = _native.format_into(v, buf, 3)
    assert (buf[:3] == 7).all()
    return buf[3:3 + n].tobytes()


def plain_bytes(values) -> bytes:
    return snap._column_plain(values).encode()


@pytest.fixture(autouse=True)
def native_on(monkeypatch):
    """The native path, whatever the environment says."""
    monkeypatch.delenv("HNUMO_NATIVE", raising=False)
    assert _native.available()


@pytest.mark.parametrize("name", sorted(EDGES))
def test_an_edge_of_the_format_is_written_as_python_writes_it(name):
    v = EDGES[name]
    assert native_bytes([v]) == plain_bytes([v])
    # and inside a column, between ordinary values
    col = [1.5, v, -2.25e-7]
    assert native_bytes(col) == plain_bytes(col)


def test_every_nan_is_written_nan_whatever_its_sign():
    assert native_bytes([EDGES["negative_nan"]]) == b" " * 20 + b"nan\n"


def test_three_digit_exponents_keep_their_natural_width():
    lines = native_bytes([1e100, -1e-300, 1e99]).split(b"\n")
    assert [len(x) for x in lines[:3]] == [23, 24, 23]


def test_every_exact_tie_at_the_seventeenth_digit():
    """m * 2**-k with eighteen significant digits: the correctly rounded
    seventeen digits are a tie to even, as Python's dtoa breaks it."""
    from decimal import Decimal

    ties = [m * 2.0 ** -k for k in range(1, 64) for m in range(1, 4000, 2)
            if len(Decimal(m * 2.0 ** -k).as_tuple().digits) == 18]
    assert len(ties) > 1000
    assert native_bytes(ties) == plain_bytes(ties)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["float32_rounded", "float64"])
def test_a_column_is_written_as_python_writes_it(n, kind):
    rng = np.random.default_rng(n + 17)
    v = rng.standard_normal(n) * 10.0 ** rng.integers(-40, 40, n)
    if kind == "float32_rounded":
        v = v.astype(np.float32).astype(np.float64)
    assert native_bytes(v) == plain_bytes(v)


@pytest.mark.parametrize("threads", [1, 2, 3, 8, 64])
@pytest.mark.parametrize("n", [0, 1, 2, 7, 100])
def test_any_number_of_threads_packs_the_chunks_in_order(threads, n):
    lib = _native.get_lib()
    v = np.random.default_rng(n).standard_normal(n) * 1e5
    buf = np.zeros(max(1, n * _native.value_bytes()), np.uint8)
    got = lib.txtfmt_column(v.ctypes.data, n, buf.ctypes.data, buf.size, threads)
    assert buf[:got].tobytes() == plain_bytes(v)


def test_a_buffer_too_short_is_refused():
    v = np.ones(4)
    with pytest.raises(ValueError, match="need"):
        _native.format_into(v, np.empty(4 * _native.value_bytes() - 1, np.uint8), 0)
    lib = _native.get_lib()
    buf = np.empty(10, np.uint8)
    assert lib.txtfmt_column(v.ctypes.data, 4, buf.ctypes.data, buf.size, 1) == -1


def test_thread_count_follows_the_size_and_the_process(monkeypatch):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(32)))
    assert _native.threads_for(_native.THREADED_FROM - 1) == 1
    assert _native.threads_for(_native.THREADED_FROM) == _native.MAX_THREADS
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {3})
    assert _native.threads_for(10 ** 6) == 1
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1, 2})
    assert _native.threads_for(10 ** 6) == 3


# ---- whole files -----------------------------------------------------------

# the benchmark's double gyre (25x25, p=4, 2 layers, f32), and a lake of 3
# layers in f64 (the double gyre has 2)
DGYRE25 = dict(nelx=25, nely=25, nopx=4, nopy=4, nlayers=2, xdims=(0.0, 2e6),
               ydims=(0.0, 2e6), dt=500.0, dt_btp=25.0, test_case="double_gyre", f0=9.3e-5,
               beta=2e-11, botfr=1, cd_mlswe=1e-7, method_visc=2, visc_mlswe=100.0,
               dtype="float32")
LAKE3 = dict(nelx=8, nely=8, nopx=3, nopy=3, nlayers=3, xdims=(0.0, 2e3), ydims=(0.0, 2e3),
             dt=20.0, dt_btp=2.0, test_case="lakeatrest", dtype="float64")


@pytest.fixture(scope="module", params=[DGYRE25, LAKE3], ids=["dgyre25_p4_L2", "lake8_p3_L3"])
def stepped(request):
    m = Model(Config(**request.param), device="cpu")
    return m, m.step(m.state0)


def test_a_snapshot_file_is_the_python_paths_byte_for_byte(stepped, tmp_path, monkeypatch):
    m, s = stepped
    before = _native.calls["txt_column"]
    native = Path(snap.write_txt(m, s, 1, root="native", outdir=tmp_path)).read_bytes()
    assert _native.calls["txt_column"] == before + 1
    monkeypatch.setenv("HNUMO_NATIVE", "0")
    assert not _native.available()
    plain = Path(snap.write_txt(m, s, 1, root="plain", outdir=tmp_path)).read_bytes()
    assert _native.calls["txt_column"] == before + 1
    with pytest.raises(RuntimeError, match="HNUMO_NATIVE"):
        _native.get_lib()
    assert native == plain and b"nan" not in native
    L, npoin = m.cfg.nlayers, m.geom.coord[..., 0].size
    assert len(native.split(b"\n")) - 1 == 2 + 2 + 2 * npoin + 3 * npoin + 4 * L * npoin + npoin
    r = snap.read_txt(tmp_path / "native0001")
    assert (r["nlayers"], r["npoin"]) == (L, npoin)


# ---- the build -------------------------------------------------------------

FORMAT_ONE = """
import sys
from pathlib import Path
import numpy as np
from hnumo_tpu_torch.io import _native
_native.BUILD_DIR = Path(sys.argv[1])
v = np.array([1.0 / 3.0, -2.5e-300])
buf = np.empty(v.size * _native.value_bytes(), np.uint8)
n = _native.format_into(v, buf, 0)
sys.stdout.write(buf[:n].tobytes().decode())
"""


def test_two_processes_building_at_once_both_load_a_sound_library(tmp_path):
    build_dir = tmp_path / "_build"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    env.pop("HNUMO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", FORMAT_ONE, str(build_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out == plain_bytes([1.0 / 3.0, -2.5e-300]).decode()
    built = sorted(build_dir.iterdir())
    assert built == [_hostlib.library_path(_native.SOURCE, build_dir)]


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "txtfmt.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "SOURCE", bad)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_native, "_LIB", None)
    with pytest.raises(RuntimeError, match="building txtfmt.cpp failed"):
        _native.available()
    assert not list((tmp_path / "_build").glob("*.tmp*"))


def test_both_host_libraries_come_from_one_build():
    from hnumo_tpu_torch.mesh import _native as mesh_native

    for mod, stem in ((_native, "txtfmt"), (mesh_native, "qmesh")):
        lib = _hostlib.library_path(mod.SOURCE)
        assert lib.parent == _hostlib.BUILD_DIR and lib.name.startswith(f"lib{stem}-")
        assert mod.SOURCE.parts[-3:] == (mod.__name__.split(".")[-2], "csrc", f"{stem}.cpp")
    assert mesh_native.library_path() == _hostlib.library_path(mesh_native.SOURCE)
