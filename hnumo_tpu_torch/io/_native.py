"""ctypes binding for the txt snapshot's native formatter (io/csrc/txtfmt.cpp).

`format_into` writes float64 values into a byte buffer exactly as
io/snapshots._column_plain does with Python's '{:23.16e}\\n'.format, byte
for byte (tests/test_torch_txtfmt.py), in a few milliseconds where Python
takes some hundreds for a 25x25 snapshot. io/snapshots.write_txt takes it
where it is available and keeps the Python path as the oracle.

The library is built with g++ into `hnumo_tpu_torch/_build/` at first use
by the package's host build (`_hostlib.py`). `HNUMO_NATIVE=0`, or no g++ on
PATH, selects the Python path; where g++ is present and the build or the
load fails, that raises. The formatter runs without the interpreter lock
(a ctypes call) on 1 thread below THREADED_FROM values, else on as many as
the process may run on, at most MAX_THREADS. `calls` counts the native
calls, the record of which path ran.
"""
from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

from .. import _hostlib
from .._hostlib import enabled

SOURCE = Path(__file__).resolve().parent / "csrc" / "txtfmt.cpp"
BUILD_DIR = _hostlib.BUILD_DIR
# below this many values a column is formatted on one thread
THREADED_FROM = 32768
MAX_THREADS = 8

_LIB: ctypes.CDLL | None = None

# native calls since import (or since a caller reset them)
calls = {"txt_column": 0}


def get_lib() -> ctypes.CDLL:
    """The loaded library (built at the first call). Raises where the native
    path is off, or if the build or the load fails."""
    global _LIB
    if _LIB is not None and enabled():
        return _LIB
    lib = _hostlib.load(SOURCE, BUILD_DIR)
    lib.txtfmt_value_bytes.argtypes = []
    lib.txtfmt_value_bytes.restype = ctypes.c_int64
    lib.txtfmt_column.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_int]
    lib.txtfmt_column.restype = ctypes.c_int64
    _LIB = lib
    return lib


def available() -> bool:
    """The native path is on; builds and loads the library if it is (a
    failure there raises)."""
    if not enabled():
        return False
    get_lib()
    return True


def value_bytes() -> int:
    """The most bytes one formatted value takes, its newline included."""
    return int(get_lib().txtfmt_value_bytes())


def threads_for(n: int) -> int:
    """Threads for a column of `n` values: 1 below THREADED_FROM, else the
    CPUs this process may run on, at most MAX_THREADS."""
    if n < THREADED_FROM:
        return 1
    return max(1, min(MAX_THREADS, len(os.sched_getaffinity(0))))


def format_into(values: np.ndarray, out: np.ndarray, offset: int) -> int:
    """Write the float64 `values`, one a line as '{:23.16e}\\n', into the
    uint8 buffer `out` from byte `offset`, which must leave room for
    len(values) * value_bytes(); returns the number of bytes written."""
    lib = get_lib()
    x = np.ascontiguousarray(values, dtype=np.float64).ravel()
    n = x.size
    if out.dtype != np.uint8 or out.ndim != 1 or not out.flags.c_contiguous \
            or not out.flags.writeable:
        raise ValueError("out must be a writable contiguous 1-D uint8 array")
    cap = out.size - offset
    if offset < 0 or cap < n * value_bytes():
        raise ValueError(f"out holds {cap} bytes from offset {offset}, "
                         f"{n} values need {n * value_bytes()}")
    calls["txt_column"] += 1
    written = lib.txtfmt_column(x.ctypes.data, n, out.ctypes.data + offset, cap,
                                threads_for(n))
    if written < 0:
        raise RuntimeError(f"txtfmt_column refused {n} values in {cap} bytes")
    return int(written)
