"""Build and load the package's host C++ libraries: plain C interfaces,
bound with ctypes. Two use it: mesh/_native.py (mesh/csrc/qmesh.cpp, the
mesh front end) and io/_native.py (io/csrc/txtfmt.cpp, the txt snapshot's
formatter). The CUDA sources have a build of their own, ops/_build.py.

A library is built with g++ into `hnumo_tpu_torch/_build/` at first use,
under a name that carries a hash of the source and of the flags (an edited
source is never served by a stale library). The build writes a file of its
own and renames it into place, so processes that build at once (test
workers, the ranks of a decomposed run) are safe. `HNUMO_NATIVE=0` turns
the native paths off; so does the absence of g++. Where g++ is present and
the build or the load fails, that raises: it is never hidden behind the
Python path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")


def enabled() -> bool:
    """The native paths are on: not turned off by HNUMO_NATIVE=0, and g++ is
    on PATH."""
    return os.environ.get("HNUMO_NATIVE", "1") != "0" and shutil.which("g++") is not None


def library_path(source: Path, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of the present `source` and flags lives."""
    h = hashlib.sha256(source.read_bytes() + " ".join(CXX_FLAGS).encode())
    return build_dir / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path, build_dir: Path = BUILD_DIR) -> Path:
    """Compile `source` unless its library exists; returns its path.
    Raises (with the compiler's output) if the compiler fails."""
    out = library_path(source, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(source)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"building {source.name} failed:\n{' '.join(cmd)}\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load(source: Path, build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """The library of `source`, built if need be and loaded. Raises where
    the native paths are off, or if the build or the load fails."""
    if not enabled():
        raise RuntimeError(f"native {source.stem} is off (HNUMO_NATIVE=0, or no g++ on PATH)")
    return ctypes.CDLL(str(build(source, build_dir)))
