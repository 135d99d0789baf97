"""Build the package's CUDA sources into shared libraries, at first use.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers), is
compiled by `nvcc` for sm_90a into `hnumo_tpu_torch/_build/` and loaded
with ctypes. The library file carries a hash of its source, of the headers
of `csrc/` that the source includes, and of the flags, so an unchanged source
is compiled once per build directory and a changed header is never left with
a stale library. Inside `with variant("NAME=VALUE", ...)` every source is
built with those `-D` switches into a library of its own beside the default
one, and loaded from there: a measurement's hook. Nothing here runs at
import: `load_library` is called by a kernel's wrapper the first time it
launches; `build_libraries` compiles several sources side by side ahead of
that, and `build_variants` several variants of them. A missing compiler or a
failed build raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)

_loaded: dict[tuple, ctypes.CDLL] = {}
_defines: tuple[str, ...] = ()      # the `-D` switches of the variant in force


@contextlib.contextmanager
def variant(*defines: str):
    """Within the block, sources are built with `-D<define>` for each of
    `defines` (`NAME=VALUE` strings), and the kernels' wrappers load those
    builds instead of the default ones."""
    global _defines
    before, _defines = _defines, tuple(defines)
    try:
        yield
    finally:
        _defines = before


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of hnumo_tpu_torch cannot be built")


def source_files(name: str) -> list[Path]:
    """`csrc/<name>.cu` and, after it, every file of `csrc/` that it includes
    with `#include "..."`, directly or through another such file."""
    files = [CSRC_DIR / f"{name}.cu"]
    for f in files:     # grows while it is walked
        for inc in _INCLUDE.findall(f.read_text()):
            path = CSRC_DIR / inc
            if path not in files:
                if not path.is_file():
                    raise RuntimeError(f"{f.name} includes \"{inc}\", which is not in "
                                       f"{CSRC_DIR}")
                files.append(path)
    return files


def library_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` is (or will be) built."""
    h = hashlib.sha256()
    for f in source_files(name):
        h.update(f.read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *_defines)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def compile_command(name: str, out: Path) -> list[str]:
    return [find_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in _defines), "-o", str(out),
            str(CSRC_DIR / f"{name}.cu")]


def build_libraries(names) -> None:
    """Compile every `csrc/<name>.cu` whose library is not built yet: one
    nvcc process per source, all started together, then waited for."""
    build_variants(names, [_defines])


def build_variants(names, variants) -> None:
    """`build_libraries(names)` within `variant(*defines)` for each tuple of
    `defines` in `variants`, all nvcc processes started together."""
    global _defines
    started = []
    try:
        for defines in variants:
            before, _defines = _defines, tuple(defines)
            try:
                for name in names:
                    lib_path = library_path(name)
                    if (name, _defines) in _loaded or lib_path.is_file():
                        continue
                    BUILD_DIR.mkdir(parents=True, exist_ok=True)
                    tmp = lib_path.with_suffix(f".tmp{os.getpid()}.so")
                    proc = subprocess.Popen(compile_command(name, tmp),
                                            stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)
                    started.append((name, proc, tmp, lib_path))
            finally:
                _defines = before
        for name, proc, tmp, lib_path in started:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                    f"{stdout}\n{stderr}")
            # what ptxas says of each kernel (registers, spills, shared memory)
            lib_path.with_suffix(".log").write_text(stderr)
            os.replace(tmp, lib_path)   # atomic: a concurrent build wins or loses whole
    finally:
        for _, proc, _, _ in started:   # a failed build leaves no compiler running
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def resource_usage(name: str) -> list[str]:
    """What `ptxas -v` said of each kernel instantiation in the build of
    `csrc/<name>.cu`, in the order compiled: "R registers, S B spill stores,
    L B spill loads", led by the instantiation's template arguments where the
    entry's name shows them ("f<5,9>: ..."); empty when the library was not
    built by this module."""
    log = library_path(name).with_suffix(".log")
    if not log.is_file():
        return []
    text = log.read_text()
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
    regs = re.findall(r"Used (\d+) registers", text)
    entries = re.findall(r"Compiling entry function '([^']+)'", text)
    tags = []
    for e in entries:
        targs = re.search(r"I([a-z])((?:Li\d+E)+)E", e)
        tags.append(f"{targs.group(1)}<{','.join(re.findall(r'Li(\d+)E', targs.group(2)))}>: "
                    if targs else "")
    if len(tags) != len(regs):
        tags = [""] * len(regs)
    return [f"{t}{r} registers, {s} B spill stores, {l} B spill loads"
            for t, r, (s, l) in zip(tags, regs, spills)]


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if its library is not built yet, and load it."""
    key = (name, _defines)
    if key in _loaded:
        return _loaded[key]
    build_libraries([name])
    lib = ctypes.CDLL(str(library_path(name)))
    _loaded[key] = lib
    return lib
