"""Build a source of ``sbgm_danra_tpu_torch/csrc`` into a shared library and load it.

Each kernel source exports a plain C interface: its launch functions return
``cudaGetLastError()`` and ``sbgm_cuda_error_string`` turns that code into
text. The source is compiled with ``nvcc`` for ``sm_90a`` at first use into
``sbgm_danra_tpu_torch/_build/`` (listed in ``.gitignore``), under a name
that hashes the source, the headers of ``csrc`` it includes and the flags, so
an edited source or header builds anew and an unchanged one is loaded as it
is. The library is loaded with ``ctypes``; the kernel modules set their
functions' argument types. ``build_host`` does the same for a host-only C++
source (the chunk codec) with the system C++ compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")


class BuiltLibrary(NamedTuple):
    """The loaded library, where it lives, and how its build went."""

    lib: ctypes.CDLL
    path: Path
    compiled: bool  # False: an earlier build of the same source and flags was loaded
    seconds: float
    log: str


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin and /usr/local/cuda/bin): "
        f"the CUDA kernels are compiled from {CSRC_DIR} at first use and need the CUDA toolkit"
    )


def find_cxx() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler found ($CXX, c++, g++ on PATH): the chunk codec is "
                       f"compiled from {CSRC_DIR} at first use")


def digest(source: Path, flags=NVCC_FLAGS) -> str:
    """Hash of ``source``, the local headers it includes (``#include "..."``,
    beside it) and the flags."""
    text = source.read_bytes()
    headers = re.findall(rb'^#include "([^"]+)"', text, re.M)
    parts = [text, *((source.parent / h.decode()).read_bytes() for h in headers)]
    return hashlib.sha256(b"\0".join(parts) + " ".join(flags).encode()).hexdigest()


def _compile(compiler: str, flags, libs, source: Path, name: str) -> BuiltLibrary:
    """Compile ``source`` into ``_build/lib<name>_<hash>.so`` unless it is
    there; load it. A failed compile raises with the compiler's output."""
    path = BUILD_DIR / f"lib{name}_{digest(source, (*flags, *libs))[:16]}.so"
    log = ""
    t0 = time.perf_counter()
    compiled = not path.exists()
    if compiled:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [compiler, *flags, "-o", tmp, str(source), *libs],
                capture_output=True, text=True, timeout=600,
            )
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"{os.path.basename(compiler)} failed ({proc.returncode}) "
                                   f"on {source}:\n{log}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(path))
    return BuiltLibrary(lib, path, compiled, time.perf_counter() - t0, log)


def build(source: Path, name: str) -> BuiltLibrary:
    """Compile a CUDA ``source`` with nvcc for sm_90a (unless built); load it."""
    built = _compile(find_nvcc(), NVCC_FLAGS, (), source, name)
    built.lib.sbgm_cuda_error_string.argtypes = [ctypes.c_int]
    built.lib.sbgm_cuda_error_string.restype = ctypes.c_char_p
    return built


def build_host(source: Path, name: str, libs=()) -> BuiltLibrary:
    """Compile a host C++ ``source`` with the system compiler, linking
    ``libs`` (unless built); load it."""
    return _compile(find_cxx(), CXX_FLAGS, tuple(libs), source, name)


def check_launch(built: BuiltLibrary, rc: int, what: str) -> None:
    """Raise with CUDA's message if a launch function returned a nonzero error code."""
    if rc != 0:
        msg = built.lib.sbgm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {rc})")
