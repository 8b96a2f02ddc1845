"""Build a CUDA source of ``sbgm_danra_tpu_torch/csrc`` into a shared library and load it.

Each kernel source exports a plain C interface: its launch functions return
``cudaGetLastError()`` and ``sbgm_cuda_error_string`` turns that code into
text. The source is compiled with ``nvcc`` for ``sm_90a`` at first use into
``sbgm_danra_tpu_torch/_build/`` (listed in ``.gitignore``), under a name
that hashes the source with the flags, so an edited source builds anew and an
unchanged one is loaded as it is. The library is loaded with ``ctypes``; the
kernel modules set their functions' argument types.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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


def build(source: Path, name: str) -> BuiltLibrary:
    """Compile ``source`` into ``_build/lib<name>_<hash>.so`` unless it is there; load it."""
    nvcc = find_nvcc()
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    path = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    log = ""
    t0 = time.perf_counter()
    compiled = not path.exists()
    if compiled:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(source)],
                capture_output=True, text=True, timeout=600,
            )
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n{log}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(path))
    lib.sbgm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sbgm_cuda_error_string.restype = ctypes.c_char_p
    return BuiltLibrary(lib, path, compiled, time.perf_counter() - t0, log)


def check_launch(built: BuiltLibrary, rc: int, what: str) -> None:
    """Raise with CUDA's message if a launch function returned a nonzero error code."""
    if rc != 0:
        msg = built.lib.sbgm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {rc})")
