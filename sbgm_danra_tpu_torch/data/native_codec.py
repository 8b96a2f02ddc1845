"""ctypes binding to the native chunk codec (counterpart of
``sbgm_danra_tpu/data/native_codec.py``), built from the port's own copy of
the source, ``sbgm_danra_tpu_torch/csrc/zarr_codec.cpp``.

One C call per chunk does file read + zlib inflate + crop copy with the GIL
released (``ctypes.CDLL``), so loader and window-stager threads decode in
parallel. It changes the host's decode rate only: ``data/zarrlite.py``'s
chunk path gives the same arrays through it or through ``zlib``.

Policy (as JAX's): the codec is used on hosts with more than 2 CPU cores,
where its GIL-released threading pays; ``SBGM_ZARR_CODEC_FORCE=1`` always
uses it, ``SBGM_ZARR_CODEC_DISABLE=1`` never does. On an 8-core H100 host it
gave the threaded host loader (``data/loader.py``) 1.3-1.4x zlib's samples/s
at 4 and 8 workers, and nothing on one thread (``profile_port.py --paths
host_decode``, ``PERF.md`` §6). Unlike JAX, the
library is compiled at first use with the system C++ compiler and ``-lz``
into ``sbgm_danra_tpu_torch/_build/`` (``ops/_nvcc.build_host``), and a build
that fails where the policy asks for the codec raises with the compiler's
message instead of falling back quietly. A decode error (a missing or corrupt
chunk file) raises too. The decode path a process takes is logged once
(``decode_path``).
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional, Tuple

import numpy as np

from sbgm_danra_tpu_torch.ops import _nvcc

logger = logging.getLogger(__name__)

SOURCE = _nvcc.CSRC_DIR / "zarr_codec.cpp"
_STATUS = {1: "cannot open the chunk file", 2: "read error", 3: "zlib inflate failed",
           4: "crop window out of bounds", 5: "chunk size mismatch"}

_lib: Optional[ctypes.CDLL] = None
_checked = False
_lock = threading.Lock()  # loader threads race for the first build


def enabled_by_policy() -> bool:
    if os.environ.get("SBGM_ZARR_CODEC_DISABLE") == "1":
        return False
    if os.environ.get("SBGM_ZARR_CODEC_FORCE") == "1":
        return True
    return (os.cpu_count() or 1) > 2


def load_library() -> Optional[ctypes.CDLL]:
    """The codec library, built at first use, or None where the policy keeps
    the ``zlib`` path. A failed build raises (and is tried again next call)."""
    if _checked:
        return _lib
    with _lock:
        return _load()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _checked
    if _checked:
        return _lib
    if not enabled_by_policy():
        _checked = True
        logger.info("chunk decode path: zlib (native codec off on a %d-core host; "
                    "SBGM_ZARR_CODEC_FORCE=1 overrides)", os.cpu_count() or 1)
        return None
    built = _nvcc.build_host(SOURCE, "zarr_codec", libs=("-lz",))
    lib = built.lib
    lib.decompress_crop.restype = ctypes.c_int
    lib.decompress_crop.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    _lib, _checked = lib, True
    logger.info("chunk decode path: native codec %s (%s, %.2f s)", built.path.name,
                "compiled" if built.compiled else "cached", built.seconds)
    return _lib


def available() -> bool:
    return load_library() is not None


def decode_path() -> str:
    """'native' or 'zlib': the path this process's chunk reads take."""
    return "native" if available() else "zlib"


def reset() -> None:
    """Forget the policy's decision (after a change of the environment)."""
    global _lib, _checked
    _lib, _checked = None, False


def decompress_crop(
    path: str,
    compressed: bool,
    chunk_shape: Tuple[int, int],
    dtype: np.dtype,
    window: Tuple[int, int, int, int],
) -> Optional[np.ndarray]:
    """Native read of a 2-D chunk's crop ``window`` (x1, x2, y1, y2); None
    when the policy keeps the zlib path or the dtype is not a little-endian
    4- or 8-byte type (the caller decodes with zlib). A decode error raises
    ``OSError`` with the codec's status."""
    lib = load_library()
    if lib is None:
        return None
    dtype = np.dtype(dtype)
    if dtype.itemsize not in (4, 8) or dtype.byteorder == ">":
        return None
    x1, x2, y1, y2 = window
    out = np.empty((x2 - x1, y2 - y1), dtype=dtype)
    rc = lib.decompress_crop(
        path.encode(), int(compressed),
        chunk_shape[0], chunk_shape[1], dtype.itemsize,
        x1, x2, y1, y2,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise OSError(f"native chunk codec: {_STATUS.get(rc, 'error')} (status {rc}) "
                      f"for {path}")
    return out

