"""Minimal zarr-v2-compatible chunked array storage (a copy of
``sbgm_danra_tpu/data/zarrlite.py`` that decodes through ``zlib`` alone).

Daily fields live in zarr directory stores: one group per day file, one array
per npz key. This module implements the subset of the zarr v2 on-disk format
the data path needs:

- directory store with ``.zgroup`` / ``.zarray`` JSON metadata;
- C-order chunks in dot-separated key files (``0.0``);
- raw or zlib compression (zlib via the stdlib);
- partial reads: ``arr[a:b, c:d]`` touches only the chunks that intersect the
  requested window.

A 2-D chunk is read through the native codec (``data/native_codec.py``: read,
inflate and crop in one C call with the GIL released) where its policy asks
for it, else through ``zlib``; both give the same array.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from sbgm_danra_tpu_torch.data import native_codec

_ZGROUP = ".zgroup"
_ZARRAY = ".zarray"


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def _read_json(path: str):
    with open(path, "r") as f:
        return json.load(f)


class ZArray:
    """A chunked N-d array inside a directory store."""

    def __init__(self, path: str):
        self.path = path
        meta = _read_json(os.path.join(path, _ZARRAY))
        if meta.get("zarr_format") != 2:
            raise ValueError(f"Unsupported zarr format in {path}: {meta.get('zarr_format')}")
        self.shape: Tuple[int, ...] = tuple(meta["shape"])
        self.chunks: Tuple[int, ...] = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.fill_value = meta.get("fill_value", 0)
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") not in ("zlib",):
            raise ValueError(
                f"Unsupported compressor {comp.get('id')} in {path}; "
                "this store supports zlib or raw chunks"
            )
        self.compressor = comp
        if meta.get("order", "C") != "C":
            raise ValueError("Only C-order arrays are supported")
        if meta.get("filters"):
            raise ValueError("zarr filters are not supported")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    # -- chunk IO -----------------------------------------------------------

    def _chunk_path(self, idx: Sequence[int]) -> str:
        return os.path.join(self.path, ".".join(str(i) for i in idx))

    def _read_chunk(self, idx: Sequence[int]) -> np.ndarray:
        p = self._chunk_path(idx)
        if not os.path.exists(p):
            return np.full(self.chunks, self.fill_value, dtype=self.dtype)
        with open(p, "rb") as f:
            raw = f.read()
        if self.compressor is not None:
            raw = zlib.decompress(raw)
        return np.frombuffer(raw, dtype=self.dtype).reshape(self.chunks).copy()

    def _write_chunk(self, idx: Sequence[int], data: np.ndarray) -> None:
        raw = np.ascontiguousarray(data, dtype=self.dtype).tobytes()
        if self.compressor is not None:
            raw = zlib.compress(raw, self.compressor.get("level", 1))
        with open(self._chunk_path(idx), "wb") as f:
            f.write(raw)

    # -- reading ------------------------------------------------------------

    def __getitem__(self, key) -> np.ndarray:
        if key is Ellipsis or key == ():
            key = tuple(slice(None) for _ in self.shape)
        if not isinstance(key, tuple):
            key = (key,)
        if len(key) < self.ndim:
            key = key + tuple(slice(None) for _ in range(self.ndim - len(key)))
        squeeze_axes = []
        ranges: List[Tuple[int, int]] = []
        for axis, k in enumerate(key):
            n = self.shape[axis]
            if isinstance(k, int):
                if k < 0:
                    k += n
                if not 0 <= k < n:
                    raise IndexError(f"index {k} out of bounds for axis {axis} of size {n}")
                ranges.append((k, k + 1))
                squeeze_axes.append(axis)
            elif isinstance(k, slice):
                start, stop, step = k.indices(n)
                if step != 1:
                    raise IndexError("strided reads are not supported")
                ranges.append((start, stop))
            else:
                raise IndexError(f"unsupported index: {k!r}")

        out_shape = tuple(hi - lo for lo, hi in ranges)
        out = np.empty(out_shape, dtype=self.dtype)

        # iterate over intersecting chunks only
        chunk_ranges = [
            range(lo // c, (max(hi - 1, lo)) // c + 1) if hi > lo else range(0)
            for (lo, hi), c in zip(ranges, self.chunks)
        ]

        def rec(axis: int, idx: List[int]):
            if axis == self.ndim:
                src_sel, dst_sel = [], []
                for ax, (ci, (lo, hi), c) in enumerate(zip(idx, ranges, self.chunks)):
                    c0 = ci * c
                    s_lo = max(lo, c0)
                    s_hi = min(hi, c0 + c)
                    src_sel.append(slice(s_lo - c0, s_hi - c0))
                    dst_sel.append(slice(s_lo - lo, s_hi - lo))
                # native path: a 2-D chunk's read + inflate + crop in one C call
                p = self._chunk_path(idx)
                if self.ndim == 2 and native_codec.available() and os.path.exists(p):
                    window = (src_sel[0].start, src_sel[0].stop,
                              src_sel[1].start, src_sel[1].stop)
                    cropped = native_codec.decompress_crop(
                        p, self.compressor is not None, self.chunks, self.dtype, window)
                    if cropped is not None:
                        out[tuple(dst_sel)] = cropped
                        return
                chunk = self._read_chunk(idx)
                out[tuple(dst_sel)] = chunk[tuple(src_sel)]
                return
            for ci in chunk_ranges[axis]:
                rec(axis + 1, idx + [ci])

        if all(hi > lo for lo, hi in ranges):
            rec(0, [])
        if squeeze_axes:
            out = np.squeeze(out, axis=tuple(squeeze_axes))
        return out


class Group:
    """A zarr v2 group: a directory containing arrays and sub-groups."""

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.mode = mode
        if mode == "r":
            if not os.path.isdir(path):
                raise FileNotFoundError(f"No zarr group at {path}")
        elif mode == "w":
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.makedirs(path, exist_ok=True)
            _write_json(os.path.join(path, _ZGROUP), {"zarr_format": 2})
        elif mode == "a":
            os.makedirs(path, exist_ok=True)
            if not os.path.exists(os.path.join(path, _ZGROUP)):
                _write_json(os.path.join(path, _ZGROUP), {"zarr_format": 2})
        else:
            raise ValueError(f"Unknown mode: {mode}")

    # -- inspection ---------------------------------------------------------

    def keys(self) -> List[str]:
        out = []
        for name in sorted(os.listdir(self.path)):
            sub = os.path.join(self.path, name)
            if os.path.isdir(sub):
                out.append(name)
        return out

    def __contains__(self, name: str) -> bool:
        return os.path.isdir(os.path.join(self.path, name))

    def __getitem__(self, name: str) -> Union["Group", ZArray]:
        sub = os.path.join(self.path, *name.split("/"))
        if os.path.exists(os.path.join(sub, _ZARRAY)):
            return ZArray(sub)
        if os.path.isdir(sub):
            return Group(sub, mode="r" if self.mode == "r" else "a")
        raise KeyError(name)

    # -- creation -----------------------------------------------------------

    def _check_writable(self):
        if self.mode == "r":
            raise PermissionError(f"Group {self.path} opened read-only")

    def create_group(self, name: str) -> "Group":
        self._check_writable()
        sub = os.path.join(self.path, *name.split("/"))
        os.makedirs(sub, exist_ok=True)
        meta = os.path.join(sub, _ZGROUP)
        if not os.path.exists(meta):
            _write_json(meta, {"zarr_format": 2})
        return Group(sub, mode="a")

    def array(
        self,
        name: str,
        data: np.ndarray,
        chunks: Optional[Sequence[int]] = None,
        compressor: Optional[str] = "zlib",
        level: int = 1,
    ) -> ZArray:
        """Create (or overwrite) an array member from an in-memory ndarray."""
        self._check_writable()
        data = np.asarray(data)
        sub = os.path.join(self.path, *name.split("/"))
        if os.path.isdir(sub):
            shutil.rmtree(sub)
        os.makedirs(sub, exist_ok=True)
        if chunks is None:
            chunks = _auto_chunks(data.shape, data.dtype.itemsize) if data.ndim else (1,)
        chunks = tuple(int(min(c, s)) if s else 1 for c, s in zip(chunks, data.shape))
        comp = {"id": "zlib", "level": level} if compressor == "zlib" else None
        meta = {
            "zarr_format": 2,
            "shape": list(data.shape),
            "chunks": list(chunks),
            "dtype": data.dtype.str,
            "compressor": comp,
            "fill_value": 0,
            "order": "C",
            "filters": None,
        }
        _write_json(os.path.join(sub, _ZARRAY), meta)
        arr = ZArray(sub)
        # write all chunks
        grid = [range(-(-s // c)) for s, c in zip(data.shape, chunks)]

        def rec(axis: int, idx: List[int]):
            if axis == data.ndim:
                sel = tuple(
                    slice(ci * c, min((ci + 1) * c, s))
                    for ci, c, s in zip(idx, chunks, data.shape)
                )
                block = data[sel]
                if block.shape != chunks:  # pad edge chunks
                    padded = np.full(chunks, 0, dtype=data.dtype)
                    padded[tuple(slice(0, b) for b in block.shape)] = block
                    block = padded
                arr._write_chunk(idx, block)
                return
            for ci in grid[axis]:
                rec(axis + 1, idx + [ci])

        if data.ndim:
            rec(0, [])
        else:
            arr._write_chunk((0,), data.reshape(1))
        return arr


_TARGET_CHUNK_BYTES = 128 * 1024


def _auto_chunks(shape: Tuple[int, ...], itemsize: int) -> Tuple[int, ...]:
    """Tile large 2-D arrays so window reads touch only nearby chunks.

    Random-cutout training reads ~128^2 windows out of 589x789 day fields; a
    single-chunk layout would inflate the whole field per read. Target ~128 KB
    tiles, splitting the trailing two axes evenly.
    """
    if len(shape) < 2:
        return tuple(shape)
    nbytes = itemsize
    for s in shape:
        nbytes *= s
    if nbytes <= _TARGET_CHUNK_BYTES:
        return tuple(shape)
    splits = int(np.ceil(np.sqrt(nbytes / _TARGET_CHUNK_BYTES)))
    chunks = list(shape)
    chunks[-2] = max(-(-shape[-2] // splits), 1)
    chunks[-1] = max(-(-shape[-1] // splits), 1)
    return tuple(chunks)


def open_group(path: str, mode: str = "r") -> Group:
    """Open a zarr v2 directory-store group (API mirrors zarr.open_group)."""
    return Group(path, mode=mode)
