"""Torch port: the native chunk codec (``data/native_codec.py``, built at first
use from ``sbgm_danra_tpu_torch/csrc/zarr_codec.cpp``) on the CPU.

- crops through the codec equal the zlib path's and JAX's
  ``native_codec.decompress_crop``'s bit for bit, across chunk borders, for
  uncompressed chunks and for float64;
- the policy: forced, disabled, and a host of <= 2 cores take the zlib path;
  the decode path is logged once;
- a missing chunk file raises (JAX returns None and falls back);
- a failed build raises with the compiler's message.
"""

import logging
import os

import numpy as np
import pytest

from sbgm_danra_tpu.data import native_codec as jax_codec
from sbgm_danra_tpu_torch.data import native_codec, zarrlite


@pytest.fixture(autouse=True)
def forced(monkeypatch):
    """The codec on, whatever the host's cores; the decision made afresh."""
    monkeypatch.setenv("SBGM_ZARR_CODEC_FORCE", "1")
    monkeypatch.delenv("SBGM_ZARR_CODEC_DISABLE", raising=False)
    native_codec.reset()
    yield
    native_codec.reset()


def _array(root, name, data, **kw):
    g = zarrlite.open_group(str(root / f"{name}.zarr"), mode="w")
    g.array("x", data, **kw)
    return zarrlite.open_group(str(root / f"{name}.zarr"))["x"]


def _zlib_read(monkeypatch, arr, sel):
    monkeypatch.setenv("SBGM_ZARR_CODEC_DISABLE", "1")
    native_codec.reset()
    assert native_codec.decode_path() == "zlib"
    out = arr[sel]
    monkeypatch.delenv("SBGM_ZARR_CODEC_DISABLE")
    native_codec.reset()
    return out


@pytest.mark.parametrize("case", ["float32_chunked", "uncompressed", "float64"])
def test_crops_equal_the_zlib_path_and_jax(tmp_path, monkeypatch, case):
    rng = np.random.default_rng(0)
    if case == "float32_chunked":
        data = rng.normal(size=(100, 120)).astype(np.float32)
        arr, sel, chunk_crop = _array(tmp_path, case, data, chunks=(40, 50)), \
            np.s_[13:87, 22:118], ((0, 0), (40, 50), (5, 15, 10, 30))
    elif case == "uncompressed":
        data = np.arange(64, dtype=np.float32).reshape(8, 8)
        arr, sel, chunk_crop = _array(tmp_path, case, data, compressor=None), \
            np.s_[2:6, 1:7], ((0, 0), (8, 8), (2, 6, 1, 7))
    else:
        data = rng.normal(size=(16, 16))
        arr, sel, chunk_crop = _array(tmp_path, case, data), np.s_[3:9, 4:12], \
            ((0, 0), (16, 16), (3, 9, 4, 12))
    assert native_codec.decode_path() == "native"
    got = arr[sel]
    assert got.dtype == data.dtype and np.array_equal(got, data[sel])
    assert np.array_equal(got, _zlib_read(monkeypatch, arr, sel))
    idx, chunk, window = chunk_crop
    compressed = arr.compressor is not None
    mine = native_codec.decompress_crop(arr._chunk_path(list(idx)), compressed, chunk,
                                        data.dtype, window)
    jax_codec._lib, jax_codec._checked = None, False  # JAX's codec, forced by the fixture
    theirs = jax_codec.decompress_crop(arr._chunk_path(list(idx)), compressed, chunk,
                                       data.dtype, window)
    assert theirs is not None and np.array_equal(mine, theirs)
    x1, x2, y1, y2 = window
    assert np.array_equal(mine, data[x1:x2, y1:y2])


def test_policy_and_the_decode_path_logged_once(monkeypatch, caplog):
    caplog.set_level(logging.INFO, logger=native_codec.__name__)
    assert native_codec.decode_path() == "native" and native_codec.available()
    native_codec.decode_path()
    assert sum("chunk decode path: native" in r.getMessage() for r in caplog.records) == 1
    monkeypatch.delenv("SBGM_ZARR_CODEC_FORCE")
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    native_codec.reset()
    assert native_codec.decode_path() == "zlib"
    assert native_codec.decompress_crop("any", True, (4, 4), np.float32, (0, 2, 0, 2)) is None
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    native_codec.reset()
    assert native_codec.decode_path() == "native"
    monkeypatch.setenv("SBGM_ZARR_CODEC_DISABLE", "1")
    native_codec.reset()
    assert native_codec.decode_path() == "zlib"
    assert any("chunk decode path: zlib" in r.getMessage() for r in caplog.records)


def test_a_missing_chunk_raises(tmp_path):
    with pytest.raises(OSError, match="cannot open"):
        native_codec.decompress_crop(str(tmp_path / "nonexistent"), True, (4, 4),
                                     np.float32, (0, 2, 0, 2))
    jax_codec._lib, jax_codec._checked = None, False
    assert jax_codec.decompress_crop(str(tmp_path / "nonexistent"), True, (4, 4),
                                     np.float32, (0, 2, 0, 2)) is None
    # unsupported dtypes go to the zlib path, as in JAX
    assert native_codec.decompress_crop("any", True, (4, 4), np.int16, (0, 2, 0, 2)) is None


def test_a_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "zarr_codec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_codec, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="failed .* on .*zarr_codec.cpp"):
        native_codec.available()
    with pytest.raises(RuntimeError):  # tried again, not cached as the zlib path
        native_codec.decode_path()

