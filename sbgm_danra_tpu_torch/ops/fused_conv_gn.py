"""Fused conv3x3 + GroupNorm (+ReLU) on Hopper, and its plain version.

Counterpart of ``sbgm_danra_tpu/ops/fused_conv_gn.py`` (the Pallas TPU kernel
``conv3x3_gn_relu``). The kernel source is
``sbgm_danra_tpu_torch/csrc/conv3x3_gn.cu``, whose header gives the design and
what bounds it on the card: ``conv3x3_stats`` (implicit-GEMM conv with the
GroupNorm partial statistics in its epilogue) and ``gn_apply`` (normalise,
affine, optional ReLU). ``ops/_nvcc.py`` builds it at first use.

What the function computes, in the JAX package's NHWC / HWIO layout: the
SAME 3x3 stride-1 conv of ``x`` with ``kernel`` and ``bias`` (both taken in
x's dtype, as a Flax conv casts its parameters to its compute dtype) with
fp32 accumulation; per-(sample, group) mean and one-pass variance
E[v^2] - mean^2 (clamped at 0) of the fp32 conv output before it is rounded;
then ``(conv - mean) * rsqrt(var + eps) * gamma + beta`` on the conv output
rounded to x's dtype, an optional ReLU or SiLU, and the result in x's dtype.
An optional ``sample_bias`` [N, Cout] (fp32) is added to the fp32 conv and its
bias before the statistics: a SongUNet block's ``conv0 -> + emb[n, c] ->
GroupNorm -> SiLU`` (``models/songunet.py``), where the noise embedding
differs from sample to sample.

- ``conv3x3_gn_relu``: the dispatcher. A tensor on the CPU takes
  ``reference_chain``; a CUDA tensor launches the kernels or raises.
- ``reference_chain``: the plain PyTorch version, used by the CPU tests and
  held against the kernels on the card by ``chip_smoke.py``.
- ``conv3x3_stats`` / ``gn_apply``: each kernel's own entry point, and
  ``plain_conv3x3_stats`` / ``plain_gn_apply`` their plain versions, which
  ``chip_smoke.py`` holds them against one by one.
- ``plan``: the pure function that picks ``conv3x3_stats``'s launch shape
  (variant, pixel tile, Cin chunk, shared memory, grid) from the call's shape;
  the wrapper launches what it returns and the CPU tests call it.
- ``tiled_weights`` / ``split_tiled_weights``: the kernels' copies of the
  HWIO weights, cut into the tiles that the kernel copies into shared memory:
  bf16 ``[Cout tiles, 9, Cin / 8, 64, 8]``, and fp32 split into TF32 hi and
  lo parts for the 3xTF32 products, ``[Cout tiles, 9, Cin / 8, 2, 2, 64, 4]``
  (both zero-padded, both made on the weights' device). The wrapper keeps one
  per parameter and remakes it when the
  parameter's version counter, storage or layout changes (``load_state_dict``,
  an in-place update, a move to another device). A write through ``.data``
  bumps no version counter and is not seen.
- ``group_norm_cuda``: a standalone GroupNorm (+ ReLU or SiLU) of an NHWC
  map on the card (CorrDiff's SongUNet, ``models/songunet.py``), from the same
  library: ``group_norm_stats`` (one fp32 reduction of the map into
  ``gn_apply``'s statistics layout, by the conv kernels' deterministic path)
  and ``group_norm_apply`` (``gn_apply``'s body under a name of its own, so
  that a trace bills it apart from K1); ``plain_group_norm_stats`` is the
  statistics' plain version, ``plain_gn_apply`` the normalise's.
- Each launch is counted in ``ops/launches.py`` under its kernel's name:
  ``conv3x3_stats`` (also ``conv3x3_stats_sample_bias`` where it takes a
  per-sample bias), ``gn_apply``, ``group_norm_stats`` and ``group_norm``.
- ``capture_scope``: what a CUDA graph's capture needs of the wrapper. The
  kernel's ticket counters (one int32 per sample, which the kernel's last
  block of a sample resets) are kept per graph, made during the warm-up on
  the capture stream, so that no two graphs share one; and the packed
  weights a capture reads from the per-parameter cache are listed with the
  parameter's version, so that the graph can tell when they went stale
  (``packs_current``). A pack the cache misses during a capture is made
  inside the graph and not kept.

Gradient: none. The JAX kernel has no VJP either; the training port decides
how the decoder's chains run under autograd, and until then a backward
through the kernels raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading
import weakref
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from sbgm_danra_tpu_torch.ops import _nvcc, launches

SOURCE = _nvcc.CSRC_DIR / "conv3x3_gn.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BN = 64  # the kernels' Cout tile
_SMS = 132  # streaming multiprocessors of an H100
MAX_SHARED_BYTES = 232_448  # shared memory one block may use on Hopper (227 KB)
_SM_SHARED_BYTES = 233_472  # per SM (228 KB); every resident block reserves 1 KB
_STAGES = 3  # cp.async ring of the bf16 conv kernel
# The bf16 conv kernel's launch shapes, (tile rows, tile columns, Cin chunk,
# resident weights): one warpgroup per 8 rows x 16 columns; 16-channel chunks
# only where 32 do not fit beside resident weights, which is on 16-row tiles.
LAUNCH_SHAPES = ((16, 16, 32, False), (8, 16, 32, False), (16, 16, 32, True), (8, 16, 32, True),
                 (16, 16, 16, True))
_WS_MAX_CIN = 128  # resident weights up to here: 9 x 128 x 64 bf16 = 147 KB
# The fp32 (3xTF32) conv kernel's launch shapes: 8-channel chunks (one k8 step
# of wgmma .tf32), weights streamed, 16x16 or 8x16 tiles.
FP32_LAUNCH_SHAPES = ((16, 16, 8, False), (8, 16, 8, False))
_APPLY_THREADS, _APPLY_UNROLL = 256, 4
_APPLY_BLOCKS_PER_SM = 16  # gn_apply blocks in flight per SM over the whole batch
# group_norm_stats blocks an SM over the batch: one wave, below the 5 its 48 registers a
# thread let an SM hold (the fastest of 4-16 at CorrDiff's maps on an H100)
_STATS_BLOCKS_PER_SM = 4
_MAX_CHANNELS = MAX_SHARED_BYTES // 8  # gn_apply keeps 8 bytes per channel in shared memory

_ACTIVATIONS = {False: 0, True: 1, "relu": 1, "silu": 2}  # gn_apply's epilogue codes
_local = threading.local()  # .scope: (ticket counters, pack hits) of the capture in progress


@contextlib.contextmanager
def capture_scope(tickets: dict, hits: Optional[list]):
    """Inside the block, this thread's kernel calls take their ticket counters
    from ``tickets`` and append the cached packs they read to ``hits`` (when
    not None): see the module's notes."""
    saved = getattr(_local, "scope", None)
    _local.scope = (tickets, hits)
    try:
        yield
    finally:
        _local.scope = saved


def packs_current(hits: list) -> bool:
    """True while every parameter behind the packs in ``hits`` is alive and
    unchanged (same version counter and storage) since the pack was read."""
    return all(ref() is not None and ref()._version == version and ref().data_ptr() == ptr
               for ref, version, ptr, _ in hits)


@functools.lru_cache(maxsize=1)
def build_library() -> _nvcc.BuiltLibrary:
    """Compile (once per source and flags) and load the kernels' library."""
    built = _nvcc.build(SOURCE, "sbgm_conv3x3_gn")
    p, i = ctypes.c_void_p, ctypes.c_int
    built.lib.sbgm_conv3x3_stats.argtypes = [p] * 8 + [i] * 13 + [p]
    built.lib.sbgm_conv3x3_stats.restype = i
    built.lib.sbgm_gn_apply.argtypes = [p, p, p, p, p, i, ctypes.c_longlong, i, i,
                                        ctypes.c_float, i, i, i, i, p]
    built.lib.sbgm_gn_apply.restype = i
    built.lib.sbgm_group_norm_stats.argtypes = [p, p, p, p, i, ctypes.c_longlong, i, i, i, i, p]
    built.lib.sbgm_group_norm_stats.restype = i
    return built


def _check_args(x, kernel, bias, groups, gamma=None, beta=None, sample_bias=None):
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, Cin], got shape {tuple(x.shape)}")
    cin = x.shape[-1]
    if kernel.shape[:3] != (3, 3, cin):
        raise ValueError(f"kernel must be [3, 3, {cin}, Cout] (HWIO), got {tuple(kernel.shape)}")
    cout = kernel.shape[-1]
    for name, v in (("bias", bias), ("gamma", gamma), ("beta", beta)):
        if v is not None and v.shape != (cout,):
            raise ValueError(f"{name} must be [{cout}], got {tuple(v.shape)}")
    if sample_bias is not None and sample_bias.shape != (x.shape[0], cout):
        raise ValueError(f"sample_bias must be [{x.shape[0]}, {cout}], got "
                         f"{tuple(sample_bias.shape)}")
    if groups < 1 or cout % groups != 0:
        raise ValueError(f"cout {cout} not divisible by groups {groups}")
    return cin, cout


def _activation_code(activation) -> int:
    """``activation``: False (none), True or "relu" (ReLU), "silu"."""
    if isinstance(activation, str) and activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; none, relu or silu")
    return _ACTIVATIONS[activation if isinstance(activation, str) else bool(activation)]


def plain_conv3x3_stats(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                        groups: int, sample_bias: Optional[torch.Tensor] = None) -> tuple:
    """``conv3x3_stats``'s plain version: the conv in x's dtype [N, H, W, Cout]
    and per-(sample, group) [sum, sum of squares] of the fp32 conv [N, G, 2];
    ``sample_bias`` [N, Cout] is added in fp32 before both."""
    dt = x.dtype
    conv = F.conv2d(x.float().permute(0, 3, 1, 2),
                    kernel.to(dt).float().permute(3, 2, 0, 1), bias.to(dt).float(), padding=1)
    if sample_bias is not None:
        conv = conv + sample_bias.float()[:, :, None, None]
    grouped = conv.reshape(conv.shape[0], groups, -1)
    stats = torch.stack([grouped.sum(-1), (grouped * grouped).sum(-1)], dim=-1)
    return conv.permute(0, 2, 3, 1).to(dt).contiguous(), stats


def plain_gn_apply(conv: torch.Tensor, stats: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, groups: int, eps: float = 1e-5, activation=True,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``gn_apply``'s plain version: (conv - mean) * rsqrt(var + eps) * gamma +
    beta (+ ReLU, or SiLU with ``activation="silu"``) in fp32 from the
    statistics, in ``out_dtype`` (default the conv's dtype)."""
    act = _activation_code(activation)
    n, h, w, c = conv.shape
    cpg = c // groups
    count = h * w * cpg
    mean = stats[..., 0] / count
    var = torch.clamp(stats[..., 1] / count - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cpg, dim=1)[:, None, None, :]
    inv_c = inv.repeat_interleave(cpg, dim=1)[:, None, None, :]
    y = (conv.float() - mean_c) * inv_c * gamma.float() + beta.float()
    if act == 1:
        y = torch.relu(y)
    elif act == 2:
        y = F.silu(y)
    return y.to(out_dtype or conv.dtype)


def reference_chain(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, gamma: torch.Tensor,
    beta: torch.Tensor, groups: int = 8, eps: float = 1e-5, activation=True,
    out_dtype: Optional[torch.dtype] = None, sample_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version of ``conv3x3_gn_relu``: same arithmetic, in fp32 PyTorch ops.

    ``out_dtype`` (default x's dtype) is the dtype of the result; float32 keeps
    the last rounding out, which is how the card's bf16 checks compare.
    """
    _check_args(x, kernel, bias, groups, gamma, beta, sample_bias)
    conv, stats = plain_conv3x3_stats(x, kernel, bias, groups, sample_bias)
    return plain_gn_apply(conv, stats, gamma, beta, groups, eps, activation, out_dtype)


def _require_cuda(what: str, **tensors) -> torch.device:
    device = next(iter(tensors.values())).device
    for name, v in tensors.items():
        if not isinstance(v, torch.Tensor) or v.device != device or v.device.type != "cuda":
            where = v.device if isinstance(v, torch.Tensor) else type(v).__name__
            raise ValueError(
                f"{what} launches a CUDA kernel and needs CUDA tensors on one device; "
                f"{name} is on {where} (use reference_chain off the card)"
            )
    return device


class ConvPlan(NamedTuple):
    """``conv3x3_stats``'s launch shape for one call shape."""

    variant: str  # "ws": resident weights; "stream": weights staged per Cin chunk
    mma: str  # "wgmma" (bf16) | "tf32x3" (fp32: three TF32 wgmma products per product)
    tile: tuple  # (rows, columns) of output pixels per tile
    chunk: int  # input channels per pipeline stage
    stages: int  # stages of the cp.async ring (1: no pipeline)
    shared_bytes: int  # dynamic shared memory of one block
    threads: int
    grid: tuple  # (slots, Cout tiles, batch); a block walks tiles slot, slot + slots, ...
    blocks_per_sm: int


def _conv_shared_bytes_fp32(tile) -> int:
    """The fp32 kernel's dynamic shared memory: three stages of the split halo
    and split weights of an 8-channel chunk, the warps' channel sums, the
    copy barriers."""
    th, tw = tile
    warps = th * tw // 32
    stage = 2 * 8 * (th + 2) * (tw + 2) + 9 * 2 * 8 * _BN
    return 4 * (_STAGES * stage + warps * _BN * 2) + _STAGES * 8


def _conv_shared_bytes(tile, chunk: int, resident: bool, cin: int) -> int:
    """The bf16 kernel's dynamic shared memory, as conv3x3_gn.cu lays it out."""
    th, tw = tile
    warps = th * tw // 32
    halo = (th + 2) * (tw + 2) * chunk
    stage = halo + (0 if resident else 9 * chunk * _BN)
    weights = 9 * math.ceil(cin / 32) * 32 * _BN if resident else 0  # Cin zero-padded to 32
    return (2 * (weights + _STAGES * stage + warps * 32 * (_BN + 8)) + warps * _BN * 2 * 4
            + (_STAGES + 1) * 8)  # ... the warps' channel sums and the copy barriers


@functools.lru_cache(maxsize=4096)
def plan(n: int, h: int, w: int, cin: int, cout: int, dtype: torch.dtype,
         force: Optional[tuple] = None) -> ConvPlan:
    """Pick the conv kernel's variant, tile, chunk and grid for x [n, h, w, cin] -> cout.

    By the rules that the sweep of ``profile_port.py --paths k1 --k1-sweep``
    gave on an H100:

    - tile: 16x16 pixels, or 8x16 where the map has at most 8 rows or where
      16x16 tiles would give at most half an SM's worth of blocks
      (n x tiles x Cout tiles <= 132 / 2); both dtypes;
    - fp32: 8-channel chunks, weights streamed (split into hi and lo they do
      not fit beside the halo at the decoder's Cin);
    - weights resident in shared memory ("ws") where Cin <= 128 and each block
      walks at least 3 tiles, so that copying its [9, Cin, 64] slice once pays;
      else staged with every Cin chunk ("stream");
    - chunk: 32 channels, or 16 where 32 do not fit beside resident weights
      (Cin 128);
    - grid: one block per resident slot of the card, (slots, Cout tiles, n);
      block ``slot`` of a sample walks tiles slot, slot + slots, ...

    ``force``, one of ``LAUNCH_SHAPES`` (bf16) or ``FP32_LAUNCH_SHAPES``,
    overrides the choice (measurements and the card tests of each launch
    shape). Raises where the shape does not fit in ``MAX_SHARED_BYTES``.
    """
    if min(n, h, w, cin, cout) < 1 or n > 65535:
        raise ValueError(f"conv3x3_stats: unsupported shape {(n, h, w, cin)} -> {cout}")
    cout_tiles = math.ceil(cout / _BN)

    def shaped(variant, mma, tile, chunk, stages, shared, threads):
        if shared > MAX_SHARED_BYTES:
            raise ValueError(f"conv3x3_stats: tile {tile}, chunk {chunk}, {variant} at Cin {cin} "
                             f"needs {shared} bytes of shared memory, above {MAX_SHARED_BYTES}")
        tiles = math.ceil(h / tile[0]) * math.ceil(w / tile[1])
        per_sm = max(1, min(_SM_SHARED_BYTES // (shared + 1024), 2048 // threads, 16))
        slots = min(tiles, max(1, _SMS * per_sm // (n * cout_tiles)))
        return ConvPlan(variant, mma, tile, chunk, stages, shared, threads,
                        (slots, cout_tiles, n), per_sm)

    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3_stats: dtype {dtype} not supported (float32 or bfloat16)")
    shapes = FP32_LAUNCH_SHAPES if dtype == torch.float32 else LAUNCH_SHAPES
    if force is not None and tuple(force) not in shapes:
        raise ValueError(f"conv3x3_stats: no kernel for the forced launch shape {force} in {dtype}")
    big_tiles = math.ceil(h / 16) * math.ceil(w / 16)
    tile = (8, 16) if h <= 8 or n * big_tiles * cout_tiles <= _SMS // 2 else (16, 16)
    if dtype == torch.float32:
        tile = tuple(force[:2]) if force is not None else tile
        return shaped("stream", "tf32x3", tile, 8, _STAGES, _conv_shared_bytes_fp32(tile),
                      tile[0] * tile[1])

    def bf16(tile, chunk, resident):
        return shaped("ws" if resident else "stream", "wgmma", tile, chunk, _STAGES,
                      _conv_shared_bytes(tile, chunk, resident, cin), tile[0] * tile[1])

    if force is not None:
        return bf16(tuple(force[:2]), force[2], bool(force[3]))
    streamed = bf16(tile, 32, False)
    if cin <= _WS_MAX_CIN:
        for chunk in (32, 16):
            if _conv_shared_bytes(tile, chunk, True, cin) <= MAX_SHARED_BYTES:
                resident = bf16(tile, chunk, True)
                tiles = math.ceil(h / tile[0]) * math.ceil(w / tile[1])
                if tiles >= 3 * resident.grid[0]:
                    return resident
                break
    return streamed


_packed = {}  # (id(parameter), tag) -> (weak reference, signature, packed copy)


def _cached(t: torch.Tensor, tag, make):
    """``make()`` once per parameter behind ``t`` (itself or the base it views)
    and state of it: version counter, storage, layout, device."""
    root = t._base if t._base is not None else t
    if root.is_inference():  # no version counter to watch
        return make()
    key = (id(root), tag)
    signature = (root._version, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)
    hit = _packed.get(key)
    capturing = t.is_cuda and torch.cuda.is_current_stream_capturing()
    if hit is not None and hit[0]() is root and hit[1] == signature:
        scope = getattr(_local, "scope", None)
        if capturing and scope is not None and scope[1] is not None:
            # the graph holds the pack itself, so that it outlives the cache entry
            scope[1].append((weakref.ref(root), root._version, root.data_ptr(), hit[2]))
        return hit[2]
    if capturing:  # made inside the graph, on every replay; the cache keeps no pool memory
        return make()
    made = make()
    _packed[key] = (weakref.ref(root, lambda _: _packed.pop(key, None)), signature, made)
    return made


def stale_packs() -> int:
    """How many cached packs no longer match their parameter: written since
    (its version counter moved) or moved to other storage."""
    return sum(1 for ref, signature, _ in list(_packed.values())
               if ref() is None or ref()._version != signature[0])


def clear_packs() -> None:
    """Drop every cached pack: the next call packs its weights afresh."""
    _packed.clear()


def _taps(kernel: torch.Tensor, dtype: torch.dtype, cin_pad: int) -> torch.Tensor:
    """The HWIO ``kernel`` [3, 3, Cin, Cout] as [9, Cout tiles x 64, cin_pad]
    in ``dtype`` (tap, output channel, input channel), zero-padded."""
    _, _, cin, cout = kernel.shape
    padded = torch.zeros((9, math.ceil(cout / _BN) * _BN, cin_pad), dtype=dtype,
                         device=kernel.device)
    padded[:, :cout, :cin] = kernel.detach().permute(0, 1, 3, 2).reshape(9, cout, cin)
    return padded


def tiled_weights(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The HWIO ``kernel`` as the bf16 conv kernel copies it into shared
    memory, [Cout tiles, 9, Cin / 8, 64, 8] in ``dtype``: element
    [t, tap, k, o, j] is kernel[tap // 3, tap % 3, 8 k + j, 64 t + o], zero
    where that is past Cout or Cin; Cin is padded to a multiple of 32. One
    (tap, run of k) slice of a Cout tile is then one contiguous bulk copy. Kept
    per parameter (see the module's notes)."""
    def make():
        cin_pad = math.ceil(kernel.shape[2] / 32) * 32
        padded = _taps(kernel, dtype, cin_pad)
        return (padded.view(9, -1, _BN, cin_pad // 8, 8).permute(1, 0, 3, 2, 4)
                .contiguous())
    return _cached(kernel, ("tiled", dtype), make)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 ``t`` rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as the kernels' ``cvt.rna.tf32.f32``: add half of the 13 dropped
    bits to the magnitude, then clear them."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tiled_weights(kernel: torch.Tensor) -> torch.Tensor:
    """The HWIO ``kernel`` in fp32 split for the 3xTF32 conv kernel, [Cout
    tiles, 9, Cin / 8, 2, 2, 64, 4]: element [t, tap, k, p, u, o, j] is part
    p (0: hi = ``round_tf32(w)``, 1: lo = ``round_tf32(w - hi)``) of w =
    kernel[tap // 3, tap % 3, 8 k + 4 u + j, 64 t + o], zero where that is
    past Cout or Cin; Cin is padded to a multiple of 8. One (tap, k) of a Cout
    tile is then one contiguous 4 KB bulk copy, hi then lo. Made on the
    weights' device and kept per parameter (see the module's notes)."""
    def make():
        cin_pad = math.ceil(kernel.shape[2] / 8) * 8
        padded = _taps(kernel, torch.float32, cin_pad)
        hi = round_tf32(padded)
        parts = torch.stack([hi, round_tf32(padded - hi)])  # [2, 9, Cout, Cin]
        return (parts.view(2, 9, -1, _BN, cin_pad // 8, 2, 4).permute(2, 1, 4, 0, 5, 3, 6)
                .contiguous())
    return _cached(kernel, ("tf32x3",), make)


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` contiguous in ``dtype``: itself where it already is, else a copy
    kept per parameter."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return _cached(t, ("cast", dtype), lambda: t.detach().to(dtype).contiguous())


_counters = {}  # (device, stream) -> int32 ticket counters, zero between launches


def _ticket_counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """One ticket per sample; the kernel's last block of a sample resets it, so
    the buffer is zeroed only when it is made (in a capture scope: the graph's
    own buffers)."""
    scope = getattr(_local, "scope", None)
    counters = _counters if scope is None else scope[0]
    key = (dev, stream)
    buf = counters.get(key)
    if buf is None or buf.numel() < n:
        buf = counters[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
    return buf


def _current_stream(dev: torch.device) -> int:
    """The raw handle of ``dev``'s current stream (a tenth of the host time of
    ``torch.cuda.current_stream(dev).cuda_stream``, which builds a Stream)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def conv3x3_stats(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                  groups: int, force: Optional[tuple] = None,
                  sample_bias: Optional[torch.Tensor] = None) -> tuple:
    """The conv kernel: x [N, H, W, Cin], HWIO kernel -> (conv [N, H, W, Cout] in
    x's dtype, stats [N, groups, 2] fp32 sum and sum of squares). ``force`` is
    ``plan``'s, for measurements and tests of each launch shape; ``sample_bias``
    [N, Cout], taken in fp32, is added to the fp32 conv before both."""
    tensors = dict(x=x, kernel=kernel, bias=bias)
    if sample_bias is not None:
        tensors["sample_bias"] = sample_bias
    dev = _require_cuda("conv3x3_stats", **tensors)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x: dtype {x.dtype} not supported (float32 or bfloat16)")
    cin, cout = _check_args(x, kernel, bias, groups, sample_bias=sample_bias)
    x = x.contiguous()
    n, h, w, _ = x.shape
    p = plan(n, h, w, cin, cout, x.dtype, force=force)
    slots = p.grid[0]
    built = build_library()
    with torch.cuda.device(dev):
        wk = tiled_weights(kernel, x.dtype) if p.mma == "wgmma" else split_tiled_weights(kernel)
        bias_t = _as(bias, x.dtype)
        sample_t = None if sample_bias is None else sample_bias.float().contiguous()
        conv = torch.empty((n, h, w, cout), dtype=x.dtype, device=dev)
        # partials [n, slots, cout, 2] and stats [n, groups, 2] in one allocation
        scratch = torch.empty((n * slots * cout * 2 + n * groups * 2,), dtype=torch.float32,
                              device=dev)
        stats = scratch[n * slots * cout * 2:].view(n, groups, 2)
        stream = _current_stream(dev)
        rc = built.lib.sbgm_conv3x3_stats(
            x.data_ptr(), wk.data_ptr(), bias_t.data_ptr(),
            None if sample_t is None else sample_t.data_ptr(), conv.data_ptr(),
            scratch.data_ptr(), _ticket_counters(dev, stream, n).data_ptr(), stats.data_ptr(),
            n, h, w, cin, cout, groups, slots, _DTYPE_CODES[x.dtype], p.tile[0], p.tile[1],
            p.chunk, int(p.variant == "ws"), p.shared_bytes, stream,
        )
        if rc != 0:
            _nvcc.check_launch(built, rc, f"conv3x3_stats ({p})")
        launches.count("conv3x3_stats",
                       *(() if sample_t is None else ("conv3x3_stats_sample_bias",)))
    return conv, stats


def apply_blocks(n: int, pixels: int, c: int, itemsize: int) -> int:
    """``gn_apply``'s blocks per sample: enough for every thread's
    ``_APPLY_UNROLL`` vectors, at most ``_APPLY_BLOCKS_PER_SM`` blocks an SM over the batch."""
    vec = 16 // itemsize
    if c % vec == 0 and c // vec <= _APPLY_THREADS:
        per_trip = (_APPLY_THREADS // (c // vec)) * _APPLY_UNROLL  # pixels
        want = math.ceil(pixels / per_trip)
    else:
        want = math.ceil(pixels * c / (_APPLY_THREADS * _APPLY_UNROLL))
    return max(1, min(want, _APPLY_BLOCKS_PER_SM * _SMS // n, 65535))


def _normalise(conv: torch.Tensor, stats: torch.Tensor, gamma: torch.Tensor,
               beta: torch.Tensor, groups: int, eps: float, activation,
               standalone: bool) -> torch.Tensor:
    """``gn_apply``'s and ``group_norm_apply``'s checks and launch: the
    normalise body as ``group_norm_apply_kernel`` (counted as ``group_norm``)
    where ``standalone``, else as ``gn_apply_kernel`` (``gn_apply``)."""
    entry = "group_norm_apply" if standalone else "gn_apply"
    _require_cuda(entry, conv=conv, stats=stats, gamma=gamma, beta=beta)
    act = _activation_code(activation)
    n, h, w, c = conv.shape
    if conv.dtype not in _DTYPE_CODES or not conv.is_contiguous():
        raise ValueError(f"conv must be a contiguous float32 or bfloat16 tensor, not {conv.dtype}")
    if stats.shape != (n, groups, 2) or stats.dtype != torch.float32 or c % groups != 0:
        raise ValueError(f"stats must be float32 [{n}, {groups}, 2], got {tuple(stats.shape)}")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gamma and beta must be [{c}], got {tuple(gamma.shape)} and "
                         f"{tuple(beta.shape)}")
    if c > _MAX_CHANNELS or n > 65535:
        raise ValueError(f"{entry}: {c} channels (at most {_MAX_CHANNELS}) or batch {n} (at "
                         "most 65535) not supported")
    stats = stats.contiguous()
    out = torch.empty_like(conv)
    built = build_library()
    with torch.cuda.device(conv.device):
        gamma_f, beta_f = _as(gamma, torch.float32), _as(beta, torch.float32)
        stream = _current_stream(conv.device)
        rc = built.lib.sbgm_gn_apply(
            conv.data_ptr(), stats.data_ptr(), gamma_f.data_ptr(), beta_f.data_ptr(),
            out.data_ptr(), n, h * w, c, groups, eps, act,
            _DTYPE_CODES[conv.dtype], apply_blocks(n, h * w, c, conv.element_size()),
            int(standalone), stream,
        )
        _nvcc.check_launch(built, rc, entry)
        launches.count("group_norm" if standalone else "gn_apply")
    return out


def gn_apply(conv: torch.Tensor, stats: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             groups: int, eps: float = 1e-5, activation=True) -> torch.Tensor:
    """The normalise kernel: conv [N, H, W, C] and its stats -> the GroupNorm
    (+ ReLU, or SiLU with ``activation="silu"``) of conv in conv's dtype."""
    return _normalise(conv, stats, gamma, beta, groups, eps, activation, standalone=False)


def plain_group_norm_stats(x: torch.Tensor, groups: int) -> torch.Tensor:
    """``group_norm_stats``'s plain version: per-(sample, group) [sum, sum of
    squares] of x [N, H, W, C] in fp32, [N, groups, 2]."""
    n, c = x.shape[0], x.shape[-1]
    grouped = x.float().reshape(n, -1, groups, c // groups)
    return torch.stack([grouped.sum((1, 3)), (grouped * grouped).sum((1, 3))], dim=-1)


def stats_slots(n: int, pixels: int, c: int, itemsize: int) -> int:
    """``group_norm_stats``'s blocks per sample and 64-channel tile: one wave
    of ``_STATS_BLOCKS_PER_SM`` blocks an SM over the batch, at most one per
    trip of a block's pixel rows."""
    vec = 16 // itemsize
    rows = _APPLY_THREADS // (_BN // vec if c % vec == 0 else _BN)  # pixel rows a trip
    return max(1, min(math.ceil(pixels / rows),
                      _STATS_BLOCKS_PER_SM * _SMS // (n * math.ceil(c / _BN))))


def group_norm_stats(x: torch.Tensor, groups: int) -> torch.Tensor:
    """The statistics kernel: x [N, H, W, C] (float32 or bfloat16) -> [N,
    groups, 2] fp32, the sum and the sum of squares of each (sample, group)."""
    dev = _require_cuda("group_norm_stats", x=x)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x: dtype {x.dtype} not supported (float32 or bfloat16)")
    if x.dim() != 4 or min(x.shape) < 1 or groups < 1 or x.shape[-1] % groups != 0:
        raise ValueError(f"x must be [N, H, W, C] with C divisible by groups {groups}, got "
                         f"{tuple(x.shape)}")
    if x.shape[0] > 65535:
        raise ValueError(f"group_norm_stats: batch {x.shape[0]} (at most 65535) not supported")
    x = x.contiguous()
    n, h, w, c = x.shape
    slots = stats_slots(n, h * w, c, x.element_size())
    built = build_library()
    with torch.cuda.device(dev):
        # partials [n, slots, c, 2] and stats [n, groups, 2] in one allocation
        scratch = torch.empty((n * slots * c * 2 + n * groups * 2,), dtype=torch.float32,
                              device=dev)
        stats = scratch[n * slots * c * 2:].view(n, groups, 2)
        stream = _current_stream(dev)
        rc = built.lib.sbgm_group_norm_stats(
            x.data_ptr(), scratch.data_ptr(), _ticket_counters(dev, stream, n).data_ptr(),
            stats.data_ptr(), n, h * w, c, groups, _DTYPE_CODES[x.dtype], slots, stream)
        _nvcc.check_launch(built, rc, "group_norm_stats")
        launches.count("group_norm_stats")
    return stats


def group_norm_apply(x: torch.Tensor, stats: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, groups: int, eps: float = 1e-5,
                     activation=False) -> torch.Tensor:
    """The standalone GroupNorm's normalise kernel: ``gn_apply`` launched as
    ``group_norm_apply_kernel``; counted as ``group_norm``."""
    return _normalise(x, stats, gamma, beta, groups, eps, activation, standalone=True)


class _Conv3x3GN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias, gamma, beta, groups, eps, activation, sample_bias):
        # checks x, kernel, bias and sample_bias
        conv, stats = conv3x3_stats(x, kernel, bias, groups, sample_bias=sample_bias)
        return gn_apply(conv, stats, gamma, beta, groups, eps, activation)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the CUDA conv3x3 + GroupNorm kernels have no backward; the JAX kernel has no "
            "VJP either, and the training port decides how the decoder runs under autograd"
        )


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, activation):
        x = x.contiguous()
        return group_norm_apply(x, group_norm_stats(x, groups), gamma, beta, groups, eps,
                                activation)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the CUDA GroupNorm kernels have no backward; training takes F.group_norm")


def group_norm_cuda(x, gamma, beta, groups: int, eps: float = 1e-5,
                    activation=False) -> torch.Tensor:
    """GroupNorm (+ ReLU, or SiLU with ``activation="silu"``) of NHWC x [N, H,
    W, C] on the card: fp32 statistics of x, then the normalise pass; the
    result [N, H, W, C] contiguous in x's dtype. CUDA tensors only."""
    return _GroupNorm.apply(x, gamma, beta, groups, eps, activation)


def conv3x3_gn_cuda(x, kernel, bias, gamma, beta, groups: int = 8, eps: float = 1e-5,
                    activation=True, sample_bias=None) -> torch.Tensor:
    """The kernels' entry point: CUDA tensors only, NHWC x and HWIO kernel."""
    return _Conv3x3GN.apply(x, kernel, bias, gamma, beta, groups, eps, activation, sample_bias)


def conv3x3_gn_relu(x, kernel, bias, gamma, beta, groups: int = 8, eps: float = 1e-5,
                    activation=True, sample_bias=None) -> torch.Tensor:
    """SAME conv3x3 (+ a per-sample bias) + GroupNorm + optional ReLU or SiLU:
    x [N, H, W, Cin] -> [N, H, W, Cout]."""
    if x.device.type == "cpu":
        return reference_chain(x, kernel, bias, gamma, beta, groups, eps, activation,
                               sample_bias=sample_bias)
    return conv3x3_gn_cuda(x, kernel, bias, gamma, beta, groups, eps, activation, sample_bias)
