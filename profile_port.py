#!/usr/bin/env python3
"""Time and profile the torch port's generation and training paths on one CUDA card.

    python3 profile_port.py                       # the port of this checkout
    python3 profile_port.py --root DIR --label parent --out chiprun_out/parent.json

``--root`` imports ``sbgm_danra_tpu_torch`` from another checkout (for
example an older commit unpacked with ``git archive``), so that two versions
are measured in one call on one card. It uses only entry points both have.

Paths, flagship UNet (19.08M parameters, bf16, seeded random weights):

- full_domain: ``sample_full_domain`` 589x789 -> 608x800, EDM-18, CFG w=3,
  attention backend 'pallas' (34 UNet evaluations at batch 2);
- serving: one 8-row dpmpp-25 dispatch of the serving engine at 128 px.

For each: the wall seconds of ``--repeats`` runs (after one warm-up), then
one run under ``torch.profiler``: device time by kernel class and the top
kernels by name, device busy time (the union of kernel intervals) and the
idle share of the profiled window. One JSON object per path on stdout, all of
them in ``--out``. Without a CUDA card it exits 1.

``--dtype float32`` runs ``full_domain``, ``k1`` and ``k2`` in fp32 (the
3xTF32 kernels; ``full_domain`` passes ``compute_dtype``, so the sample runs
with TF32 off as the entry point runs an fp32 model; the kernel timings set
TF32 off for their library calls); the default is bfloat16.

``--capture {eager,graph,both}`` picks the route of ``full_domain``,
``serving``, ``train`` and ``train_data``: the eager loop, the CUDA graphs
(``sbgm_danra_tpu_torch/capture.py``: the first call of a path captures, the
timed and profiled calls replay), or both in turn; each row's path ends in
``/eager`` or ``/graph``, and a graph row lists the live graphs (launches per
replay, replays, capture and instantiate seconds, pool bytes). A checkout
without graphs (an older commit under ``--root``) runs the eager loop only.
The profile's ``host_launch_calls`` count the host's launch calls (one a
kernel eagerly, one a graph replayed) beside ``kernel_launches``, the kernels
the card ran.

``--paths k1`` times K1's two kernels alone (``conv3x3_stats`` and
``gn_apply`` on seeded inputs, in ``--dtype``) at the decoder chains of the 608x800 path
(batch 2) and the 128-px path (batch 16) and at ragged shapes: ``ms`` (the
wrapper as the model calls it, mean of 20 calls after a warm-up),
``kernel_ms`` (the kernel's device time alone with its operands cold: a
CUDA-graph replay of 20 calls, each on its own copy of the operands, after a
flush of L2, which is what the bound's bytes at the HBM rate assume) beside
``kernel_warm_ms`` (the same 20 calls on one set of operands, which L2 then
serves where they fit in its 50 MB; in the model a chain's input was written
by the kernel before it, so the truth lies between), cuDNN's ``F.conv2d`` and
``F.group_norm`` (the call, and the device time of the kernels it launches,
measured the same two ways), the card's bound, and the errors against the
plain versions. One JSON object per shape, then the host's time per chain call
(enqueue only) and the sums per path. With ``--k1-sweep`` every launch shape
``plan`` can choose is forced in turn and timed (kernel time only, cold),
which is how the plan's choices were made.

The decoder's chain shapes, the ragged shapes and ``device_ms`` are kept here
and imported by ``chip_smoke.py`` and the tests: this script measures the
package of another checkout, so it cannot take them from the package.

``--paths k2bwd`` times K2's backward alone (``k2bwd_rows``: the three
backward kernels on strided q, k, v against the dense plain backward, warm and
cold, the delta, dk/dv and dq kernels' device times apart, SDPA's backward,
the bound, and the time of the design's 7 products at the data sheet's
peak; and the forward with its lse output off and on) in ``--dtype``. ``--paths train`` times one train step of the
flagship through ``TrainingPipeline`` (the port's step: DSM loss, backward,
Adam, EMA, BatchNorm statistics) at 128x128, batch 128 (the flagship's),
attention 'xla', and at 589x789 -> 608x800, batch 2, attention 'pallas',
remat, in ``--dtype``: wall seconds of ``--repeats`` steps and the profiler's
breakdown of one, as for the paths above.

``--paths train_data`` measures the flagship's data path
(``configs/flagship_synth.yaml`` through ``data_config``, ``--days``
synthetic days at 589x789, default 32): the stores' generation, the resident
GiB and the stacks' load and upload seconds, the card sampler at batch 128
(device ms after an L2 flush, launches, the jump-flood SDF's share), and the
flagship step with one step per dispatch, per route, on the device loader and
random batches (eager also on the host loader with 1 and 4 workers:
``RepeatedDays`` fills batches of 128 from the short split): the seconds of
each of 20 steps and ``torch.profiler`` over steps 5-8 (idle share,
launches); with graphs, ``training.fused_steps`` = 25 through
``training/fused.py`` (``train_data_rows``).

``--paths windowed`` trains the flagship on the rotating-window loader
(``data/windowed_data.py``: 6-day bf16 windows of the ``--days`` stores'
train split, fixed mode, 25 steps a window, fused 25) for 3 epochs, four
times, with ``training.async_checkpointing`` on, off, off, on
(``windowed_rows``): each epoch's training seconds, the fixed-mode stall and
the host loads, and each checkpoint save's seconds on the training thread
and its write's. ``--paths host_decode`` times the host's chunk decode on the
native codec and on zlib at 1, 4 and 8 threads: the threaded host loader's
samples/s and a window's decode split over a thread pool
(``host_decode_rows``).

``--paths quality_defaults`` runs ``sbgm_danra_tpu_torch.scripts.flagship_quality_eval``
at its default sizes (16 dates x 32 members, ``--skip_pc``) on ``--days``
synthetic days (107 or more for 16 test dates) and a seeded random flagship
checkpoint: each run's seconds, graph pool and the card's peak memory
(``quality_defaults_rows``). ``--paths pc1000_capture`` times PC-1000 at the
quality phase's shape on the eager loop and captured into one CUDA graph
(capture and instantiate seconds, pool, host memory, replays;
``pc1000_capture_rows``).

``--paths k2`` times K2 alone (``flash_attention_cuda`` on contiguous
seeded inputs, which every version takes) in ``--dtype`` at the full-domain
shape and at the card tests' shapes: mean device ms of 20 launches
after a warm-up, SDPA's in the same process, and the worst |err| over
``2^-8 |ref| + 2^-8 max|ref|`` (bf16) or ``2e-5 + 2e-5 |ref|`` (fp32)
against the fp32 plain version on the same inputs. One JSON object per
shape; in fp32 two more, with the keys past 4000 scaled by 8 and by 40 (the
rescale path): the kernel's worst |err| over ``2e-5 + 2e-5 |ref|`` against
the fp32 plain version, and the kernel's and the fp32 plain version's against
dense attention in fp64.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 tensor cores, fp32
# CUDA cores, HBM3
PEAK_BF16, PEAK_TF32, PEAK_FP32_FMA, PEAK_BYTES = 989e12, 495e12, 67e12, 3.35e12


def bound(flops: float, nbytes: float, dtype_name: str, exps: float = 0.0,
          exp_rate: float = float("inf")) -> dict:
    """The least time the card could take for the work: operations, bytes at
    the memory rate or exponentials at ``exp_rate`` per second, whichever is
    longest. bf16 operations run at the tensor cores' bf16 peak; fp32 ones by
    the faster of two routes that keep fp32's accuracy: FMAs on the CUDA cores,
    or 3xTF32 (three TF32 products each) on the tensor cores."""
    if dtype_name == "bfloat16":
        ops = flops / PEAK_BF16
    else:
        ops = min(flops / PEAK_FP32_FMA, 3 * flops / PEAK_TF32)
    times = {"operations": ops, "bytes": nbytes / PEAK_BYTES, "exponentials": exps / exp_rate}
    by = max(times, key=times.get)
    return dict(bound_ms=1e3 * times[by], bound_by=by)


EXP_PER_CLOCK_PER_SM = 16  # the SFU's ex2 rate on Hopper


def sfu_rate(torch) -> dict:
    """The SFU's exponentials per second: 16 ex2 per clock per SM at the
    card's SM count and its maximum SM clock as nvidia-smi reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    mhz = float(out.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(sm_count=sms, max_sm_clock_mhz=mhz,
                exp_per_s=EXP_PER_CLOCK_PER_SM * sms * mhz * 1e6)


# kernel-name patterns, first match wins
CLASSES = (
    # every variant (flash_attention_fwd_kernel_tc, flash_attention_fwd_kernel_tf32);
    # before "attention (SDPA)", whose patterns would also match them
    ("K2 flash_attention_fwd", ("flash_attention_fwd_kernel",)),
    ("K2 flash_attention_bwd", ("flash_attention_bwd_",)),
    ("K1 conv3x3_stats", ("conv3x3_stats",)),
    ("K1 gn_apply", ("gn_apply",)),
    ("upsample2x", ("upsample2x_kernel",)),
    # before "GroupNorm (PyTorch)", whose "group_norm" would also match them
    ("GroupNorm (NHWC kernels)", ("group_norm_stats_kernel", "group_norm_apply_kernel")),
    ("GroupNorm (PyTorch)", ("GroupNorm", "group_norm", "RowwiseMoments", "ComputeFusedParams")),
    ("BatchNorm", ("batch_norm", "BatchNorm")),
    ("cat", ("CatArrayBatchedCopy",)),
    ("dtype and layout copies", ("copy_kernel", "direct_copy")),
    ("conv (cuDNN)", ("conv", "Conv", "implicit", "fprop", "cudnn")),
    ("matmul (cuBLAS)", ("gemm", "Gemm", "gemv", "xmma")),
    ("attention (SDPA)", ("fmha", "flash_fwd", "attention", "efficient")),
    ("optimizer and EMA (foreach)", ("multi_tensor_apply", "foreach")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


def classify(name: str) -> str:
    for label, patterns in CLASSES:
        if any(p in name for p in patterns):
            return label
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile(torch, fn) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    return summarize(prof, wall_us)


HOST_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset")


def summarize(prof, wall_us: float) -> dict:
    """Device time by kernel class and name, busy time and idle share of a
    finished ``torch.profiler`` session over ``wall_us`` of host time."""
    # device events, without the user annotations the profiler puts on the
    # device's timeline (e.g. "Optimizer.step#Adam.step"), which are no kernels
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False)]
    by_class, by_name, intervals = {}, {}, []
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        intervals.append((e.time_range.start, e.time_range.end))
        by_class[classify(e.name)] = by_class.get(classify(e.name), 0.0) + dur
        count, total = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (count + 1, total + dur)
    busy = busy_us(intervals)
    kernel_total = sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    host_calls = {}  # the host's launch calls: one per kernel eagerly, one per graph replayed
    for e in prof.events():
        if e.device_type.name == "CPU" and e.name.startswith(HOST_LAUNCH_CALLS):
            host_calls[e.name] = host_calls.get(e.name, 0) + 1
    return dict(
        profiled_wall_ms=wall_us / 1e3,
        device_busy_ms=busy / 1e3,
        idle_share=1.0 - busy / wall_us if wall_us else None,
        kernel_launches=len(kernels),
        host_launch_calls=host_calls,
        kernel_ms_by_class={k: v / 1e3 for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])},
        kernel_share_by_class={k: v / kernel_total for k, v in by_class.items()},
        top_kernels=[dict(name=n[:120], calls=c, ms=t / 1e3) for n, (c, t) in top],
    )


# the full-domain decoder shape first, then the card tests' shapes
K2_SHAPES = ((2, 7600, 4, 32), (1, 4096, 4, 64), (2, 300, 4, 128), (1, 33, 1, 32),
             (2, 1000, 2, 24), (2, 7600, 2, 128))


def k2_rows(torch, dev, dtype_name: str) -> list:
    """K2 alone against its plain version and SDPA, one row per shape."""
    from sbgm_danra_tpu_torch.ops import cuda_attention
    from sbgm_danra_tpu_torch.ops.flash_attention import dense_attention

    def ms(fn, iters=20):
        fn()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(dev).manual_seed(0)
    rows, dtype = [], getattr(torch, dtype_name)
    exp_rate = sfu_rate(torch)["exp_per_s"]
    for shape in K2_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
        out = cuda_attention.flash_attention_cuda(q, k, v).float()
        ref = cuda_attention.flash_attention_reference(q.float(), k.float(), v.float())
        if dtype == torch.bfloat16:
            tol = 2.0**-8 * ref.abs() + 2.0**-8 * ref.abs().max()
        else:
            tol = 2e-5 + 2e-5 * ref.abs()
        err = (out - ref).abs()
        b, s_len, h, d = shape
        rows.append(dict(
            shape=list(shape), dtype=dtype_name, max_abs_err=err.max().item(),
            max_abs_err_over_ref_max=(err.max() / ref.abs().max()).item(),
            worst_err_over_tolerance=(err / tol).max().item(),
            ms=ms(lambda: cuda_attention.flash_attention_cuda(q, k, v)),
            sdpa_ms=ms(lambda: dense_attention(q, k, v)),
            **bound(4.0 * b * h * s_len * s_len * d, 4 * q.numel() * q.element_size(),
                    dtype_name, exps=float(b * h * s_len * s_len), exp_rate=exp_rate)))
    if dtype == torch.float32:
        # the rescale path's accuracy: keys from 4000 on scaled up, so that the
        # late scores sit far above the early max
        def worst(out, ref):
            return ((out.double() - ref).abs() / (2e-5 + 2e-5 * ref.abs())).max().item()

        q, k, v = (torch.randn(K2_SHAPES[0], generator=gen, device=dev) for _ in range(3))
        for factor in (8.0, 40.0):
            kf = k.clone()
            kf[:, 4000:] *= factor
            got = cuda_attention.flash_attention_cuda(q, kf, v)
            plain = cuda_attention.flash_attention_reference(q, kf, v)
            q64, k64, v64 = q.double(), kf.double(), v.double()
            scores = torch.einsum("bqhd,bkhd->bhqk", q64 / q.shape[-1] ** 0.5, k64)
            fp64 = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v64)
            del scores
            rows.append(dict(shape=list(K2_SHAPES[0]), dtype=dtype_name, late_keys_scaled_by=factor,
                             worst_err_over_tolerance=worst(got, plain.double()),
                             worst_err_over_tolerance_vs_fp64=worst(got, fp64),
                             plain_fp32_worst_err_over_tolerance_vs_fp64=worst(plain, fp64)))
    return rows


# K2's backward: the full-domain decoder shape, then shapes off the path
K2_BWD_SHAPES = ((2, 7600, 4, 32), (1, 4096, 2, 64), (2, 1000, 2, 128), (2, 333, 2, 24))


BWD_KERNELS = ("bwd_delta", "bwd_dkdv", "bwd_dq")


def bwd_kernel_ms(torch, call, iters: int = 5) -> dict:
    """Device ms per call of each of K2's backward kernels (delta, dk/dv, dq),
    from ``torch.profiler`` over ``iters`` calls on one set of operands."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    call()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    total = dict.fromkeys(BWD_KERNELS, 0.0)
    for e in prof.events():
        if e.device_type.name == "CUDA":
            for name in BWD_KERNELS:
                if name in e.name:
                    total[name] += (e.time_range.end - e.time_range.start) / 1e3
    return {name.removeprefix("bwd_"): ms / iters for name, ms in total.items()}


def k2bwd_rows(torch, dev, dtype_name: str, shapes=K2_BWD_SHAPES) -> list:
    """K2's backward alone (``_launch_bwd``: delta, dk/dv, dq) on strided q, k, v
    (chunks of one packed projection) against the dense plain backward: each
    gradient's max |err| over its max |ref|; ``ms`` (mean of 5 calls),
    ``kernel_ms`` (cold, ``device_ms``), each kernel's device ms
    (``bwd_kernel_ms``), the plain version's ms, SDPA's backward (SDPA forward
    + backward minus forward) and the bound (5 products of 2 S^2 D B H flops
    and B H S^2 exponentials; bytes of q, k, v, O, dO and lse in, dq, dk, dv
    out) beside ``design_at_peak_ms``, the time of the 7 products and 2 B H
    S^2 exponentials that dk/dv and dq do at the data sheet's peak rates (no
    floor of mma.sync, whose own rate on the card this does not measure); the
    forward's ms with its lse output off and on."""
    import torch.nn.functional as F

    from sbgm_danra_tpu_torch.ops import cuda_attention as ca

    def ms(fn, iters=5):
        fn()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(dev).manual_seed(20)
    dtype = getattr(torch, dtype_name)
    exp_rate = sfu_rate(torch)["exp_per_s"]
    rows = []
    for shape in shapes:
        b, s_len, h, d = shape
        packed = torch.randn(b, s_len, 3 * h * d, generator=gen, device=dev).to(dtype)
        q, k, v = (t.reshape(shape) for t in packed.chunk(3, dim=-1))
        dout = torch.randn(shape, generator=gen, device=dev).to(dtype)
        out, lse = ca._launch(q, k, v, with_lse=True)
        plain_lse = ca.attention_lse(q, k)
        got = ca._launch_bwd(q, k, v, out, dout, lse)
        repeat = all(torch.equal(x, y) for x, y in zip(got, ca._launch_bwd(q, k, v, out, dout,
                                                                              lse)))
        want = ca.flash_attention_bwd_reference(q.float(), k.float(), v.float(), out.float(),
                                                dout.float(), plain_lse)
        errs = {n: ((x.float() - y).abs().max() / y.abs().max()).item()
                for n, x, y in zip(("dq", "dk", "dv"), got, want)}
        del want
        qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        dout_t = dout.transpose(1, 2)

        def sdpa_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qs, ks, vs)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qs, ks, vs)
            return torch.autograd.grad(o, (qs, ks, vs), dout_t)

        operands = (q, k, v, out, dout, lse)
        nbytes = 8 * q.numel() * q.element_size() + 4 * b * h * s_len
        copies = [[t.clone() for t in operands] for _ in range(COLD_COPIES)]
        row = dict(
            shape=list(shape), dtype=dtype_name, rel_err=errs, repeat_bit_identical=repeat,
            lse_max_abs_err=(lse - plain_lse).abs().max().item(),
            ms=ms(lambda: ca._launch_bwd(*operands)),
            kernel_ms=device_ms(torch, [functools.partial(ca._launch_bwd, *c) for c in copies]),
            plain_ms=ms(lambda: ca.flash_attention_bwd_reference(
                q.float(), k.float(), v.float(), out.float(), dout.float(), plain_lse), 2),
            library_ms=ms(sdpa_fwd_bwd, 10) - ms(sdpa_fwd, 10),
            kernel_ms_by_kernel=bwd_kernel_ms(torch, lambda: ca._launch_bwd(*operands)),
            forward_ms_lse_off=ms(lambda: ca._launch(q, k, v), 10),
            forward_ms_lse_on=ms(lambda: ca._launch(q, k, v, with_lse=True), 10),
            **bound(5 * 2.0 * b * h * s_len * s_len * d, nbytes, dtype_name,
                    exps=float(b * h * s_len * s_len), exp_rate=exp_rate),
            design_at_peak_ms=bound(7 * 2.0 * b * h * s_len * s_len * d, nbytes, dtype_name,
                                    exps=2.0 * b * h * s_len * s_len,
                                    exp_rate=exp_rate)["bound_ms"])
        rows.append(row)
        del copies, got, q, k, v, packed, qs, ks, vs
        torch.cuda.empty_cache()
    return rows


FULL_DOMAIN = (589, 789)


def train_config(tmp: str, dtype: str, backend: str, remat: bool):
    """The flagship's training section (configs/flagship_synth.yaml: Adam, lr
    5e-4, EMA 0.999, L2 1e-6, seed 0) at the flagship's widths, through the
    port's own reader (no YAML)."""
    from sbgm_danra_tpu_torch.config import from_dict

    return from_dict({
        "experiment": {"config_name": "train_probe"},
        "paths": {"checkpoint_dir": tmp},
        "highres": {"variable": "prcp"},
        "lowres": {"condition_variables": ["temp", "prcp"]},
        "model": {"compute_dtype": dtype, "attention_backend": backend},
        "training": {"seed": 0, "learning_rate": 5e-4, "optimizer": "adam", "with_ema": True,
                     "ema_decay": 0.999, "weight_decay": 1e-6, "remat": remat,
                     "lr_scheduler": "none", "early_stopping": False},
    })


def train_batches(torch, n: int, batch: int, domain, dev, seed: int) -> list:
    """Seeded synthetic batches with the flagship's keys on the card: x, y,
    cond_img (2 LR channels), lsm_cond and topo_cond (value, mask), sdf; the
    full domain (589x789) padded to 608x800 as full-domain sampling pads it."""
    from sbgm_danra_tpu_torch.evaluate.full_domain import pad_conditioning, pad_field, padded_dims

    domain = tuple(domain)
    hw = padded_dims(*domain) if domain == FULL_DOMAIN else domain
    out = []
    for i in range(n):
        g = torch.Generator(dev).manual_seed(seed + i)
        b = pad_conditioning({
            "y": torch.randint(1, 5, (batch,), generator=g, device=dev),
            "cond_img": torch.randn(batch, *domain, 2, generator=g, device=dev),
            "lsm_cond": (torch.rand(batch, *domain, 2, generator=g, device=dev) > 0.5).float(),
            "topo_cond": torch.randn(batch, *domain, 2, generator=g, device=dev),
        }, hw)
        b["x"] = torch.randn(batch, *hw, 1, generator=g, device=dev)
        b["sdf"] = pad_field(torch.rand(batch, *domain, 1, generator=g, device=dev), hw)
        out.append(b)
    return out


# the data path's phase: the flagship's grid and crop window
DATA_DAYS = 32  # train 22, valid 4, test 6: a depth cut of configs/flagship_synth.yaml's 384


def data_config(root: str, device_dataset: bool = True, num_workers: int = 1, **training):
    """configs/flagship_synth.yaml's data, model, training and evaluation
    sections (prcp HR in log_zscore at 128x128 from the 589x789 grid inside
    [170, 350, 340, 520], LR temp and prcp, lsm, topo and the SDF loss, CFG
    0.1, 4 seasons, bf16 UNet, batch 128, Adam 5e-4 with EMA 0.999 (loaded for
    generation), fused_steps 25; dpmpp-25 with CFG w=3, 8 members) with its
    paths under ``root``, through the port's own reader (no YAML);
    ``training`` overrides that section's keys."""
    from sbgm_danra_tpu_torch.config import from_dict

    data = os.path.join(root, "data")
    return from_dict({
        "experiment": {"config_name": "flagship_synth"},
        "paths": {"data_dir": data, "checkpoint_dir": os.path.join(root, "ckpt"),
                  "sample_dir": os.path.join(root, "samples"),
                  "lsm_path": os.path.join(data, "data_lsm/truth_fullDomain/lsm_full.npz"),
                  "topo_path": os.path.join(data, "data_topo/truth_fullDomain/topo_full.npz"),
                  "stats_load_dir": os.path.join(data, "stats")},
        "highres": {"model": "DANRA", "variable": "prcp", "data_size": [128, 128],
                    "scaling_method": "log_zscore", "full_domain_dims": [589, 789],
                    "cutout_domains": [170, 350, 340, 520], "buffer_frac": 0.5},
        "lowres": {"model": "ERA5", "condition_variables": ["temp", "prcp"],
                   "scaling_methods": ["zscore", "log_zscore"], "full_domain_dims": [589, 789],
                   "buffer_frac": 0.5},
        "sampler": {"sampler_type": "dpmpp_sampler", "n_timesteps": 25},
        "model": {"compute_dtype": "bfloat16"},
        "data_handling": {"device_dataset": device_dataset, "num_workers": num_workers,
                          "n_gen_samples": 4},
        "training": {"seed": 0, "batch_size": 128, "learning_rate": 5e-4,
                     "lr_scheduler": "CosineAnnealing", "lr_scheduler_params": {"t_max": 150},
                     "epochs": 150, "steps_per_epoch": 100, "with_ema": True,
                     "ema_decay": 0.999, "weight_decay": 1e-6, "sdf_weighted_loss": True,
                     "fused_steps": 25, "early_stopping": False, "verbose": False,
                     "load_ema": True, "monitor_extremes": False, **training},
        "classifier_free_guidance": {"enabled": True, "drop_prob": 0.1,
                                     "guidance_scale": 3.0},
        "evaluation": {"n_gen_samples": 4, "n_steps": 25, "seed": 0, "gen_type": ["repeated"],
                       "n_repeats": 8, "eval_stat_methods": ["pixel_stats", "spatial_stats"]},
        "visualization": {"plot_initial_sample": False, "preview_every": 0},
    })


class RepeatedDays:
    """A dataset that visits each day of ``dataset`` ``times`` times, each
    visit a full host sample (zarr read, transforms, crop, EDT SDF, CFG
    dropout): lets the host loader fill batches of 128 from a short split."""

    def __init__(self, dataset, times: int):
        self.dataset, self.times = dataset, times

    def __len__(self) -> int:
        return len(self.dataset) * self.times

    def __getitem__(self, idx: int, rng=None):
        return self.dataset.__getitem__(idx % len(self.dataset), rng=rng)


class OnCard(list):
    """A list of batches already on the card in model-kwargs form: the trainer
    takes them as a device loader's."""

    is_device_loader = True


def step_seconds(torch, pipe, loader, steps: int, window=None) -> dict:
    """``pipe.train_batches(steps)`` on ``loader``: the seconds of each step,
    from a stamp after each step once the card has finished it, and the mean
    loss. ``window=(a, b)``: ``torch.profiler`` records from the end of step a
    to the end of step b (loading included), summarised as ``profile`` does."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    stamps, step = [], pipe._train_step
    starts = []  # when the time of each step starts: the end of the one before
    prof = tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if window else None
    summary = {}

    def timed(*args, **kw):
        out = step(*args, **kw)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        starts.append(stamps[-1])
        if prof is not None and len(stamps) == window[0]:
            prof.start()
            starts[-1] = time.perf_counter()
        elif prof is not None and len(stamps) == window[1]:
            prof.stop()
            summary.update(summarize(prof, 1e6 * (stamps[-1] - starts[window[0] - 1])),
                           steps=window[1] - window[0])
            starts[-1] = time.perf_counter()  # the profiler's own work is no step's
        return out

    pipe.train_loader, pipe._train_step = loader, timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = pipe.train_batches(steps)
    finally:
        pipe._train_step = step
    out = dict(step_s=[b - a for a, b in zip([t0] + starts, stamps)], mean_loss=loss)
    if summary:
        out["profile"] = summary
    return out


def sampler_profile(torch, loader, generator) -> dict:
    """One card batch of ``loader`` (a ``DeviceDataLoader``) under the
    profiler, after a warm-up and a flush of L2 (cold), and its jump-flood SDF
    alone: device ms (the union of its kernels), launches, the SDF's share,
    and the mean wall ms of 10 batches (draws included)."""
    from sbgm_danra_tpu_torch.ops.sdf import generate_sdf_device

    def flushed(fn):
        torch.empty(4 * L2_BYTES, dtype=torch.uint8, device="cuda").sum()
        return profile(torch, fn)

    draws = loader.draws(generator)
    batch = loader.sample_from(*draws)
    masks = batch["lsm_hr"][..., 0].contiguous()
    whole = flushed(lambda: loader.sample_from(*draws))
    sdf = flushed(lambda: generate_sdf_device(masks))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        loader.sample(generator)
    torch.cuda.synchronize()
    return dict(
        batch=int(draws[0].shape[0]), sampler_device_ms=whole["device_busy_ms"],
        sampler_launches=whole["kernel_launches"], sdf_device_ms=sdf["device_busy_ms"],
        sdf_launches=sdf["kernel_launches"],
        sdf_share_of_device_ms=sdf["device_busy_ms"] / whole["device_busy_ms"],
        sampler_wall_ms=100.0 * (time.perf_counter() - t0),
        sampler_kernel_ms_by_class=whole["kernel_ms_by_class"])


# Decoder chains (H, W, Cin, Cout) of one flagship UNet evaluation, blocks 0-3,
# conv_up -> norm1 then conv -> norm2; block 3's two chains share a shape.
# 128 px runs them at batch 16 (8 rows with CFG), 608x800 at batch 2.
CHAINS_128 = [(8, 8, 512, 512), (8, 8, 512, 256), (16, 16, 256, 256), (16, 16, 256, 128),
              (32, 32, 128, 128), (32, 32, 128, 64), (64, 64, 64, 64), (64, 64, 64, 64)]
CHAINS_FULL = [(38, 50, 512, 512), (38, 50, 512, 256), (76, 100, 256, 256),
               (76, 100, 256, 128), (152, 200, 128, 128), (152, 200, 128, 64),
               (304, 400, 64, 64), (304, 400, 64, 64)]
# (batch, chain) off every tile, off the Cin chunk and off the 64-channel Cout tile
K1_RAGGED = [(2, (37, 51, 12, 24)), (2, (37, 51, 200, 72)), (1, (9, 7, 12, 24)),
             (1, (9, 7, 200, 72))]
L2_BYTES = 50 * 2**20  # an H100's L2 cache
COLD_COPIES = 20  # calls per timed replay, each on its own copy of the operands


def device_ms(torch, fns, cold: bool = True) -> float:
    """Device time of one call: the callables ``fns`` captured in one CUDA graph
    and replayed, so that no host work lies in the timed window (it holds the
    kernels they launch and the gaps between them in the graph).

    ``cold``: every callable is the same call on its own copy of the operands;
    their results are kept through the capture, so that each writes its own
    output, and L2 is flushed before the timed replay. No call then finds in L2
    what another read or wrote. Not ``cold``: as many calls of one callable on
    one set of operands, which L2 serves where they fit.
    """
    for fn in fns:  # builds, caches and warm-up allocations happen outside the capture
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    kept = []
    with torch.cuda.graph(graph):
        for fn in fns:
            out = fn()
            if cold:
                kept.append(out)
    graph.replay()
    if cold:  # reading four times its size leaves nothing of the replay above in L2
        torch.empty(4 * L2_BYTES, dtype=torch.uint8, device="cuda").sum()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del kept
    return start.elapsed_time(stop) / len(fns)


def both_ms(torch, call, *operands) -> dict:
    """``call(*operands)``'s device time cold and warm (see ``device_ms``)."""
    copies = [[t.clone() for t in operands] for _ in range(COLD_COPIES)]
    return dict(
        cold=device_ms(torch, [functools.partial(call, *c) for c in copies]),
        warm=device_ms(torch, [functools.partial(call, *operands)] * COLD_COPIES, cold=False))


def k1_rows(torch, dev, sweep: bool, dtype_name: str) -> list:
    """K1's kernels alone against plain versions, cuDNN and the bound, per shape."""
    import torch.nn.functional as F

    from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1

    def ms(fn, iters=20):
        fn()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(dev).manual_seed(1)
    shapes = ([("full-domain", 2, c) for c in dict.fromkeys(CHAINS_FULL)]
              + [("serve-128", 16, c) for c in dict.fromkeys(CHAINS_128)]
              + [("ragged", n, c) for n, c in K1_RAGGED])
    rows, groups, dtype = [], 8, getattr(torch, dtype_name)
    launch_shapes = getattr(k1, "FP32_LAUNCH_SHAPES", ()) if dtype == torch.float32 else getattr(
        k1, "LAUNCH_SHAPES", ())
    for path, n, (h, w, cin, cout) in shapes:
        x = torch.randn(n, h, w, cin, generator=gen, device=dev).to(dtype)
        kernel = torch.randn(3, 3, cin, cout, generator=gen, device=dev) / (3 * cin**0.5)
        bias = 0.1 * torch.randn(cout, generator=gen, device=dev)
        gamma = 1.0 + 0.1 * torch.randn(cout, generator=gen, device=dev)
        beta = 0.1 * torch.randn(cout, generator=gen, device=dev)
        plain_conv, plain_stats = k1.plain_conv3x3_stats(x.float(), kernel.to(dtype),
                                                         bias.to(dtype), groups)

        def conv_check(conv, stats):
            err = (conv.float() - plain_conv).abs()
            tol = 1e-4 * plain_conv.abs().max()  # fp32
            if dtype == torch.bfloat16:
                tol = tol + 4e-3 * plain_conv.abs()
            return dict(conv_worst_err_over_tolerance=(err / tol).max().item(),
                        stats_rel_err=((stats - plain_stats).abs().max()
                                       / plain_stats.abs().max()).item())

        conv, stats = k1.conv3x3_stats(x, kernel, bias, groups)
        out = k1.gn_apply(conv, stats, gamma, beta, groups, activation=False)
        apply_ref = k1.plain_gn_apply(conv, stats, gamma, beta, groups, activation=False,
                                      out_dtype=torch.float32)
        repeat = k1.conv3x3_stats(x, kernel, bias, groups)
        x_nchw = x.permute(0, 3, 1, 2)
        w_oihw = kernel.permute(3, 2, 0, 1).to(dtype).contiguous(memory_format=torch.channels_last)
        conv_nchw, bias_d = conv.permute(0, 3, 1, 2), bias.to(dtype)
        g_d, b_d = gamma.to(dtype), beta.to(dtype)
        pixels, es = n * h * w, x.element_size()
        conv_bound = bound(2.0 * 9 * cin * cout * pixels,
                           (pixels * (cin + cout) + 9 * cin * cout) * es
                           + 4 * (cout + 2 * n * groups), dtype_name)
        apply_bound = bound(4.0 * pixels * cout,
                            2 * pixels * cout * es + 4 * (2 * n * groups + 2 * cout), "float32")
        conv_fn = lambda: k1.conv3x3_stats(x, kernel, bias, groups)  # noqa: E731
        apply_fn = lambda: k1.gn_apply(conv, stats, gamma, beta, groups,  # noqa: E731
                                       activation=False)
        conv_dev = both_ms(torch, lambda *a: k1.conv3x3_stats(*a, groups), x, kernel, bias)
        conv_lib_dev = both_ms(torch, lambda *a: F.conv2d(*a, padding=1), x_nchw, w_oihw, bias_d)
        apply_dev = both_ms(torch, lambda *a: k1.gn_apply(*a, groups, activation=False),
                            conv, stats, gamma, beta)
        apply_lib_dev = both_ms(torch, lambda c, g, b: F.group_norm(c, groups, g, b, 1e-5),
                                conv_nchw, g_d, b_d)
        row = dict(
            path=path, batch=n, hw=[h, w], cin=cin, cout=cout, dtype=dtype_name,
            plan=str(k1.plan(n, h, w, cin, cout, dtype)) if hasattr(k1, "plan") else None,
            **conv_check(conv, stats),
            repeat_bit_identical=bool(torch.equal(repeat[0], conv)
                                      and torch.equal(repeat[1], stats)),
            apply_max_abs_err=(out.float() - apply_ref).abs().max().item(),
            conv_ms=ms(conv_fn), conv_kernel_ms=conv_dev["cold"],
            conv_kernel_warm_ms=conv_dev["warm"],
            conv_library_ms=ms(lambda: F.conv2d(x_nchw, w_oihw, bias_d, padding=1)),
            conv_library_kernel_ms=conv_lib_dev["cold"],
            conv_library_kernel_warm_ms=conv_lib_dev["warm"],
            conv_bound_ms=conv_bound["bound_ms"], conv_bound_by=conv_bound["bound_by"],
            apply_ms=ms(apply_fn), apply_kernel_ms=apply_dev["cold"],
            apply_kernel_warm_ms=apply_dev["warm"],
            apply_library_ms=ms(lambda: F.group_norm(conv_nchw, groups, g_d, b_d, 1e-5)),
            apply_library_kernel_ms=apply_lib_dev["cold"],
            apply_library_kernel_warm_ms=apply_lib_dev["warm"],
            apply_bound_ms=apply_bound["bound_ms"])
        if sweep and hasattr(k1, "plan"):
            forced = {}
            for force in launch_shapes:
                try:
                    k1.plan(n, h, w, cin, cout, dtype, force=force)
                except ValueError:
                    continue  # does not fit in shared memory
                forced_fn = lambda *a: k1.conv3x3_stats(*a, groups, force=force)  # noqa: E731
                forced["x".join(map(str, map(int, force)))] = dict(
                    **both_ms(torch, forced_fn, x, kernel, bias),
                    **conv_check(*forced_fn(x, kernel, bias)))
            row["forced_rows_cols_chunk_resident"] = forced
        rows.append(row)
    # what one chain costs the host: calls enqueued back to back, the device
    # (far faster at this shape) never waited for
    x = torch.randn(16, 16, 16, 64, generator=gen, device=dev).to(dtype)
    kernel = torch.randn(3, 3, 64, 64, generator=gen, device=dev) / 24
    vec = torch.ones(64, device=dev)
    with torch.inference_mode():
        chain = lambda: k1.conv3x3_gn_relu(x, kernel, vec, vec, vec, groups,  # noqa: E731
                                           activation=False)
        for _ in range(20):
            chain()
        host_us = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(400):
                chain()
            host_us.append((time.perf_counter() - t0) / 400 * 1e6)
            torch.cuda.synchronize()
    rows.append(dict(path="host", what="host microseconds per conv3x3_gn_relu call, enqueue "
                                       f"only, 5 x 400 calls at 16x16x16x64->64 {dtype_name}",
                     chain_host_us=host_us))
    keys = [f"{kernel}_{key}" for kernel in ("conv", "apply")
            for key in ("ms", "kernel_ms", "kernel_warm_ms", "library_ms", "library_kernel_ms",
                        "library_kernel_warm_ms", "bound_ms")]
    for path, chains in (("full-domain", CHAINS_FULL), ("serve-128", CHAINS_128)):
        by_shape = {(*r["hw"], r["cin"], r["cout"]): r for r in rows if r["path"] == path}
        rows.append(dict(path=path, sum_over="the 8 chains of one UNet evaluation",
                         **{k: sum(by_shape[c][k] for c in chains) for k in keys}))
    return rows


FUSED_K = 25  # configs/flagship_synth.yaml: training.fused_steps


def train_data_rows(torch, dev, args, smi, modes=("eager",), has_graphs=False) -> list:
    """The flagship's data path (``data_config``, ``--days`` synthetic days):
    the stores' generation, the card-resident stacks, the card sampler at
    batch 128 (``sampler_profile``), and the flagship step in one pipeline per
    route (``modes``: the eager step, the step's CUDA graph) with one step per
    dispatch: on the device loader and random batches (and, on the eager
    route, the host loader with 1 and 4 workers), the seconds of each of 20
    steps and the profiler over steps 5-8. With graphs, ``training.fused_steps``
    = 25 through the pipeline's own fused step (one chunk to capture, two
    timed, one profiled): seconds per step, and each graph's capture and
    instantiate seconds and pool bytes."""
    import gc
    import tempfile

    from sbgm_danra_tpu_torch.cli.main_app import synthetic_data
    from sbgm_danra_tpu_torch.data.factory import make_dataset, make_loaders
    from sbgm_danra_tpu_torch.data.loader import DataLoader
    from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline

    tmp = tempfile.mkdtemp()
    cfg = data_config(tmp)
    t0 = time.perf_counter()
    synthetic_data(cfg, args.days, no_all_split=True)
    gen_s = time.perf_counter() - t0
    train, valid, _ = make_loaders(cfg, device=dev)
    head = dict(label=args.label, root=args.root, card=smi, days=args.days)
    rows = [dict(head, path="train_data/stacks", generate_s=gen_s,
                 resident_gib=(train.stacks.nbytes() + valid.stacks.nbytes()) / 2**30,
                 train_days=train.stacks.n_days, load_s=train.stacks.load_s,
                 upload_s=train.stacks.upload_s,
                 **sampler_profile(torch, train, torch.Generator(dev).manual_seed(0)))]
    print(json.dumps(rows[-1]), flush=True)
    days = make_dataset(cfg, "train")
    one_step = data_config(tmp, fused_steps=0)
    for mode in modes:
        route = {"capture": mode == "graph"} if has_graphs else {}
        pipe = TrainingPipeline(one_step, train, valid, device=dev, **route)
        loaders = [("device_loader", train)]
        if mode == "eager":
            for workers in (1, 4):
                loaders.append((f"host_loader_{workers}_workers",
                                DataLoader(RepeatedDays(days, 128), batch_size=128,
                                           shuffle=True, num_workers=workers, seed=0)))
        loaders.append(("random_batches",
                        OnCard(train_batches(torch, 20, 128, (128, 128), dev, 40))))
        for name, loader in loaders:
            step_seconds(torch, pipe, loader, 2)  # warm-up (on the graph route: the capture)
            torch.cuda.reset_peak_memory_stats()
            run = step_seconds(torch, pipe, loader, 20, window=(5, 8))
            rows.append(dict(head, path=f"train_data/{name}/{mode}", **run,
                             step_s_median=float(sorted(run["step_s"])[10]),
                             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9))
            print(json.dumps(rows[-1]), flush=True)
        del pipe, loaders
        gc.collect()
        torch.cuda.empty_cache()
    if "graph" not in modes or not has_graphs:
        return rows
    from sbgm_danra_tpu_torch import capture

    pipe = TrainingPipeline(data_config(tmp, fused_steps=FUSED_K), train, device=dev)
    train.set_epoch(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.train_batches(FUSED_K)  # the capture, then one chunk
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for epoch in (1, 2):
        train.set_epoch(epoch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = pipe.train_batches(FUSED_K)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    train.set_epoch(3)
    prof = profile(torch, lambda: pipe.train_batches(FUSED_K))
    gc.collect()
    graphs = [g for g in capture.stats() if g["name"].startswith("fused")]
    rows.append(dict(head, path="train_data/fused_step", k=FUSED_K,
                     first_chunk_s=first_s, chunk_s=walls,
                     step_s=[w / FUSED_K for w in walls], mean_loss=loss,
                     peak_memory_gb=peak, graphs=graphs, **prof))
    print(json.dumps(rows[-1]), flush=True)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return rows


WINDOW_DAYS = 6  # the windowed flagship: 22 train days in 4 windows
WINDOWED_EPOCHS = 3
ASYNC_ORDER = (True, False, False, True)  # on, off, off, on: drift cancels in the pairs


def windowed_rows(torch, dev, args, smi, tmp) -> list:
    """The windowed flagship (``data_config``, ``device_window_days`` 6 over
    the stores' train split, bf16 staging, fused 25, fixed mode at 25 steps a
    window) trained ``WINDOWED_EPOCHS`` epochs by ``TrainingPipeline.train``,
    once a run, with ``training.async_checkpointing`` in ``ASYNC_ORDER``.
    Per run: each epoch's training seconds (``train_batches``, steps and the
    stager's stalls inside) and steps, the fixed-mode stall and swaps it had,
    each staged window's host load seconds, and each checkpoint save's
    seconds on the training thread (the call), its ``torch.save``'s seconds
    and, when asynchronous, the worker's seconds (its host copy and write),
    and the whole ``train`` call."""
    import gc

    from sbgm_danra_tpu_torch.data.factory import make_loaders
    from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline

    rows = []
    for i, on in enumerate(ASYNC_ORDER):
        cfg = data_config(tmp, steps_per_epoch=None, async_checkpointing=on)
        cfg.data_handling.device_window_days = WINDOW_DAYS
        cfg.data_handling.device_window_steps = FUSED_K
        cfg.paths.checkpoint_dir = os.path.join(tmp, f"windowed_{i}", "ckpt")
        cfg.paths.sample_dir = os.path.join(tmp, f"windowed_{i}", "samples")
        train, valid, _ = make_loaders(cfg, device=dev)
        pipe = TrainingPipeline(cfg, train, valid, device=dev)
        manager, batches = pipe.checkpoints, pipe.train_batches
        save, write, worker = manager.save, manager._write, manager._write_snapshot
        epochs, saves, writes, worker_s = [], [], [], []

        def timed(record, fn):
            def call(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                record.append(time.perf_counter() - t0)
                return out
            return call

        def train_batches(max_steps=None):
            stall, swaps = train.stall_s, train.n_swaps
            t0 = time.perf_counter()
            loss = batches(max_steps)  # the losses read: the card finished the epoch
            epochs.append(dict(train_s=time.perf_counter() - t0, stall_s=train.stall_s - stall,
                               swaps=train.n_swaps - swaps))
            return loss

        manager.save, manager._write = timed(saves, save), timed(writes, write)
        manager._write_snapshot = timed(worker_s, worker)
        pipe.train_batches = train_batches
        t0 = time.perf_counter()
        pipe.train(epochs=WINDOWED_EPOCHS)
        train_s = time.perf_counter() - t0
        steps = len(train)
        rows.append(dict(
            label=args.label, root=args.root, card=smi, path="windowed/async_checkpointing",
            run=i, async_checkpointing=on, train_call_s=train_s, epochs=epochs,
            steps_per_epoch=steps,
            step_s_after_epoch_0=[e["train_s"] / steps for e in epochs[1:]],
            fixed_stall_s=train.stall_s, n_swaps=train.n_swaps, load_s=train.load_s,
            save_call_s=saves, write_s=writes, worker_s=worker_s, history=pipe.history))
        print(json.dumps(rows[-1]), flush=True)
        pipe.checkpoints.close()
        del pipe, train, valid, manager, save, write, worker
        gc.collect()
        torch.cuda.empty_cache()
    return rows


DECODE_ROUNDS = 3
DECODE_WORKERS = (1, 4, 8)


def host_decode_rows(torch, args, smi, tmp) -> list:
    """The host's chunk decode on the native codec and on ``zlib``
    (``SBGM_ZARR_CODEC_DISABLE``), ``DECODE_ROUNDS`` rounds alternating the
    two, at ``DECODE_WORKERS`` threads, on the stores' train split (the days
    in the page cache after the first round):

    - the threaded host loader (``data/loader.py``'s ``DataLoader`` over
      ``RepeatedDays``, batch 128, shuffled): samples/s of one batch (each
      sample the HR and LR crops read through ``zarrlite``, transformed, the
      EDT SDF);
    - a 6-day window's full-domain decode (``load_days``, a day a task on a
      thread pool, as a threaded stager would split it): ms a day."""
    import concurrent.futures as cf

    from sbgm_danra_tpu_torch.data import native_codec
    from sbgm_danra_tpu_torch.data.device_data import load_days
    from sbgm_danra_tpu_torch.data.factory import make_dataset
    from sbgm_danra_tpu_torch.data.loader import DataLoader

    dataset = make_dataset(data_config(tmp), "train")
    days = list(dataset.common_dates[:WINDOW_DAYS])
    timings = {(kind, path, n): [] for kind in ("loader_samples_per_s", "window_ms_per_day")
               for path in ("native", "zlib") for n in DECODE_WORKERS}
    taken = {}
    saved = os.environ.get("SBGM_ZARR_CODEC_DISABLE")
    try:
        for r in range(DECODE_ROUNDS):
            for path in ("native", "zlib"):
                if path == "zlib":
                    os.environ["SBGM_ZARR_CODEC_DISABLE"] = "1"
                else:
                    os.environ.pop("SBGM_ZARR_CODEC_DISABLE", None)
                native_codec.reset()
                taken[path] = native_codec.decode_path()
                for n in DECODE_WORKERS:
                    loader = DataLoader(RepeatedDays(dataset, 128), batch_size=128, shuffle=True,
                                        num_workers=n, seed=r)
                    t0 = time.perf_counter()
                    next(iter(loader))
                    timings[("loader_samples_per_s", path, n)].append(
                        128 / (time.perf_counter() - t0))
                    with cf.ThreadPoolExecutor(max_workers=n) as pool:
                        t0 = time.perf_counter()
                        list(pool.map(lambda d: load_days(dataset, [d]), days))
                    timings[("window_ms_per_day", path, n)].append(
                        1e3 * (time.perf_counter() - t0) / len(days))
    finally:
        if saved is None:
            os.environ.pop("SBGM_ZARR_CODEC_DISABLE", None)
        else:
            os.environ["SBGM_ZARR_CODEC_DISABLE"] = saved
        native_codec.reset()
    rows = []
    for (kind, path, n), values in timings.items():
        rows.append(dict(label=args.label, root=args.root, card=smi, path=f"host_decode/{kind}",
                         decode_path=path, path_taken=taken[path], threads=n,
                         host_cores=os.cpu_count(), values=values,
                         median=float(sorted(values)[len(values) // 2])))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def _host_rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def pc1000_capture_rows(torch, dev, args, smi) -> list:
    """PC-1000 at the quality phase's flagship shape (2 dates x 4 members: 8
    rows, 16 with CFG w=3, 128 px, the flagship bf16 UNet with seeded random
    weights): one call on the eager loop (the route
    ``scripts/flagship_quality_eval`` takes on the card; it also makes cuDNN's
    choices and K1's packs), then the same call captured into one CUDA graph
    with no further warm-up (``capture.Graph(..., warmup=0)``) and replayed
    twice on the eager call's draws: the eager call's seconds, the capture
    and instantiate seconds, the pool, the host's resident memory grown by
    the graph, the launches a replay, each replay's seconds and the replay
    against the eager output."""
    from sbgm_danra_tpu_torch import capture
    from sbgm_danra_tpu_torch.models.unet import build_score_model
    from sbgm_danra_tpu_torch.sampling import samplers as S
    from sbgm_danra_tpu_torch.serve import FLAGSHIP_SYNTH

    model = build_score_model(FLAGSHIP_SYNTH.spec, generator=torch.Generator().manual_seed(2))
    model = model.to(dev)
    shape = (8, 128, 128, 1)
    g = torch.Generator(dev).manual_seed(16)
    cond = {"y": torch.randint(1, 5, (8,), generator=g, device=dev),
            "cond_img": torch.randn(8, 128, 128, 2, generator=g, device=dev),
            "lsm_cond": (torch.rand(8, 128, 128, 2, generator=g, device=dev) > 0.5).float(),
            "topo_cond": torch.randn(8, 128, 128, 2, generator=g, device=dev)}
    keys = sorted(cond)
    config = S.SamplerConfig(num_steps=1000, guidance_scale=3.0)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = S.pc_sampler(model, torch.Generator(dev).manual_seed(14), shape, config=config,
                             cond=cond)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        draws = S.draw_noise(torch.Generator(dev).manual_seed(14), shape,
                             S.n_draws(S.pc_sampler, config))

        def call(draws, *values):
            return S.pc_sampler(model, None, shape, config=config,
                                cond=dict(zip(keys, values)), draws=draws)

        rss0 = _host_rss_bytes()
        t0 = time.perf_counter()
        graph = capture.Graph("pc_sampler 1000 8x128x128", call,
                              [draws, *(cond[k] for k in keys)], warmup=0)
        capture_call_s = time.perf_counter() - t0
        rss1 = _host_rss_bytes()
        replay_s = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = graph.replay()
            torch.cuda.synchronize()
            replay_s.append(time.perf_counter() - t0)
        diff = float((out.float() - eager.float()).abs().max())
    stats = graph.stats()
    row = dict(label=args.label, root=args.root, card=smi, path="pc1000_capture",
               rows=shape[0], cfg=3.0, unet_evaluations=2000, eager_s=eager_s,
               capture_call_s=capture_call_s, capture_s=stats["capture_s"],
               instantiate_s=stats["instantiate_s"], pool_bytes=stats["pool_bytes"],
               host_rss_growth_bytes=rss1 - rss0,
               launches_per_replay=stats["launches_per_replay"], replay_s=replay_s,
               replay_vs_eager_max_abs=diff,
               max_abs_eager=float(eager.float().abs().max()),
               finite=bool(torch.isfinite(out).all()))
    print(json.dumps(row), flush=True)
    del graph, out, draws
    return [row]


def quality_defaults_rows(torch, dev, args, smi) -> list:
    """``scripts/flagship_quality_eval`` at its default sizes (16 test dates x
    32 members: 512 rows a sampler call, 1,024 with CFG; ``--skip_pc``) on a
    checkpoint of the flagship with seeded random weights (an untrained
    ``TrainingPipeline`` saved as the best step) and ``--days`` synthetic days
    (16 test dates need 107): each run's route, compile and run seconds,
    capture and instantiate seconds and graph pool, and the card's peak
    allocated and reserved memory over the script."""
    import tempfile

    from sbgm_danra_tpu_torch.cli.main_app import synthetic_data
    from sbgm_danra_tpu_torch.scripts import flagship_quality_eval
    from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline

    tmp = tempfile.mkdtemp()
    cfg = data_config(tmp)
    t0 = time.perf_counter()
    synthetic_data(cfg, args.days, no_all_split=True)
    data_s = time.perf_counter() - t0
    pipe = TrainingPipeline(data_config(tmp, fused_steps=0), [], device=dev)
    pipe.save(0.0)
    pipe.checkpoints.wait()
    del pipe
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = flagship_quality_eval.main(["--skip_pc", "--out", os.path.join(tmp, "q.json"),
                                      "--device", str(dev)], cfg=cfg)
    row = dict(label=args.label, root=args.root, card=smi, path="quality_defaults",
               days=args.days, data_s=data_s, script_s=time.perf_counter() - t0,
               n_dates=out["results"]["n_dates"], members=out["results"]["members"],
               runs=out["runs"], peak_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved(dev) / 1e9,
               card_total_gb=torch.cuda.get_device_properties(dev).total_memory / 1e9,
               crps_normalized={k: v["normalized"]["crps"] for k, v in out["results"].items()
                                if isinstance(v, dict) and "normalized" in v})
    print(json.dumps(row), flush=True)
    return [row]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                   help="checkout whose sbgm_danra_tpu_torch is measured")
    p.add_argument("--label", default="change")
    p.add_argument("--paths", default="full_domain,serving",
                   help="comma-separated: full_domain, serving, k1, k2, k2bwd, train, "
                        "train_data, windowed, host_decode, quality_defaults, "
                        "pc1000_capture")
    p.add_argument("--k1-sweep", action="store_true",
                   help="with k1: also time every launch shape the plan could choose")
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                   help="the working dtype of full_domain, k1 and k2")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--days", type=int, default=DATA_DAYS,
                   help="synthetic days of train_data, windowed and host_decode")
    p.add_argument("--capture", default="eager", choices=("eager", "graph", "both"),
                   help="full_domain, serving, train, train_data: the eager loop, the CUDA "
                        "graphs, or both in turn (a checkout without graphs runs eager only)")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA card", file=sys.stderr)
        return 1
    from sbgm_danra_tpu_torch.evaluate.full_domain import padded_dims, sample_full_domain
    from sbgm_danra_tpu_torch.models.unet import ModelSpec, build_score_model, inference_spec
    from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig, get_sampler
    from sbgm_danra_tpu_torch.serve import FLAGSHIP_SYNTH
    from sbgm_danra_tpu_torch.sde import VESDE

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()

    def cond_for(batch, hw, seed):
        g = torch.Generator(dev).manual_seed(seed)
        return {
            "y": torch.randint(1, 5, (batch,), generator=g, device=dev),
            "cond_img": torch.randn(batch, *hw, 2, generator=g, device=dev),
            "lsm_cond": (torch.rand(batch, *hw, 2, generator=g, device=dev) > 0.5).float(),
            "topo_cond": torch.randn(batch, *hw, 2, generator=g, device=dev),
        }

    import inspect

    has_graphs = "capture" in inspect.signature(sample_full_domain).parameters
    modes = {"eager": ["eager"], "graph": ["graph"], "both": ["eager", "graph"]}[args.capture]
    if not has_graphs:
        modes = ["eager"]  # this checkout has one route

    def route(mode):
        return {"capture": mode == "graph"} if has_graphs else {}

    runs = {}
    if "full_domain" in args.paths:
        domain = (589, 789)
        spec = inference_spec(ModelSpec(in_channels=6, num_classes=4, compute_dtype=args.dtype,
                                        attention_backend="pallas"), padded_dims(*domain))
        model = build_score_model(spec, generator=torch.Generator().manual_seed(0)).to(dev)
        cond = cond_for(1, domain, 8)
        config = SamplerConfig(num_steps=18, guidance_scale=3.0, s_churn=0.0)
        for mode in modes:
            runs[f"full_domain/{mode}"] = (
                f"EDM-18 sample, 589x789 -> 608x800, CFG w=3, batch 1, {args.dtype}, {mode}",
                functools.partial(functools.partial, sample_full_domain, model,
                                  torch.Generator(dev).manual_seed(0), cond, domain_hw=domain,
                                  batch=1, config=config, sampler="edm_sampler",
                                  compute_dtype=args.dtype, **route(mode)))
    if "serving" in args.paths:
        settings = FLAGSHIP_SYNTH
        serve_model = build_score_model(settings.spec, VESDE(),
                                        generator=torch.Generator().manual_seed(1)).to(dev)
        scond = cond_for(8, settings.sample_hw, 9)
        gens = lambda: [torch.Generator(dev).manual_seed(s) for s in range(8)]  # noqa: E731

        def dispatch(mode):
            with torch.inference_mode():
                if mode == "graph":
                    from sbgm_danra_tpu_torch.sampling import graphs

                    out = graphs.sample(settings.sampler_type, serve_model, gens(),
                                        (8, *settings.sample_hw, 1), VESDE(), settings.sampler,
                                        cond=scond)
                else:
                    out = get_sampler(settings.sampler_type)(
                        serve_model, gens(), (8, *settings.sample_hw, 1), VESDE(),
                        settings.sampler, cond=scond)
                return out.float().cpu().numpy()

        for mode in modes:
            runs[f"serving/{mode}"] = (f"one 8-row dpmpp-25 dispatch at 128 px, CFG w=3, {mode}",
                                       functools.partial(functools.partial, dispatch, mode))

    results = []
    if "k1" in args.paths.split(","):
        for row in k1_rows(torch, dev, args.k1_sweep, args.dtype):
            row = dict(label=args.label, root=args.root, card=smi, kernel="k1", **row)
            print(json.dumps(row), flush=True)
            results.append(row)
    if "k2" in args.paths.split(","):
        for row in k2_rows(torch, dev, args.dtype):
            row = dict(label=args.label, root=args.root, path="k2", card=smi, **row)
            print(json.dumps(row), flush=True)
            results.append(row)
    if "k2bwd" in args.paths.split(","):
        for row in k2bwd_rows(torch, dev, args.dtype):
            row = dict(label=args.label, root=args.root, path="k2bwd", card=smi, **row)
            print(json.dumps(row), flush=True)
            results.append(row)
    if "train" in args.paths.split(","):
        import tempfile

        from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline

        tmp = tempfile.mkdtemp()
        for name, hw, batch, backend, remat in (
                ("train_128", (128, 128), 128, "xla", False),  # configs/flagship_synth.yaml:67
                ("train_full_domain", FULL_DOMAIN, 2, "pallas", True)):
            for mode in modes:
                def make(hw=hw, batch=batch, backend=backend, remat=remat, mode=mode):
                    pipe = TrainingPipeline(train_config(tmp, args.dtype, backend, remat), [],
                                            device=dev, **route(mode))
                    batch_list = train_batches(torch, 1, batch, hw, dev, seed=60)
                    return functools.partial(pipe._train_step, pipe.state, batch_list[0],
                                             torch.Generator(dev).manual_seed(0))

                runs[f"{name}/{mode}"] = (
                    f"one train step, {hw[0]}x{hw[1]}, batch {batch}, {args.dtype}, attention "
                    f"{backend}, remat {remat}, {mode}", make)
    if "train_data" in args.paths.split(","):
        results += train_data_rows(torch, dev, args, smi, modes, has_graphs)
    if "quality_defaults" in args.paths.split(","):
        results += quality_defaults_rows(torch, dev, args, smi)
    if "pc1000_capture" in args.paths.split(","):
        results += pc1000_capture_rows(torch, dev, args, smi)
    if {"windowed", "host_decode"} & set(args.paths.split(",")):
        import tempfile

        from sbgm_danra_tpu_torch.cli.main_app import synthetic_data

        tmp = tempfile.mkdtemp()
        synthetic_data(data_config(tmp), args.days, no_all_split=True)
        if "windowed" in args.paths.split(","):
            results += windowed_rows(torch, dev, args, smi, tmp)
        if "host_decode" in args.paths.split(","):
            results += host_decode_rows(torch, args, smi, tmp)
    for path, (what, make) in runs.items():  # make() builds the path's call
        import gc

        fn = make()
        torch.backends.cudnn.benchmark = False
        out = fn()  # warm-up (on a graph route: the capture)
        walls = []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()
        prof = profile(torch, fn)
        finite = (np.isfinite(out).all() if isinstance(out, np.ndarray)
                  else all(bool(torch.isfinite(v).all()) for v in out.values()))
        row = dict(label=args.label, root=args.root, path=path, what=what, card=smi,
                   wall_s=walls, finite=bool(finite),
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **prof)
        if path.endswith("/graph"):
            from sbgm_danra_tpu_torch import capture

            row["graphs"] = capture.stats()
        print(json.dumps(row), flush=True)
        results.append(row)
        del fn, out
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
