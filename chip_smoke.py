#!/usr/bin/env python3
"""Drive the torch port's generation and training paths once on one CUDA card and check them.

    python3 chip_smoke.py          # from the repo root; one CUDA GPU and nvcc

Phases, one JSON line each on stdout:

1. device: the card's name, count and power limit, and the SFU's rate of
   exponentials (16 per clock per SM at the card's maximum SM clock), which
   K2's bound takes beside bytes and tensor-core operations;
2. build: the three CUDA sources of ``sbgm_danra_tpu_torch/csrc`` compiled
   with nvcc for sm_90a, in parallel, into ``sbgm_danra_tpu_torch/_build/``
   (nvcc's ``-Xptxas -v`` report on stderr);
3. kernel: each kernel against its plain PyTorch version on the card, with
   its time, the plain version's, the time of one PyTorch library call of the
   same function and the card's bound for the work:
   - K2 flash attention at the full-domain decoder shape, also as strided
     chunks of one packed QKV tensor (as the model passes them; bit-identical
     to the same call on contiguous copies), and at padded-D / ragged-S /
     forced shapes. Every call is made twice and must repeat bit-identically,
     and must run the variant its dtype selects (bf16: bf16 tensor cores,
     fp32: 3xTF32 tensor cores). fp32: |err| <= 2e-5 + 2e-5 |ref| against the
     plain version with TF32 off; bf16:
     |err| <= 2^-8 |ref| + 2^-8 max|ref| against the fp32 plain version on the
     same bf16-rounded inputs (P is rounded to bf16 for the P.V product, and
     the output to bf16);
   - K1 conv3x3 + GroupNorm (``conv3x3_stats`` then ``gn_apply``) at every
     decoder chain shape of the 128-px path (batch 16) and of the 608x800 path
     (batch 2), each in bf16 and fp32, at the two ``perf_probe`` shapes (batch 26) and
     at ragged shapes (H, W off every tile, Cin and Cout off the chunk and off
     64), where every launch shape the plan could choose is forced in turn
     and held to the same tolerance; each row names the variant, tile and
     chunk the plan chose and gives ``ms`` (the wrapper as the model calls
     it) beside ``kernel_ms`` (the kernel's device time alone with its operands
     cold, as the bound's bytes at the memory rate assume: a CUDA-graph replay
     of 20 calls, each on its own copy of the operands, after a flush of L2;
     ``profile_port.device_ms``), and ``library_ms`` (one PyTorch call) beside
     ``library_kernel_ms`` (the device time of the kernels that call launches,
     measured the same way); tolerances in each row. Bounds: ``profile_port.bound``
     (fp32 operations by the faster of FMAs at 67 and 3xTF32 at 495 TFLOP/s);
   - the decoder's 2x bilinear upsample (``upsample2x``) at the final decoder
     block of the gen cell (1,024 x 64x64x64 bf16) and of the 608x800 path
     (2 x 304x400x64, bf16 and fp32): equal to the plain version bit for bit,
     repeated bit for bit, one launch a call; ``ms`` (the wrapper),
     ``kernel_ms`` (device time, cold where 20 copies fit beside each other),
     the bound by bytes (x read once, the output written once), the plain
     version's ms and ``F.interpolate``'s (bilinear, ``align_corners=False``,
     on the channels_last view: the library's call, which the port never makes);
   - K1 with a per-sample bias and the SiLU epilogue (CorrDiff's SongUNet
     blocks, ``phase_corrdiff_k1``) at 8 x 448x448, 384 -> 128 and 8 x 28x28,
     512 -> 256, bf16, 32 groups: within the bf16 tolerances above, one launch
     of the variant counted, the per-channel route bit for bit what the
     variant computes with the bias moved into it, and the chain's device time
     beside its bound;
   - the standalone NHWC GroupNorm (``group_norm_stats`` then
     ``group_norm_apply``, CorrDiff's GN0 -> SiLU, ``phase_group_norm_kernel``)
     at the cell's largest and smallest maps, 8 x 448x448x128 and 8 x
     28x28x512, bf16, 32 groups: against ``F.group_norm`` in fp32 (bf16's 2e-2),
     repeated bit for bit, one ``group_norm`` and one ``group_norm_stats``
     launch counted and none of ``gn_apply`` (its launches on the main path
     are read in 5f); each kernel's device time beside its bound by bytes (the
     statistics read x once, the normalise reads it and writes its result), and
     the parent's route (``F.group_norm`` of the fp32 NCHW map, the cast back,
     ``F.silu``, the copy to NHWC) as the library's time;
3b. kernel (K2 backward): delta, dk/dv and dq (one ``_launch_bwd``; dk/dv and
   dq on the tensor cores, bf16 mma.sync or 3xTF32) on strided q, k, v against
   the dense plain backward in fp32, bf16 and fp32, at the full-domain shape
   and off it: each gradient within 1e-2 (bf16) or 1e-4 (fp32) of its max
   |ref|, a repeat bit-identical, the forward's lse output within 1e-4 of the
   plain lse; its time warm and cold and each kernel's apart, the plain
   version's, SDPA's backward and the bound (``profile_port.k2bwd_rows``);
4. model: a tiny fp32 UNet on the card against the same weights on the CPU
   (TF32 off, attention kernel forced: max |err| <= 1e-4 max |ref|, with 8 K1
   launches), and flagship bf16 forwards at 128 px (batch 16) and 608x800
   (batch 2) against the same forward with the plain chain in place of K1 and,
   at 608x800, the plain attention in place of K2 (max |err| <= 5e-2 max |ref|);
Each path from 5 on runs on its CUDA graphs, the route the port's entry
points take on the card (``sbgm_danra_tpu_torch/capture.py``,
``sampling/graphs.py``, the captured train step, ``training/fused.py``): a
first call captures (two eager warm-up calls on a side stream, then the
capture), and the measured run is a replay. A graph records K1's and K2's
launches at capture and adds them to the wrappers' counts at each replay; each
phase prints its graphs (launches per replay, replays, capture and
instantiate seconds, pool bytes), the graph's and the eager route's wall
times, and the graph's output against the eager route's on the same draws
(max |diff|, whether bit-identical, the tolerance ``GRAPH_TOL`` of max |eager|:
1e-3 bf16, 1e-5 fp32).

5. full_domain: ``sample_full_domain`` 589x789 -> 608x800, EDM-18, CFG w=3,
   flagship bf16 UNet with attention backend 'pallas', seeded weights: the
   capture, two replays, each finite of shape (1, 589, 789) with exactly 34
   K2 launches, all of the tensor-core variant, 272 K1 launches (8 per
   UNet evaluation, 2 x 17 evaluations) and 170 upsample launches (5 per
   evaluation); then the eager loop (``capture=False``) on the first
   replay's draws: the same counts;
5b. fp32_full_width: the flagship in fp32 (the 3xTF32 kernels) at 608x800:
   one forward at batch 2 against the plain attention and the plain chain
   (TF32 off: max |err| <= 1e-4 max |ref|, 1 ``fp32`` K2 and 8 + 8 K1
   launches), the same forward under PyTorch's default flags
   (``cudnn.allow_tf32`` True) and TF32 off against the CPU (reported, ROADMAP
   F7), and one EDM-18 sample through ``sample_full_domain(compute_dtype=
   "float32")`` on its graph, captured with TF32 off (checked at every UNet
   evaluation of the capture) and the flags restored after the call: 34
   ``fp32`` and no ``tc_bf16`` K2 launches, 272 + 272 K1, finite (1, 589,
   789), its wall time beside the bf16 samples', then the eager loop on the
   same draws; then F7's cost on the eager loop: the same sample with TF32
   on and off (wall time, two each, and cuDNN's conv device time under the
   profiler, one each);
5c. train_128: ``TrainingPipeline.train_batches`` on the flagship bf16 UNet at
   128x128, batch 128, Adam lr 5e-4 with EMA, on the step's graph and then on
   the eager step from the same seed: a first step (the capture), 5 timed
   steps with no K1 or K2 launch, loss finite, EMA and BatchNorm statistics
   moved, step time, samples/s, peak memory, the two routes' per-step losses
   (within ``GRAPH_TOL``) and trained states (parameters, BatchNorm
   statistics, EMA within ``STATE_DRIFT_TOL`` of what training moved them);
   then one EMA eval step on each route (8 K1 launches a replay);
5d. train_data: the flagship's data path (``configs/flagship_synth.yaml``
   through ``profile_port.data_config``): 32 synthetic days at 589x789 (no
   'all' split), the card-resident stacks, the card sampler at batch 128
   against the same sampler on the CPU with the same draws (every key equal,
   the SDF within 1e-6), its SDF against the host EDT on all 128 masks
   (1e-4), the sampler's device ms and launches, 20 flagship steps on the
   one-step graph each on the device loader and random batches, 6 on the
   host loader (1 worker); ``training.fused_steps`` = 25 (K steps per dispatch,
   each batch drawn inside the graph) against the one-step graph over two
   epochs of 25 steps on the same draws with cuDNN deterministic: per-step
   losses within ``FUSED_TOL`` (1e-6 relative), seconds a step, both routes'
   graphs; ``train_main`` for one epoch of 25 steps as configured (one
   dispatch of 25 steps) with its checkpoint read back; and one EDM-18
   full-domain sample conditioned on the first test day with the trained EMA
   weights, back-transformed, on its graph: 272 K1 and 34 K2 launches a
   replay;
5d'. generate: on 5d's data and checkpoint, the port's CLI as
   ``main_app.run_mode`` calls it: ``--mode generate`` with ``gen_type:
   [multiple, single, repeated]`` (dpmpp-25, CFG w=3, 4 conditions, 8
   members; each mode captured once, then replayed alone: 8 K1 launches a
   UNet evaluation, no K2), then ``[full_domain]`` with EDM-18 (272 K1 and 34
   ``tc_bf16`` K2 a replay); the npz names and shapes, finite, prcp >= 0, 8
   distinct members; ``--mode evaluate`` with pixel and spatial statistics,
   CRPS and spectra (files written, finite); the exact-score quality study
   (``evaluate/quality_study.py``, 64 members, 16x16, 256 truths; edm-18,
   dpmpp-25, pc-100 on the three headline regimes: std ratio and
   spread/skill in [0.9, 1.1]); ``generate_previews`` after captured train
   steps against the eager loop on the same draws; each mode's load,
   capture and replay seconds and pools;
5d+. quality: on 5d's checkpoint, the port's quality scripts through their
   ``main(argv, cfg)`` on the card (``phase_quality``): ``flagship_quality_eval``
   (2 dates x 4 members; EDM w in {3, 0, 7}, dpmpp 25 / 35, the valid-split
   calibration, PC-1000 on its eager route) with every JSON key and metric,
   K1 launches = 8 x each run's UNet evaluations and K1 against the plain
   chain at the runs' batches; ``full_domain_quality_eval``
   (1 date, 2 members, 608x800, w in {0, 3}): K1 likewise, one ``tc_bf16`` K2
   launch a UNet evaluation, finite in- and out-of-crop CRPS;
   ``edm_quality_study`` (8 members, 16 truths); a 2-step flagship epoch with
   ``training.profile_dir`` (the capture inside the profiler; the Chrome trace
   names the graph's launches and card kernels; the throughput line; a step
   with and without the profiler, and the trace's export); torch -> Flax ->
   torch on the checkpoint,
   bit-identical;
5d''. data_prep: a raw archive to generated fields with the port alone, through
   its CLIs (``profile_port.data_config``'s flagship data, 32 days, under
   5d's temporary directory): ``--mode synthetic_data`` with the 'all'
   split, ``data_splits`` (Random: the splits add up, are disjoint and equal
   the 'all' store day for day), ``run_statistics`` into a fresh directory
   (each JSON against the synthetic writer's: 1e-9 relative, std 1e-6),
   ``train`` (one epoch of 2 steps on the device loader) and ``generate``
   single on its checkpoint (finite, prcp >= 0, 8 K1 launches a UNet
   evaluation), then ``main_data_app``'s ``run_comparison``,
   ``run_correlation``, ``create_small_batches`` and ``run_statistics
   --figures`` (without matplotlib: one skip line a figure set); each mode's
   wall seconds;
5d'''. windowed: on 5d's stores, ``data_handling.device_window_days`` 6 over
   the 22 train days (4 windows, bf16 staging), ``fused_steps`` 25,
   ``training.async_checkpointing``, through ``make_loaders`` and
   ``TrainingPipeline.train``: two epochs in fixed mode (25 steps a window)
   and one swap-on-ready; every window visited, 3 swaps an epoch, at most two
   fused graphs (one a card slot) and no capture after the first epoch, the
   slots equal to the host days after the bf16 cast, K1 on the eval steps (as
   many launches as the validations call for) and against the plain chain at
   the eval batch, each asynchronous save against
   a blocking copy of what it saves, the step time against the resident
   loader's on the same stores, one fp32 window against the resident sampler
   bit for bit, the host's decode ms a day (native codec and zlib), the
   pinned copy's GB/s and a projection for a 30-year archive;
5d''''. sweep: ``run_sweep`` with 2 trials of ``configs/sweep_tpu.yaml``'s
   model on 5d's stores in this process: the card's reserved memory after
   each trial (trial 2 at most 5% above trial 1), K1 fp32 on the eval steps
   (as many launches as the validations call for) and each trial's UNet at
   its eval batch against the plain chain;
5d*. parallel: ``sbgm_danra_tpu_torch/parallel/`` with its ranks as child
   processes (``parallel.launch.spawn``; ``phase_parallel``): (a) NCCL on one
   rank, the train-128 DP step on its CUDA graph (the all-reduce captured)
   against the single-device step's graph, and both steps' times; (b) two
   gloo ranks on the one card (CUDA tensors staged through pinned host
   memory; NCCL refuses two ranks on one device), eager: the train-128 and
   full-domain DP steps against one device (2 K2 forward and 1 backward
   launch a rank), the member-sharded ensemble (8 members, 4 a rank,
   dpmpp-25 CFG w=3: 192 K1 launches a rank, rows against the one-card
   call), ring attention at [2, 7600, 4, 32] and the full-domain UNet with
   attention 'ring' (the layers that ran ring-sharded), TP on {model: 2} and
   the day-sharded windows through one DP step; each route on its line;
5e. train_full_domain: 5c's step at 589x789 -> 608x800, batch 2, attention
   'pallas', remat, on the step's graph: bf16, a capture and 3 replays with
   2 K2 forward and 1 K2 backward launch each (decoder block 1 at [2, 7600,
   4, 32]); then, from one saved state, the graph's step against the eager
   step (loss within ``GRAPH_TOL``, gradients reported) and the eager step
   against the same step with K2 swapped for the plain attention: loss
   within 1e-2 and each parameter's gradient (a fused qkv projection's q, k
   and v parts apart) within ``GRAD_REL_TOL`` of its max |ref|; fp32, one
   step (the fp32 variants);
5f. corrdiff: ``evaluate/corrdiff.generate`` as the cell ``corrdiff-448-ens``
   runs it: both SongUNets at their published widths (55 blocks, 6 of them
   with attention), bf16, one date x 8 members at 448x448, the regression
   eagerly and the residual's 34 evaluations on the sampler's graph. A first
   call captures; the counts are zeroed, then a second call's launches are
   read: 62 standalone GroupNorms an evaluation (``group_norm`` and
   ``group_norm_stats``, 2,108 a replay in ``capture.stats()`` and 62 eager)
   and 55 K1 chains (``conv3x3_stats``, its per-sample-bias variant and
   ``gn_apply``, 1,870 a replay and 55 eager); the fields finite;
6. serving: the engine with the flagship_synth settings (one graph replay per
   dispatch at the member capacity 8) behind the HTTP handler on a
   localhost port: /healthz, three concurrent /generate requests (1, 2 and 4
   members), then each again alone, which must come back bit-identical; K1
   launches = the graph's per replay x dispatches; then the same requests on
   an engine with ``capture=False`` against the graph engine's, both called
   directly;
7. samplers: at 128 px, flagship bf16 UNet, CFG w=3, batch 13 (the bench's
   contract batch), 10 steps: pc, em, ode rk4 and ode heun, each on its graph
   (a capture, then a replay with K1 launches = 8 x its score evaluations)
   and on the eager loop from the same seed, finite of the right shape.

Each path's launch counts are set to 0 just before it runs and read just
after. Then a ``timing`` line (the build's and each phase's wall seconds),
the kernels' summary line, the ``nvidia-smi`` name and power limit
line, and ``{"ok": true, "device": {...}}`` as the last line. Any failure
raises and exits non-zero; without a CUDA device the script exits 1 and
prints nothing on stdout.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import numpy as np
import torch

from profile_port import (CHAINS_128, CHAINS_FULL, COLD_COPIES, DATA_DAYS, K1_RAGGED, OnCard,
                          RepeatedDays, bound, data_config, device_ms, k2bwd_rows, profile,
                          sampler_profile, sfu_rate, step_seconds, train_batches, train_config)
from sbgm_danra_tpu_torch.ops import launches as launch_counts

FULL_DOMAIN = (589, 789)
EDM_NODES = 18
SERVE_HW = (128, 128)
CONTRACT_BATCH = 13  # bench.py's PC+CFG headline batch
SAMPLER_STEPS = 10
K1_PER_EVAL = 8  # decoder chains per UNet evaluation: 4 GroupNorm blocks x 2
UP_PER_EVAL = 5  # upsamples per UNet evaluation: decoder blocks 0-3 and the final block
UPSAMPLE_SHAPES = (  # (path, x [N, H, W, C] of its final decoder block, dtype)
    ("gen-128-ensemble", (1024, 64, 64, 64), torch.bfloat16),
    ("full-domain", (2, 304, 400, 64), torch.bfloat16),
    ("full-domain", (2, 304, 400, 64), torch.float32),
)
K2_MAIN = ((2, 7600, 4, 32), torch.bfloat16)  # decoder block 1 at 608x800
K2_SHAPES = [  # (shape, dtype, packed QKV chunks, through the dispatcher with the kernel forced)
    ((2, 7600, 4, 32), torch.bfloat16, False, False),
    ((2, 7600, 4, 32), torch.bfloat16, True, False),
    ((1, 4096, 4, 64), torch.bfloat16, False, False),
    ((2, 300, 4, 128), torch.bfloat16, False, True),
    ((1, 33, 1, 32), torch.bfloat16, False, True),
    ((2, 1000, 2, 24), torch.bfloat16, False, False),  # padded head dim, ragged S
    ((2, 7600, 4, 32), torch.float32, False, False),
    ((2, 1000, 2, 24), torch.float32, False, False),
    ((1, 4096, 4, 64), torch.float32, False, False),
    ((1, 4096, 4, 64), torch.float32, True, False),
    ((1, 300, 4, 128), torch.float32, False, True),
]
K2_VARIANT = {torch.bfloat16: "tc_bf16", torch.float32: "fp32"}
BF16_TOLERANCE = ("bf16: |err| <= 2^-8 |ref| + 2^-8 max|ref| against the fp32 plain version on "
                  "the same bf16-rounded inputs (P rounded to bf16 for P.V, bf16 output)")
K1_SHAPES = (  # (path, batch, (H, W, Cin, Cout), dtype, activation)
    [("serve-128", 16, c, torch.bfloat16, False) for c in dict.fromkeys(CHAINS_128)]
    + [("serve-128", 16, c, torch.float32, False) for c in dict.fromkeys(CHAINS_128)]
    # the generate phase's 128-px UNet batches: 1 row (single) and 4 rows
    # (multiple, previews), doubled by CFG; plan() picks their tiles by batch
    + [("generate-128", n, c, torch.bfloat16, False) for n in (2, 8)
       for c in dict.fromkeys(CHAINS_128)]
    + [("full-domain", 2, c, dt, False) for dt in (torch.bfloat16, torch.float32)
       for c in dict.fromkeys(CHAINS_FULL)]
    + [("perf_probe", 26, (64, 64, 64, 64), torch.bfloat16, False),
       ("perf_probe", 26, (32, 32, 128, 64), torch.bfloat16, False),
       ("perf_probe", 26, (64, 64, 64, 64), torch.bfloat16, True)]
    + [("ragged", n, c, dt, False) for dt in (torch.bfloat16, torch.float32)
       for n, c in K1_RAGGED]
)


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches after one warm-up."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def cold_ms(call, *operands) -> float:
    """``call(*operands)``'s device time with the operands cold (``device_ms``)."""
    copies = [[t.clone() for t in operands] for _ in range(COLD_COPIES)]
    return device_ms(torch, [functools.partial(call, *c) for c in copies])


def _k2_inputs(shape, dtype, packed, gen, dev):
    b, s_len, h, d = shape
    if packed:  # chunks of one [B, S, 3C] tensor, as the model's QKV projection gives them
        qkv = torch.randn(b, s_len, 3 * h * d, generator=gen, device=dev).to(dtype)
        return [t.reshape(shape) for t in qkv.chunk(3, dim=-1)]
    return [torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3)]


def phase_attention_kernel(dev, exp_rate: float):
    from sbgm_danra_tpu_torch.ops import cuda_attention
    from sbgm_danra_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(dev).manual_seed(0)
    results, failed = [], []
    for shape, dtype, packed, forced in K2_SHAPES:
        q, k, v = _k2_inputs(shape, dtype, packed, gen, dev)
        if forced:
            fa._FORCE_KERNEL = True
            run = lambda: fa.flash_attention(q, k, v)  # noqa: E731
        else:
            run = lambda: cuda_attention.flash_attention_cuda(q, k, v)  # noqa: E731
        try:
            before = launch_counts.snapshot()
            out = run()
            torch.cuda.synchronize()
            ran = k2_counts("fwd", launch_counts.since(before))
            repeat_identical = torch.equal(run(), out)
            ms = cuda_ms(run, 20)
        finally:
            fa._FORCE_KERNEL = False
        ref = cuda_attention.flash_attention_reference(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs()
        ref_max = ref.abs().max().item()
        if dtype == torch.float32:
            tol, tol_text = 2e-5 + 2e-5 * ref.abs(), "fp32: 2e-5 abs + 2e-5 rel, TF32 off"
        else:
            tol, tol_text = 2.0**-8 * ref.abs() + 2.0**-8 * ref_max, BF16_TOLERANCE
        worst = (err / tol).max().item()
        variant_ok = ran == {name: int(name == K2_VARIANT[dtype]) for name in ran}
        extra = {}
        if packed:
            contiguous = cuda_attention.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                                             v.contiguous())
            extra["bit_identical_to_contiguous"] = torch.equal(out, contiguous)
        plain_ms = cuda_ms(lambda: cuda_attention.flash_attention_reference(
            q.float(), k.float(), v.float()), 5)
        library_ms = cuda_ms(lambda: fa.dense_attention(q, k, v), 20)
        b, s_len, h, d = shape
        ok = (worst <= 1.0 and repeat_identical and variant_ok
              and extra.get("bit_identical_to_contiguous", True))
        row = dict(phase="kernel", kernel="flash_attention_fwd", variant=K2_VARIANT[dtype],
                   shape=list(shape), dtype=str(dtype).split(".")[-1], packed_qkv_views=packed,
                   forced_dispatch=forced, max_abs_err=err.max().item(), ref_max_abs=ref_max,
                   max_abs_err_over_ref_max=err.max().item() / ref_max,
                   worst_err_over_tolerance=worst, tolerance=tol_text, ok=ok,
                   variant_launches=ran, repeat_bit_identical=repeat_identical, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   library="F.scaled_dot_product_attention", **extra,
                   **bound(4.0 * b * h * s_len * s_len * d, 4 * q.numel() * q.element_size(),
                           dtype_name(dtype), exps=float(b * h * s_len * s_len),
                           exp_rate=exp_rate))
        emit(**row)
        if not ok:
            failed.append(f"{shape} {dtype} (packed {packed}): worst err/tol {worst}, repeat "
                          f"identical {repeat_identical}, variant launches {ran}, {extra}")
        results.append(row)
    check(not failed, "K2 disagrees with its plain version at " + "; ".join(failed))
    return results


K2_BWD_SHAPES = {  # dtype: shapes; the full-domain decoder shape first, then off-path checks
    torch.bfloat16: ((2, 7600, 4, 32), (1, 4096, 2, 64), (2, 333, 2, 24)),
    torch.float32: ((2, 7600, 4, 32), (2, 1000, 2, 128)),
}
K2_BWD_TOLERANCE = {torch.bfloat16: 1e-2, torch.float32: 1e-4}  # of each gradient's max |ref|


def phase_attention_backward(dev):
    """K2's backward kernels (delta, dk/dv, dq: one ``_launch_bwd``) against the
    dense plain backward, with their times, SDPA's backward and the bound
    (``profile_port.k2bwd_rows``); each gradient within the dtype's tolerance
    of its max |ref|, a repeat bit-identical, the forward's lse output within
    1e-4 of the plain lse, and only the dtype's variant launched."""
    rows = []
    for dtype, shapes in K2_BWD_SHAPES.items():
        before = launch_counts.snapshot()
        got = k2bwd_rows(torch, dev, dtype_name(dtype), shapes)
        ran = k2_counts("bwd", launch_counts.since(before))
        variant, tol = K2_VARIANT[dtype], K2_BWD_TOLERANCE[dtype]
        for row in got:
            worst = max(row["rel_err"].values())
            row = dict(phase="kernel", kernel="flash_attention_bwd", variant=variant,
                       packed_qkv_views=True, max_abs_err=worst,
                       worst_err_over_tolerance=worst / tol,
                       tolerance=f"each gradient within {tol} of its max |ref| against the "
                                 "dense plain backward in fp32", library="SDPA backward",
                       ok=(worst <= tol and row["repeat_bit_identical"]
                           and row["lse_max_abs_err"] <= 1e-4), **row)
            emit(**row)
            check(row["ok"], f"K2 backward disagrees with its plain version: {row}")
            rows.append(row)
        check(set(n for n, c in ran.items() if c) == {variant},
              f"K2 backward {dtype}: launches by variant {ran}")
    return rows


def phase_conv_gn_kernel(dev):
    """K1's two kernels, each against its plain version, at the paths' shapes."""
    import torch.nn.functional as F

    from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1

    gen = torch.Generator(dev).manual_seed(1)
    rows = []
    for path, n, (h, w, cin, cout), dtype, act in K1_SHAPES:
        torch.backends.cudnn.allow_tf32 = False  # both sides in full fp32
        groups = 8
        x = torch.randn(n, h, w, cin, generator=gen, device=dev).to(dtype)
        kernel = torch.randn(3, 3, cin, cout, generator=gen, device=dev) / (3 * cin**0.5)
        bias = 0.1 * torch.randn(cout, generator=gen, device=dev)
        gamma = 1.0 + 0.1 * torch.randn(cout, generator=gen, device=dev)
        beta = 0.1 * torch.randn(cout, generator=gen, device=dev)

        conv, stats = k1.conv3x3_stats(x, kernel, bias, groups)
        out = k1.gn_apply(conv, stats, gamma, beta, groups, activation=act)
        torch.cuda.synchronize()
        again = k1.conv3x3_stats(x, kernel, bias, groups)
        repeat_identical = (torch.equal(again[0], conv) and torch.equal(again[1], stats)
                            and torch.equal(k1.gn_apply(*again, gamma, beta, groups,
                                                        activation=act), out))
        plain_conv, plain_stats = k1.plain_conv3x3_stats(x.float(), kernel.to(dtype),
                                                         bias.to(dtype), groups)
        conv_err = (conv.float() - plain_conv).abs()
        # gn_apply on the kernel's own conv and statistics, so each kernel is
        # held to its own work
        apply_ref = k1.plain_gn_apply(conv, stats, gamma, beta, groups, activation=act,
                                      out_dtype=torch.float32)
        apply_err = (out.float() - apply_ref).abs().max().item()
        chain_ref = k1.reference_chain(x, kernel, bias, gamma, beta, groups, activation=act,
                                       out_dtype=torch.float32)
        chain_diff = (out.float() - chain_ref).abs()
        chain_err = chain_diff.max().item()
        stats_rel = ((stats - plain_stats).abs().max() / plain_stats.abs().max()).item()
        ref_max = chain_ref.abs().max().item()
        if dtype == torch.float32:
            conv_ok = bool((conv_err <= 1e-4 * plain_conv.abs().max()).all())
            conv_tol = ("fp32 (3xTF32 on the card), plain version with TF32 off: |err| <= 1e-4 "
                        "max|ref|")
            apply_ok, chain_ok = apply_err <= 1e-4 * ref_max, chain_err <= 1e-4 * ref_max
            out_tol = chain_tol = "fp32: |err| <= 1e-4 max|ref| (summation order only)"
        else:
            conv_ok = bool((conv_err <= 4e-3 * plain_conv.abs() + 1e-4 * plain_conv.abs().max())
                           .all())
            conv_tol = ("bf16 output vs the fp32 plain conv of the same bf16 inputs: "
                        "|err| <= 4e-3 |ref| + 1e-4 max|ref| (one bf16 rounding, 2^-9 relative)")
            apply_ok = apply_err <= 2e-2
            chain_ok = bool((chain_diff <= 2e-2 + 2.0**-7 * chain_ref.abs()).all())
            out_tol = ("bf16 vs the fp32 plain version on the same bf16-rounded inputs: "
                       "|err| <= 2e-2 (outputs are normalised, |v| < 8: half a bf16 ulp "
                       "is at most 1.6e-2)")
            chain_tol = ("chain vs the plain chain: |err| <= 2e-2 + 2^-7 |ref|; each side "
                         "rounds its own fp32 conv to bf16 before normalising, and where the "
                         "two sums straddle a rounding boundary the conv differs by one bf16 "
                         "ulp (<= 2^-8 relative), which the normalisation carries into |ref|")
        stats_ok = stats_rel <= 1e-4
        args = (x, kernel, bias, groups)
        chosen = k1.plan(n, h, w, cin, cout, dtype)
        forced = {}
        if path == "ragged":
            # every launch shape that fits, at the same tolerance; and on x at the
            # end of a buffer with NaN behind it, which must change no bit: a Cin
            # off the chunk is zero-filled, not read past
            x_tail = torch.full((x.numel() + 256,), float("nan"), dtype=dtype, device=dev)
            x_tail = x_tail[:x.numel()].view(x.shape).copy_(x)
            shapes = k1.LAUNCH_SHAPES if dtype == torch.bfloat16 else k1.FP32_LAUNCH_SHAPES
            for force in shapes:
                try:
                    k1.plan(n, h, w, cin, cout, dtype, force=force)
                except ValueError:
                    continue  # above the shared memory a block may use
                f_conv, f_stats = k1.conv3x3_stats(*args, force=force)
                f_err = (f_conv.float() - plain_conv).abs()
                f_tol = 1e-4 * plain_conv.abs().max()
                if dtype == torch.bfloat16:
                    f_tol = f_tol + 4e-3 * plain_conv.abs()
                f_ok = bool((f_err <= f_tol).all())
                f_rel = ((f_stats - plain_stats).abs().max() / plain_stats.abs().max()).item()
                t_conv, t_stats = k1.conv3x3_stats(x_tail, kernel, bias, groups, force=force)
                tail_ok = torch.equal(t_conv, f_conv) and torch.equal(t_stats, f_stats)
                forced["x".join(map(str, map(int, force)))] = dict(
                    max_abs_err=f_err.max().item(), stats_rel_err=f_rel,
                    nan_behind_x_changes_nothing=tail_ok,
                    ok=f_ok and f_rel <= 1e-4 and tail_ok)
        ms_conv = cuda_ms(lambda: k1.conv3x3_stats(*args), 20)
        ms_apply = cuda_ms(lambda: k1.gn_apply(conv, stats, gamma, beta, groups,
                                               activation=act), 20)
        kernel_ms_conv = cold_ms(lambda *a: k1.conv3x3_stats(*a, groups), x, kernel, bias)
        kernel_ms_apply = cold_ms(lambda *a: k1.gn_apply(*a, groups, activation=act),
                                  conv, stats, gamma, beta)
        plain_ms_conv = cuda_ms(lambda: k1.plain_conv3x3_stats(*args), 5)
        plain_ms_apply = cuda_ms(lambda: k1.plain_gn_apply(conv, stats, gamma, beta, groups,
                                                           activation=act), 5)
        # the library's calls for the same functions, in the working dtype:
        # cuDNN's conv on the channels_last view, then F.group_norm (+ relu)
        x_nchw = x.permute(0, 3, 1, 2)
        w_oihw = kernel.permute(3, 2, 0, 1).to(dtype).contiguous(memory_format=torch.channels_last)
        conv_nchw = conv.permute(0, 3, 1, 2)
        g_d, b_d, bias_d = gamma.to(dtype), beta.to(dtype), bias.to(dtype)
        lib_conv = cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, bias_d, padding=1), 20)

        def lib_gn(c=conv_nchw, g=g_d, b=b_d):
            y = F.group_norm(c, groups, g, b, 1e-5)
            return torch.relu(y) if act else y

        lib_apply = cuda_ms(lib_gn, 20)
        lib_kernel_conv = cold_ms(lambda *a: F.conv2d(*a, padding=1), x_nchw, w_oihw, bias_d)
        lib_kernel_apply = cold_ms(lib_gn, conv_nchw, g_d, b_d)
        es, pixels = x.element_size(), n * h * w
        flops = 2.0 * 9 * cin * cout * pixels
        conv_bytes = (pixels * (cin + cout) + 9 * cin * cout) * es + 4 * (cout + 2 * n * groups)
        apply_bytes = 2 * pixels * cout * es + 4 * (2 * n * groups + 2 * cout)
        row = dict(phase="kernel", kernel="conv3x3_gn", path=path, batch=n,
                   hw=[h, w], cin=cin, cout=cout, groups=groups,
                   dtype=str(dtype).split(".")[-1], activation=act,
                   repeat_bit_identical=repeat_identical,
                   conv3x3_stats=dict(variant=chosen.variant, tile=list(chosen.tile),
                                      chunk=chosen.chunk, grid=list(chosen.grid),
                                      shared_bytes=chosen.shared_bytes,
                                      forced_rows_cols_chunk_resident=forced,
                                      max_abs_err=conv_err.max().item(), ok=conv_ok,
                                      tolerance=conv_tol, stats_rel_err=stats_rel,
                                      stats_ok=stats_ok, ms=ms_conv,
                                      kernel_ms=kernel_ms_conv, plain_ms=plain_ms_conv,
                                      library_ms=lib_conv, library="F.conv2d",
                                      library_kernel_ms=lib_kernel_conv,
                                      **bound(flops, conv_bytes, dtype_name(dtype))),
                   gn_apply=dict(max_abs_err=apply_err, ok=apply_ok, tolerance=out_tol,
                                 ms=ms_apply, kernel_ms=kernel_ms_apply,
                                 plain_ms=plain_ms_apply, library_ms=lib_apply,
                                 library_kernel_ms=lib_kernel_apply,
                                 library="F.group_norm" + (" + relu" if act else ""),
                                 **bound(4.0 * pixels * cout, apply_bytes, "float32")),
                   chain=dict(max_abs_err=chain_err, ok=chain_ok, tolerance=chain_tol,
                              ms=ms_conv + ms_apply,
                              kernel_ms=kernel_ms_conv + kernel_ms_apply,
                              plain_ms=plain_ms_conv + plain_ms_apply,
                              library_ms=lib_conv + lib_apply))
        emit(**row)
        check(conv_ok and stats_ok and apply_ok and chain_ok,
              f"K1 disagrees with its plain version at {path} {n}x{h}x{w}x{cin}->{cout} "
              f"{dtype}: conv {conv_err.max().item()}, stats {stats_rel}, apply {apply_err}, "
              f"chain {chain_err}")
        check(repeat_identical, f"K1 did not repeat bit-identically at {path} "
                                f"{n}x{h}x{w}x{cin}->{cout} {dtype}")
        check(all(f["ok"] for f in forced.values()),
              f"a forced launch shape of conv3x3_stats disagrees at {n}x{h}x{w}x{cin}->{cout}: "
              f"{forced}")
        rows.append(row)
    torch.backends.cudnn.allow_tf32 = True
    return rows


def _large_or_cold_ms(call, *operands) -> float:
    """``cold_ms``, or where ``COLD_COPIES`` copies of the operands would take
    over 8 GB, five calls on one set: each then streams many times L2's size,
    so nothing of one call is left for the next."""
    if COLD_COPIES * sum(t.numel() * t.element_size() for t in operands) <= 8 * 2**30:
        return cold_ms(call, *operands)
    return device_ms(torch, [functools.partial(call, *operands)] * 5, cold=False)


CORRDIFF_K1_SHAPES = (  # (path, batch, (H, W, Cin, Cout)): CorrDiff's K1 chains, 8 members
    ("corrdiff_448", 8, (448, 448, 384, 128)),  # the decoder's first 448x448 block
    ("corrdiff_28", 8, (28, 28, 512, 256)),  # a decoder block at the attention resolution
)


def phase_corrdiff_k1(dev):
    """K1 with a per-sample bias and the SiLU epilogue (a SongUNet block's
    ``conv0 -> + emb -> GroupNorm(32) -> SiLU``, bf16) against its plain
    versions at CorrDiff's chains, its device time beside its bound; the
    per-channel route bit for bit what the variant computes with the bias
    moved into it; the variant's launch counter."""
    from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1

    gen = torch.Generator(dev).manual_seed(4)
    rows = []
    for path, n, (h, w, cin, cout) in CORRDIFF_K1_SHAPES:
        torch.backends.cudnn.allow_tf32 = False
        dtype, groups = torch.bfloat16, 32
        x = torch.randn(n, h, w, cin, generator=gen, device=dev).to(dtype)
        kernel = torch.randn(3, 3, cin, cout, generator=gen, device=dev) / (3 * cin**0.5)
        bias = 0.1 * torch.randn(cout, generator=gen, device=dev)
        sample_bias = torch.randn(n, cout, generator=gen, device=dev)
        gamma = 1.0 + 0.1 * torch.randn(cout, generator=gen, device=dev)
        beta = 0.1 * torch.randn(cout, generator=gen, device=dev)
        before = launch_counts.snapshot()
        conv, stats = k1.conv3x3_stats(x, kernel, bias, groups, sample_bias=sample_bias)
        launches = launch_counts.since(before)["conv3x3_stats_sample_bias"]
        out = k1.gn_apply(conv, stats, gamma, beta, groups, 1e-6, "silu")
        plain_conv, plain_stats = k1.plain_conv3x3_stats(x.float(), kernel.to(dtype),
                                                         bias.to(dtype), groups, sample_bias)
        conv_err = (conv.float() - plain_conv).abs()
        conv_ok = bool((conv_err <= 4e-3 * plain_conv.abs() + 1e-4 * plain_conv.abs().max())
                       .all())
        stats_rel = ((stats - plain_stats).abs().max() / plain_stats.abs().max()).item()
        apply_ref = k1.plain_gn_apply(conv, stats, gamma, beta, groups, 1e-6, "silu",
                                      out_dtype=torch.float32)
        apply_err = (out.float() - apply_ref).abs().max().item()
        moved = k1.conv3x3_stats(x, kernel, torch.zeros_like(bias), groups,
                                 sample_bias=bias.to(dtype).float().expand(n, cout))
        per_channel = k1.conv3x3_stats(x, kernel, bias, groups)
        unchanged = torch.equal(moved[0], per_channel[0]) and torch.equal(moved[1],
                                                                           per_channel[1])
        del plain_conv, apply_ref, moved, per_channel
        kernel_ms_conv = _large_or_cold_ms(
            lambda x, kernel, bias, sb: k1.conv3x3_stats(x, kernel, bias, groups, sample_bias=sb),
            x, kernel, bias, sample_bias)
        kernel_ms_apply = _large_or_cold_ms(lambda *a: k1.gn_apply(*a, groups, 1e-6, "silu"),
                                            conv, stats, gamma, beta)
        es, pixels = x.element_size(), n * h * w
        flops = 2.0 * 9 * cin * cout * pixels
        chain_bytes = ((pixels * (cin + cout) + 9 * cin * cout) * es + 4 * n * cout
                       + 2 * pixels * cout * es)
        b = bound(flops, chain_bytes, "bfloat16")
        row = dict(phase="kernel", kernel="conv3x3_gn_sample_bias_silu", path=path, batch=n,
                   hw=[h, w], cin=cin, cout=cout, groups=groups, dtype="bfloat16",
                   launches=launches, conv_max_abs_err=conv_err.max().item(), conv_ok=conv_ok,
                   stats_rel_err=stats_rel, apply_max_abs_err=apply_err,
                   per_channel_route_bit_identical=unchanged,
                   conv_kernel_ms=kernel_ms_conv, apply_kernel_ms=kernel_ms_apply,
                   chain_kernel_ms=kernel_ms_conv + kernel_ms_apply,
                   chain_bound_pct=100.0 * b["bound_ms"] / (kernel_ms_conv + kernel_ms_apply),
                   plan=k1.plan(n, h, w, cin, cout, dtype)._asdict(), **b)
        emit(**row)
        check(conv_ok and stats_rel <= 1e-4 and apply_err <= 2e-2 and launches == 1
              and unchanged, f"K1's per-sample-bias SiLU chain at {path}: {row}")
        rows.append(row)
        del x, conv, stats, out
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    return rows


GROUP_NORM_SHAPES = (  # (path, x [N, H, W, C]): CorrDiff's largest and smallest GN0 maps
    ("corrdiff_448", (8, 448, 448, 128)),
    ("corrdiff_28", (8, 28, 28, 512)),
)


def phase_group_norm_kernel(dev):
    """The standalone NHWC GroupNorm with SiLU against ``F.group_norm`` at
    ``GROUP_NORM_SHAPES``, each kernel's device time beside its bound."""
    import torch.nn.functional as F

    from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1

    gen = torch.Generator(dev).manual_seed(5)
    rows = []
    for path, (n, h, w, c) in GROUP_NORM_SHAPES:
        dtype, groups, eps = torch.bfloat16, 32, 1e-6
        x = torch.randn(n, h, w, c, generator=gen, device=dev).to(dtype)
        gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
        beta = 0.1 * torch.randn(c, generator=gen, device=dev)
        before = launch_counts.snapshot()
        out = k1.group_norm_cuda(x, gamma, beta, groups, eps, "silu")
        ran = launch_counts.since(before)
        launches = (ran["group_norm"], ran["group_norm_stats"], ran["gn_apply"])
        repeat = torch.equal(k1.group_norm_cuda(x, gamma, beta, groups, eps, "silu"), out)
        x_nchw = x.permute(0, 3, 1, 2)
        want = F.silu(F.group_norm(x_nchw.float(), groups, gamma, beta, eps)).permute(0, 2, 3, 1)
        err = (out.float() - want).abs().max().item()
        stats = k1.group_norm_stats(x, groups)
        stats_rel = ((stats - k1.plain_group_norm_stats(x, groups)).abs().max()
                     / stats.abs().max()).item()
        del want
        stats_ms = _large_or_cold_ms(lambda x: k1.group_norm_stats(x, groups), x)
        apply_ms = _large_or_cold_ms(
            lambda *a: k1.group_norm_apply(*a, groups, eps, "silu"), x, stats, gamma, beta)

        def parent_route():  # songunet's GroupNorm before the kernels, then K1's copy to NHWC
            y = F.silu(F.group_norm(x_nchw.float(), groups, gamma, beta, eps).to(dtype))
            return y.permute(0, 2, 3, 1).contiguous()

        library_ms = cuda_ms(parent_route, 5)
        x_bytes = x.numel() * x.element_size()
        b_stats = bound(0.0, x_bytes + 4 * 2 * n * groups, "bfloat16")
        b_apply = bound(0.0, 2 * x_bytes + 4 * 2 * n * groups + 8 * c, "bfloat16")
        row = dict(phase="kernel", kernel="group_norm", path=path, shape=[n, h, w, c],
                   groups=groups, dtype="bfloat16", activation="silu", max_abs_err=err,
                   stats_rel_err=stats_rel, repeat_bit_identical=repeat,
                   launches=launches[0], stats_launches=launches[1],
                   gn_apply_launches=launches[2],
                   stats_kernel_ms=stats_ms, stats_bound_ms=b_stats["bound_ms"],
                   stats_roofline_pct=100.0 * b_stats["bound_ms"] / stats_ms,
                   apply_kernel_ms=apply_ms, apply_bound_ms=b_apply["bound_ms"],
                   apply_roofline_pct=100.0 * b_apply["bound_ms"] / apply_ms,
                   kernel_ms=stats_ms + apply_ms,
                   roofline_pct=100.0 * (b_stats["bound_ms"] + b_apply["bound_ms"])
                   / (stats_ms + apply_ms),
                   stats_slots=k1.stats_slots(n, h * w, c, x.element_size()),
                   library_ms=library_ms,
                   library="the parent's route: F.silu(F.group_norm(fp32 NCHW).to(bf16)), "
                           "then the copy to contiguous NHWC")
        emit(**row)
        check(err <= 2e-2 and stats_rel <= 1e-5 and repeat and launches == (1, 1, 0),
              f"the NHWC GroupNorm at {path}: {row}")
        rows.append(row)
        del x, x_nchw, out, stats
        torch.cuda.empty_cache()
    return rows


def phase_upsample_kernel(dev):
    """The decoder's upsample kernel against its plain version at
    ``UPSAMPLE_SHAPES``, with its times beside the bound and the library's call."""
    import torch.nn.functional as F

    from sbgm_danra_tpu_torch.ops import upsample as up

    gen = torch.Generator(dev).manual_seed(2)
    rows = []
    for path, shape, dtype in UPSAMPLE_SHAPES:
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        before = launch_counts.snapshot()
        out = up.upsample2x(x)
        launches = launch_counts.since(before)["upsample2x"]
        bit_identical = torch.equal(out, up.upsample2x_bilinear(x))
        repeat = torch.equal(up.upsample2x(x), out)
        x_bytes = x.numel() * x.element_size()
        ms = cuda_ms(lambda: up.upsample2x(x), 20)
        cold = COLD_COPIES * 5 * x_bytes <= 8 * 2**30
        if cold:
            kernel_ms = cold_ms(up.upsample2x_cuda, x)
        else:  # each call streams many times L2's size: nothing of one is left for the next
            kernel_ms = device_ms(torch, [functools.partial(up.upsample2x_cuda, x)] * 5,
                                  cold=False)
        plain_ms = cuda_ms(lambda: up.upsample2x_bilinear(x), 3)
        x_nchw = x.permute(0, 3, 1, 2)

        def library():
            return F.interpolate(x_nchw, scale_factor=2, mode="bilinear", align_corners=False)

        library_ms = cuda_ms(library, 5)
        library_diff = (library().permute(0, 2, 3, 1).float() - out.float()).abs().max().item()
        b = bound(0.0, 5 * x_bytes, dtype_name(dtype))
        row = dict(phase="kernel", kernel="upsample2x", path=path, shape=list(shape),
                   dtype=dtype_name(dtype), bit_identical=bit_identical,
                   repeat_bit_identical=repeat, launches=launches, ms=ms, kernel_ms=kernel_ms,
                   kernel_ms_operands="cold copies" if cold else "one set, 5 x L2 or more",
                   roofline_pct=100.0 * b["bound_ms"] / kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms,
                   library="F.interpolate bilinear, align_corners=False (channels_last)",
                   library_max_abs_diff=library_diff, **b)
        emit(**row)
        check(bit_identical and repeat and launches == 1,
              f"upsample2x at {path} {shape} {dtype}: bit-identical {bit_identical}, repeated "
              f"{repeat}, {launches} launches")
        rows.append(row)
        del x, x_nchw, out
        torch.cuda.empty_cache()
    return rows


def k1_counts() -> tuple:
    return launch_counts.counts["conv3x3_stats"], launch_counts.counts["gn_apply"]


def k2_counts(kind: str = "fwd", counts=None) -> dict:
    """K2's ``kind`` ("fwd" or "bwd") launches by variant in ``counts`` (default: all so far)."""
    counts = launch_counts.counts if counts is None else counts
    return {v: counts[f"flash_attention_{kind}_{v}"] for v in K2_VARIANT.values()}


def check_k1(counts, evaluations: int, where: str) -> None:
    expected = K1_PER_EVAL * evaluations
    check(evaluations > 0 and counts == (expected, expected),
          f"{where}: K1 launched {counts} times (conv3x3_stats, gn_apply), "
          f"expected {expected} each for {evaluations} UNet evaluations")


def flagship_spec(**kw):
    from sbgm_danra_tpu_torch.models.unet import ModelSpec

    return ModelSpec(in_channels=6, num_classes=4, **kw)


def make_cond(batch: int, hw, dev, seed: int):
    g = torch.Generator(dev).manual_seed(seed)
    return {
        "y": torch.randint(1, 5, (batch,), generator=g, device=dev),
        "cond_img": torch.randn(batch, *hw, 2, generator=g, device=dev),
        "lsm_cond": (torch.rand(batch, *hw, 2, generator=g, device=dev) > 0.5).float(),
        "topo_cond": torch.randn(batch, *hw, 2, generator=g, device=dev),
    }


def _rel(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def plain_k1():
    """Swap the plain chain in for K1 on the decoder (restore by calling the result)."""
    from sbgm_danra_tpu_torch.models import unet
    from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1

    unet.conv3x3_gn_relu = k1.reference_chain
    return lambda: setattr(unet, "conv3x3_gn_relu", k1.conv3x3_gn_relu)


K1_FWD_TOL = {"bfloat16": 5e-2, "float32": 1e-4}  # UNet forward, K1 vs the plain chain: of max|ref|


def k1_vs_plain_forward(model, batch, dev, dtype: str, seed: int) -> dict:
    """``model`` (``train=False``) on a data batch's conditioning and noised
    field at a seeded t, with K1 and with the plain chain, inside the fp32
    precision rule of the trainer's steps (``exact_fp32``): the relative error
    of max |ref|, finiteness, and K1's launches in the K1 forward. The launch
    counts are put back afterwards: the forwards compare, they do not run the path."""
    from sbgm_danra_tpu_torch.precision import exact_fp32

    g = torch.Generator(dev).manual_seed(seed)
    cond = {k: batch[k] for k in ("y", "cond_img", "lsm_cond", "topo_cond")}
    x = batch["x"] + torch.randn(batch["x"].shape, generator=g, device=dev)
    t = torch.rand(batch["x"].shape[0], generator=g, device=dev) * 0.9 + 0.05
    before = launch_counts.snapshot()
    with torch.no_grad(), exact_fp32(dtype):
        launch_counts.reset()
        got = model(x, t, **cond)
        counts = k1_counts()
        restore = plain_k1()
        try:
            ref = model(x, t, **cond)
        finally:
            restore()
    launch_counts.reset()
    launch_counts.add_replay(before)
    rel = _rel(got, ref)
    return dict(rel_err=rel, tolerance=K1_FWD_TOL[dtype], finite=bool(torch.isfinite(got).all()),
                k1_launches=list(counts), batch=int(x.shape[0]), dtype=dtype)


def check_k1_forward(row: dict, where: str) -> None:
    check(row["rel_err"] <= row["tolerance"] and row["finite"],
          f"{where}, K1 vs plain chain: {row}")
    check_k1(tuple(row["k1_launches"]), 1, f"{where}, forward")


@contextlib.contextmanager
def watched_validations(hook=None):
    """``TrainingPipeline.validate_batches`` watched for the block: each
    validation's batch count (``min(max_steps, len(valid_loader))``, taken
    before it runs) is appended to the yielded list, and ``hook(pipe)`` runs
    after it while the pipeline lives. ``eval_evaluations`` turns the list
    into the UNet evaluations the eval steps must launch K1 for."""
    from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline

    original = TrainingPipeline.validate_batches
    batches = []

    def validate(self, max_steps=None):
        n = len(self.valid_loader)
        batches.append(n if max_steps is None else min(n, max_steps))
        out = original(self, max_steps)
        if hook is not None:
            hook(self)
        return out

    TrainingPipeline.validate_batches = validate
    try:
        yield batches
    finally:
        TrainingPipeline.validate_batches = original


def eval_evaluations(batches) -> int:
    """UNet evaluations of the captured eval steps over validations of
    ``batches`` batches each: each validation follows train replays, which
    make the K1 packs its graph reads stale, so it captures its graph anew
    (the warm-up calls run eagerly, the capture counts nothing) and replays
    it once a batch."""
    from sbgm_danra_tpu_torch.capture import WARMUP_CALLS

    return sum(n + WARMUP_CALLS for n in batches)


def phase_model(dev):
    """The UNet on the card against the CPU, and kernels vs plain versions in flagship forwards."""
    from sbgm_danra_tpu_torch.evaluate.full_domain import padded_dims
    from sbgm_danra_tpu_torch.models.unet import build_score_model, inference_spec
    from sbgm_danra_tpu_torch.ops import cuda_attention, flash_attention as fa

    tiny = flagship_spec(last_fmap_channels=64, time_embedding=32, num_heads=2,
                         block_layers=(1, 1, 1, 1), attention_backend="pallas")
    model = build_score_model(tiny, generator=torch.Generator().manual_seed(3))
    cond = make_cond(2, (64, 64), "cpu", 4)
    x = torch.randn(2, 64, 64, 1, generator=torch.Generator().manual_seed(5))
    t = torch.tensor([0.3, 0.8])
    with torch.inference_mode():
        ref = model(x, t, **cond)
        model.to(dev)
        torch.backends.cudnn.allow_tf32 = False
        fa._FORCE_KERNEL = True
        launch_counts.reset()
        try:
            got = model(x.to(dev), t.to(dev), **{k: v.to(dev) for k, v in cond.items()}).cpu()
        finally:
            fa._FORCE_KERNEL = False
            torch.backends.cudnn.allow_tf32 = True
        tiny_counts, tiny_k2 = k1_counts(), k2_counts()
    tiny_rel = _rel(got, ref)
    emit(phase="model", check="tiny fp32 UNet, card vs CPU", rel_err=tiny_rel, tolerance=1e-4,
         k1_launches=list(tiny_counts), k2_launches_by_variant=tiny_k2)
    check(tiny_rel <= 1e-4, f"tiny UNet on the card disagrees with the CPU: {tiny_rel}")
    check_k1(tiny_counts, 1, "tiny UNet forward")
    check(tiny_k2["fp32"] > 0 and tiny_k2["tc_bf16"] == 0,
          f"tiny fp32 UNet forward: K2 launches by variant {tiny_k2}")

    serve_model = build_score_model(flagship_spec(compute_dtype="bfloat16"),
                                    generator=torch.Generator().manual_seed(2)).to(dev)
    cond = make_cond(16, SERVE_HW, dev, 9)
    x = 2.0 * torch.randn(16, *SERVE_HW, 1, generator=torch.Generator(dev).manual_seed(10),
                          device=dev)
    t = torch.linspace(0.05, 1.0, 16, device=dev)
    with torch.inference_mode():
        launch_counts.reset()
        got = serve_model(x, t, **cond)
        counts = k1_counts()
        restore = plain_k1()
        try:
            ref = serve_model(x, t, **cond)
        finally:
            restore()
    rel = _rel(got, ref)
    finite = bool(torch.isfinite(got).all())
    emit(phase="model", check="flagship bf16 forward at 128 px, batch 16, K1 vs plain chain",
         rel_err=rel, tolerance=5e-2, finite=finite, k1_launches=list(counts))
    check(rel <= 5e-2 and finite, f"128-px forward, K1 vs plain chain: rel err {rel}")
    check_k1(counts, 1, "128-px forward")

    hw = padded_dims(*FULL_DOMAIN)
    spec = inference_spec(flagship_spec(compute_dtype="bfloat16", attention_backend="pallas"), hw)
    model = build_score_model(spec, generator=torch.Generator().manual_seed(0)).to(dev)
    cond = make_cond(2, hw, dev, 6)
    x = 2.0 * torch.randn(2, *hw, 1, generator=torch.Generator(dev).manual_seed(7), device=dev)
    t = torch.full((2,), 0.5, device=dev)
    with torch.inference_mode():
        launch_counts.reset()
        got = model(x, t, **cond)
        check(k2_counts() == {"tc_bf16": 1, "fp32": 0},
              "the full-domain forward did not use the tensor-core kernel")
        check_k1(k1_counts(), 1, "full-domain forward")
        fa.flash_attention_cuda = cuda_attention.flash_attention_reference
        try:
            ref_attn = model(x, t, **cond)
        finally:
            fa.flash_attention_cuda = cuda_attention.flash_attention_cuda
        restore = plain_k1()
        try:
            ref_k1 = model(x, t, **cond)
        finally:
            restore()
    rel_attn, rel_k1 = _rel(got, ref_attn), _rel(got, ref_k1)
    finite = bool(torch.isfinite(got).all())
    emit(phase="model", check="flagship bf16 forward at 608x800, kernels vs plain versions",
         rel_err_k2_vs_plain_attention=rel_attn, rel_err_k1_vs_plain_chain=rel_k1,
         tolerance=5e-2, finite=finite)
    check(rel_attn <= 5e-2 and rel_k1 <= 5e-2 and finite,
          f"full-domain forward rel err {rel_attn} (K2) / {rel_k1} (K1)")
    return model, serve_model, tiny_k2


def graph_stats(prefix: str) -> list:
    """The live CUDA graphs whose name starts with ``prefix`` (``capture.stats``)."""
    import gc

    from sbgm_danra_tpu_torch import capture

    gc.collect()
    return [g for g in capture.stats() if g["name"].startswith(prefix)]


def compare(graph_out, eager_out, tolerance: float) -> dict:
    """Graph output against the eager route's on the same draws: max |diff|,
    whether bit-identical, and ``tolerance`` (of max |eager|) it is held to."""
    a = np.asarray(torch.as_tensor(graph_out).float().cpu())
    b = np.asarray(torch.as_tensor(eager_out).float().cpu())
    diff = float(np.abs(a - b).max())
    return dict(max_abs_diff=diff, bit_identical=bool(np.array_equal(a, b)),
                max_abs_eager=float(np.abs(b).max()), tolerance_of_max_abs=tolerance,
                within=bool(diff <= tolerance * float(np.abs(b).max())))


def timed(fn):
    """``fn()`` and its wall seconds, the card synchronised at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_full_domain(dev, model):
    """The bf16 full-domain sample on its graph (the entry point's route on
    the card): the first call captures it (two eager warm-up samples on a side
    stream, then the capture), then two replays, each with 272 K1 and 34 K2
    launches counted; then the eager loop (``capture=False``) on the second
    replay's draws, which the graph must reproduce."""
    from sbgm_danra_tpu_torch.evaluate.full_domain import sample_full_domain
    from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig

    cond = make_cond(1, FULL_DOMAIN, dev, 8)
    config = SamplerConfig(num_steps=EDM_NODES, guidance_scale=3.0, s_churn=0.0)

    def run(seed, capture=None):
        return timed(lambda: sample_full_domain(
            model, torch.Generator(dev).manual_seed(seed), cond, domain_hw=FULL_DOMAIN, batch=1,
            config=config, sampler="edm_sampler", capture=capture))

    _, capture_call_s = run(0)  # warm-up, capture and one replay
    launch_counts.reset()  # the main path's run starts here: a replay of the graph
    out, first_s = run(1)
    k2_first, k1_first = k2_counts(), k1_counts()
    launches = sum(k2_first.values())
    up_first = launch_counts.counts["upsample2x"]
    launch_counts.reset()
    out2, second_s = run(2)
    k2_second, k1_second = k2_counts(), k1_counts()
    launches2 = sum(k2_second.values())
    up_second = launch_counts.counts["upsample2x"]
    launch_counts.reset()
    eager, eager_s = run(1, capture=False)
    k2_eager, k1_eager, up_eager = k2_counts(), k1_counts(), launch_counts.counts["upsample2x"]
    evaluations = 2 * (EDM_NODES - 1)
    finite = bool(np.isfinite(out).all() and np.isfinite(out2).all())
    vs_eager = compare(out, eager, GRAPH_TOL["bfloat16"])
    stats = graph_stats("edm_sampler 1x608x800")
    emit(phase="full_domain", domain="589x789->608x800", sampler=f"edm-{EDM_NODES}", cfg=3.0,
         route="CUDA graph (sampling/graphs.py), then the eager loop",
         shape=list(out.shape), finite=finite, kernel_launches=launches,
         kernel_launches_second_run=launches2, expected_launches=evaluations,
         k2_launches_by_variant=k2_first, k2_launches_by_variant_second_run=k2_second,
         k1_launches=list(k1_first), k1_launches_second_run=list(k1_second),
         k1_expected=K1_PER_EVAL * evaluations,
         upsample_launches=[up_first, up_second, up_eager],
         upsample_expected=UP_PER_EVAL * evaluations, graph=stats,
         capture_call_s=capture_call_s, wall_s_first=first_s, wall_s_second=second_s,
         eager_wall_s=eager_s, eager_k1_launches=list(k1_eager),
         eager_k2_launches_by_variant=k2_eager, graph_vs_eager=vs_eager,
         field_std=float(out.std()))
    check(out.shape == (1, *FULL_DOMAIN) and finite, f"bad full-domain output {out.shape}")
    check(launches == evaluations and launches2 == evaluations,
          f"kernel launched {launches}/{launches2} times, expected {evaluations}")
    tc_only = {"tc_bf16": evaluations, "fp32": 0}
    check(k2_first == tc_only and k2_second == tc_only and k2_eager == tc_only,
          f"K2 launches by variant {k2_first} / {k2_second} / eager {k2_eager}, "
          f"expected {tc_only}")
    check_k1(k1_first, evaluations, "full-domain sample (graph replay)")
    check_k1(k1_second, evaluations, "second full-domain sample (graph replay)")
    check_k1(k1_eager, evaluations, "full-domain sample (eager loop)")
    check([up_first, up_second, up_eager] == [UP_PER_EVAL * evaluations] * 3,
          f"full-domain upsample launches {[up_first, up_second, up_eager]} (graph, graph, "
          f"eager), expected {UP_PER_EVAL * evaluations} each")
    check(len(stats) == 1 and stats[0]["launches_per_replay"] == {
        "conv3x3_stats": K1_PER_EVAL * evaluations, "gn_apply": K1_PER_EVAL * evaluations,
        "flash_attention_fwd_tc_bf16": evaluations, "upsample2x": UP_PER_EVAL * evaluations},
          f"full-domain graph launches {stats}")
    check(vs_eager["within"], f"full-domain graph vs eager: {vs_eager}")
    return {"k2": k2_first, "conv3x3_stats": k1_first[0], "gn_apply": k1_first[1],
            "upsample2x": up_first,
            "eager": {"k2": k2_eager, "conv3x3_stats": k1_eager[0], "gn_apply": k1_eager[1],
                      "upsample2x": up_eager},
            "wall_s": [first_s, second_s], "eager_wall_s": eager_s}


def phase_fp32_full_width(dev, bf16_wall_s):
    """The fp32 full-domain path at full width, where K1 and K2 run their 3xTF32
    kernels: a 608x800 forward at batch 2 against the plain versions (TF32 off
    everywhere), the same forward under PyTorch's default flags against the
    CPU (ROADMAP F7), then one EDM-18 sample under the default flags."""
    from sbgm_danra_tpu_torch.evaluate.full_domain import padded_dims, sample_full_domain
    from sbgm_danra_tpu_torch.models.unet import build_score_model, inference_spec
    from sbgm_danra_tpu_torch.ops import cuda_attention, flash_attention as fa
    from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig

    default_tf32 = torch.backends.cudnn.allow_tf32
    saved_flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    hw = padded_dims(*FULL_DOMAIN)
    spec = inference_spec(flagship_spec(compute_dtype="float32", attention_backend="pallas"), hw)
    model = build_score_model(spec, generator=torch.Generator().manual_seed(0)).to(dev)
    cond = make_cond(2, hw, dev, 6)
    x = 2.0 * torch.randn(2, *hw, 1, generator=torch.Generator(dev).manual_seed(7), device=dev)
    t = torch.full((2,), 0.5, device=dev)
    with torch.inference_mode():
        torch.backends.cudnn.allow_tf32 = False
        try:
            launch_counts.reset()  # the fp32 forward's run starts here
            got = model(x, t, **cond)
            forward_k2, forward_k1 = k2_counts(), k1_counts()
            fa.flash_attention_cuda = cuda_attention.flash_attention_reference
            try:
                ref_attn = model(x, t, **cond)
            finally:
                fa.flash_attention_cuda = cuda_attention.flash_attention_cuda
            restore = plain_k1()
            try:
                ref_k1 = model(x, t, **cond)
            finally:
                restore()
        finally:
            torch.backends.cudnn.allow_tf32 = default_tf32
        got_default = model(x, t, **cond)
    model.cpu()  # outside inference mode, so that the parameters keep their version counters
    with torch.inference_mode():
        ref_cpu = model(x.cpu(), t.cpu(), **{k: v.cpu() for k, v in cond.items()})
    model.to(dev)
    rel_attn, rel_k1 = _rel(got, ref_attn), _rel(got, ref_k1)
    finite = bool(torch.isfinite(got).all() and torch.isfinite(got_default).all())
    emit(phase="fp32_full_width", check="flagship fp32 forward at 608x800, batch 2, kernels vs "
         "plain versions, cudnn.allow_tf32 False", rel_err_k2_vs_plain_attention=rel_attn,
         rel_err_k1_vs_plain_chain=rel_k1, tolerance=1e-4, finite=finite,
         k1_launches=list(forward_k1), k2_launches_by_variant=forward_k2,
         rel_err_card_vs_cpu_tf32_off=_rel(got.cpu(), ref_cpu),
         rel_err_card_vs_cpu_default_flags=_rel(got_default.cpu(), ref_cpu),
         default_cudnn_allow_tf32=default_tf32)
    check(rel_attn <= 1e-4 and rel_k1 <= 1e-4 and finite,
          f"fp32 608x800 forward rel err {rel_attn} (K2) / {rel_k1} (K1)")
    check(forward_k2 == {"tc_bf16": 0, "fp32": 1}, f"fp32 forward: K2 launches {forward_k2}")
    check_k1(forward_k1, 1, "fp32 608x800 forward")

    config = SamplerConfig(num_steps=EDM_NODES, guidance_scale=3.0, s_churn=0.0)
    sample_cond = make_cond(1, FULL_DOMAIN, dev, 8)

    tf32_seen = []  # TF32 on for cuDNN or cuBLAS at each UNet evaluation

    def score(x, t, **c):
        tf32_seen.append(torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
        return model(x, t, **c)

    def sample(tf32: bool, capture=None):
        """One EDM-18 sample with TF32 on for cuDNN and cuBLAS around the call
        (PyTorch's default for cuDNN): through the entry point's rule for an
        fp32 model (``compute_dtype="float32"``: TF32 off inside the call), or
        without it, for ROADMAP F7's cost; on the graph, or the eager loop."""
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        return sample_full_domain(
            score, torch.Generator(dev).manual_seed(0), sample_cond,
            domain_hw=FULL_DOMAIN, batch=1, config=config, sampler="edm_sampler",
            compute_dtype=None if tf32 else "float32", capture=capture,
        )

    _, capture_call_s = timed(lambda: sample(False))  # warm-up, capture, one replay
    tf32_inside = any(tf32_seen)  # the flags the graph was captured under
    evaluations_seen = len(tf32_seen)
    launch_counts.reset()  # the fp32 full-domain sample's run starts here: a replay
    out, wall = timed(lambda: sample(False))
    k2, k1c = k2_counts(), k1_counts()
    tf32_restored = torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    launch_counts.reset()
    eager, eager_wall = timed(lambda: sample(False, capture=False))
    k2_eager, k1_eager = k2_counts(), k1_counts()
    vs_eager = compare(out, eager, GRAPH_TOL["float32"])
    stats = graph_stats("edm_sampler 1x608x800")
    evaluations = 2 * (EDM_NODES - 1)
    finite = bool(np.isfinite(out).all())
    # F7 on the eager loop: the same sample with TF32 on and off, wall time
    # (2 each, alternating) and the device time of cuDNN's convs under the
    # profiler (one each)
    walls = {"tf32_on": [], "tf32_off": []}
    for tf32 in (True, False, False, True):
        _, wall_f7 = timed(lambda: sample(tf32, capture=False))
        walls["tf32_on" if tf32 else "tf32_off"].append(wall_f7)
    conv_ms, busy_ms = {}, {}
    for tf32 in (True, False):
        prof = profile(torch, lambda: sample(tf32, capture=False))
        key = "tf32_on" if tf32 else "tf32_off"
        conv_ms[key] = prof["kernel_ms_by_class"].get("conv (cuDNN)", 0.0)
        busy_ms[key] = prof["device_busy_ms"]
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved_flags
    emit(phase="fp32_full_width", domain="589x789->608x800", sampler=f"edm-{EDM_NODES}", cfg=3.0,
         dtype="float32", route="CUDA graph (sampling/graphs.py), then the eager loop",
         tf32_inside_sample=tf32_inside, unet_evaluations_at_capture=evaluations_seen,
         tf32_restored_after=tf32_restored,
         shape=list(out.shape), finite=finite, k2_launches_by_variant=k2, k1_launches=list(k1c),
         k1_expected=K1_PER_EVAL * evaluations, graph=stats, capture_call_s=capture_call_s,
         wall_s=wall, eager_wall_s=eager_wall, eager_k1_launches=list(k1_eager),
         eager_k2_launches_by_variant=k2_eager, graph_vs_eager=vs_eager,
         bf16_wall_s=bf16_wall_s, field_std=float(out.std()), f7_route="eager loop",
         f7_wall_s=walls, f7_cudnn_conv_device_ms=conv_ms, f7_device_busy_ms=busy_ms)
    check(out.shape == (1, *FULL_DOMAIN) and finite, f"bad fp32 full-domain output {out.shape}")
    check(evaluations_seen > 0 and not tf32_inside,
          "sample_full_domain captured an fp32 model with TF32 on (ROADMAP F7)")
    check(tf32_restored, "sample_full_domain did not restore the TF32 flags after its call")
    expected = {"tc_bf16": 0, "fp32": evaluations}
    check(k2 == expected and k2_eager == expected,
          f"fp32 sample: K2 launches by variant {k2} / eager {k2_eager}, expected {expected}")
    check_k1(k1c, evaluations, "fp32 full-domain sample (graph replay)")
    check_k1(k1_eager, evaluations, "fp32 full-domain sample (eager loop)")
    check(vs_eager["within"], f"fp32 full-domain graph vs eager: {vs_eager}")
    return {"k2": k2, "conv3x3_stats": k1c[0], "gn_apply": k1c[1],
            "eager": {"k2": k2_eager, "conv3x3_stats": k1_eager[0], "gn_apply": k1_eager[1]}}


# graph against eager on the same draws: max |diff| within this share of max
# |eager output| (a sample), or of the loss (a train step); bf16 and fp32
GRAPH_TOL = {"bfloat16": 1e-3, "float32": 1e-5}
TRAIN_128 = dict(hw=(128, 128), batch=128, steps=5)  # configs/flagship_synth.yaml:67
TRAIN_FULL = dict(hw=FULL_DOMAIN, batch=2, steps=3)  # scripts/full_domain_train_bench.py
# each parameter's gradient (``_grad_parts``), K2 step against plain-attention
# step: max |diff| / max |ref|; on an H100 bf16 rounding alone reads 6.6e-3 to
# 7.6e-3, a 10% fault in dq, dk or dv 0.09 or more (PERF.md)
GRAD_REL_TOL = 2.5e-2
# train-128, graph route against eager route on the same draws: each part's
# ||graph - eager|| / ||eager - before|| (``state_drift``); on an H100 sound
# runs read 0.030 (parameters), 0.0075 (BatchNorm statistics), 0.025 (EMA),
# a dropped or repeated optimizer or EMA write about 1 (PERF.md)
STATE_DRIFT_TOL = 0.1


class TimedBatches:
    """An iterable of batches that synchronises the card before handing out
    each one, and stamps the host clock: the gaps are whole train steps. Its
    batches are model kwargs on the card, so the trainer takes them as a
    device loader's (no prefetch thread between the stamps and the steps)."""

    is_device_loader = True

    def __init__(self, batches):
        self.batches, self.stamps = batches, []

    def __iter__(self):
        for b in self.batches:
            torch.cuda.synchronize()
            self.stamps.append(time.perf_counter())
            yield b
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())

    def step_s(self):
        return [b - a for a, b in zip(self.stamps, self.stamps[1:])]


def _snapshot(state):
    return ({k: v.detach().clone() for k, v in state.model.state_dict().items()},
            {k: v.detach().clone() for k, v in state.ema_params.items()})


def recorded_losses(pipe) -> list:
    """Wrap the pipeline's train step (and fused call) so that each step's
    loss is appended to the returned list."""
    losses = []
    step, fused = pipe._train_step, pipe._fused

    def train_step(*args, **kw):
        metrics = step(*args, **kw)
        losses.append(metrics["loss"])
        return metrics

    def fused_call(*args):
        state, traces = fused(*args)
        losses.extend(traces["loss"])
        return state, traces

    pipe._train_step = train_step
    if fused is not None:
        pipe._fused = fused_call
    return losses


def state_drift(before: dict, graph: dict, eager: dict) -> dict:
    """How far the graph route's trained state lies from the eager route's,
    against how far training moved it: per part (parameters, BatchNorm
    statistics, EMA), ||graph - eager|| / ||eager - before|| over all of the
    part's float tensors, and the tensor where that ratio is largest. A
    dropped, repeated or misdirected write of the optimizer or the EMA reads
    about 1 or more."""
    parts = {"params": (graph["after"], eager["after"], lambda k: not is_bn_stat(k)),
             "bn_stats": (graph["after"], eager["after"], is_bn_stat),
             "ema": (graph["ema"], eager["ema"], lambda k: True)}
    out = {}
    for part, (g, e, keep) in parts.items():
        keys = [k for k in e if keep(k) and e[k].is_floating_point()]
        diff = {k: (g[k].double() - e[k].double()).norm().item() for k in keys}
        moved = {k: (e[k].double() - before[k].double()).norm().item() for k in keys}
        worst = max(keys, key=lambda k: diff[k] / max(moved[k], 1e-300))
        out[part] = dict(ratio=math.hypot(*diff.values()) / math.hypot(*moved.values()),
                         tensors=len(keys), worst=worst,
                         worst_ratio=diff[worst] / max(moved[worst], 1e-300))
    return out


def is_bn_stat(key: str) -> bool:
    return key.endswith(("running_mean", "running_var"))


def losses_vs(graph: list, eager: list, tolerance: float) -> dict:
    """Per-step losses of two runs on the same draws: the largest relative
    difference, whether bit-identical, and ``tolerance`` it is held to."""
    a = torch.stack([torch.as_tensor(v).float().cpu() for v in graph])
    b = torch.stack([torch.as_tensor(v).float().cpu() for v in eager])
    rel = ((a - b).abs() / b.abs()).max().item()
    return dict(steps=len(graph), max_rel_diff=rel, bit_identical=bool(torch.equal(a, b)),
                tolerance=tolerance, within=bool(rel <= tolerance))


def phase_train_128(dev):
    """The flagship trained at 128 px, batch 128, bf16, through
    ``TrainingPipeline.train_batches``, on the step's CUDA graph and then on
    the eager step from the same seed: a first step (the capture), then 5
    timed steps with no K1 or K2 launch (training takes the plain chain, and
    256-token maps take SDPA), the loss finite, the EMA and the BatchNorm
    statistics moved, the two routes' losses and trained states on the same
    draws; then one EMA eval step on each route, which runs K1 (8 chains)."""

    from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline
    from sbgm_danra_tpu_torch.training.train_step import make_eval_step

    spec = TRAIN_128
    batches = train_batches(torch, spec["steps"] + 1, spec["batch"], spec["hw"], dev, seed=30)
    runs = {}
    for capture in (True, False):
        with tempfile.TemporaryDirectory() as tmp:
            pipe = TrainingPipeline(train_config(tmp, "bfloat16", "xla", False), [], device=dev,
                                    capture=capture)
            n_params = sum(p.numel() for p in pipe.model.parameters())
            before_params, _ = _snapshot(pipe.state)
            losses = recorded_losses(pipe)
            pipe.train_loader = OnCard(batches[:1])
            _, first_s = timed(lambda: pipe.train_batches(1))  # the graph's capture
            loader = TimedBatches(batches[1:])
            pipe.train_loader = loader
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            launch_counts.reset()  # the 128-px training path's run starts here
            loss = pipe.train_batches(spec["steps"])
            k1c, k2f, k2b = k1_counts(), k2_counts(), k2_counts("bwd")
            peak = torch.cuda.max_memory_allocated() / 1e9
            steps = loader.step_s()
            after, ema = _snapshot(pipe.state)
            ema_moved = max((ema[k] - before_params[k]).abs().max().item() for k in ema)
            bn_keys = [k for k in after if is_bn_stat(k)]
            bn_moved = max((after[k] - before_params[k]).abs().max().item() for k in bn_keys)
            eval_step = make_eval_step(pipe.model, pipe.sde, use_ema=True, capture=capture)
            gen = lambda: torch.Generator(dev).manual_seed(1)  # noqa: E731
            eval_step(pipe.state, batches[0], gen())  # the eval graph's capture
            launch_counts.reset()
            eval_loss = eval_step(pipe.state, batches[0], gen())["loss"].item()
            eval_k1 = k1_counts()
            stats = graph_stats("train step") + graph_stats("eval step")
            runs[capture] = dict(loss=loss, losses=losses, first_step_s=first_s, steps=steps,
                                 peak=peak, k1c=k1c, k2f=k2f, k2b=k2b, ema_moved=ema_moved,
                                 bn_moved=bn_moved, eval_loss=eval_loss, eval_k1=eval_k1,
                                 after=after, ema=ema, graphs=stats)
            del pipe, eval_step
            torch.cuda.empty_cache()
    graph, eager = runs[True], runs[False]
    median = float(np.median(graph["steps"]))
    eager_median = float(np.median(eager["steps"]))
    vs_eager = losses_vs(graph["losses"], eager["losses"], GRAPH_TOL["bfloat16"])
    drift = state_drift(before_params, graph, eager)
    eval_vs = abs(graph["eval_loss"] - eager["eval_loss"]) / abs(eager["eval_loss"])
    emit(phase="train_128", settings="flagship UNet (19.08M), bf16, 128x128, batch 128, Adam "
         "lr 5e-4, EMA 0.999, attention 'xla'", route="CUDA graph of the step, then eager",
         n_params=n_params, steps=spec["steps"], mean_loss=graph["loss"],
         finite=bool(np.isfinite(graph["loss"])), capture_step_s=graph["first_step_s"],
         step_s=graph["steps"], step_s_median=median, samples_per_s=spec["batch"] / median,
         peak_memory_gb=graph["peak"], k1_launches=list(graph["k1c"]),
         k2_launches_by_variant=graph["k2f"], k2_bwd_launches_by_variant=graph["k2b"],
         ema_max_change=graph["ema_moved"], bn_running_stats_max_change=graph["bn_moved"],
         ema_eval_loss=graph["eval_loss"], ema_eval_k1_launches=list(graph["eval_k1"]),
         graph=graph["graphs"], eager_step_s=eager["steps"], eager_step_s_median=eager_median,
         eager_peak_memory_gb=eager["peak"], eager_ema_eval_k1_launches=list(eager["eval_k1"]),
         graph_vs_eager_losses=vs_eager, graph_vs_eager_state=drift,
         graph_vs_eager_eval_loss_rel_diff=eval_vs)
    for name, run in (("graph", graph), ("eager", eager)):
        check(np.isfinite(run["loss"]) and np.isfinite(run["eval_loss"]),
              f"train-128 ({name}) loss {run['loss']} / {run['eval_loss']}")
        check(run["k1c"] == (0, 0) and sum(run["k2f"].values()) == 0
              and sum(run["k2b"].values()) == 0,
              f"train-128 ({name}) steps launched K1 {run['k1c']} / K2 {run['k2f']} "
              f"{run['k2b']}; training takes plain ops")
        check(run["ema_moved"] > 0 and run["bn_moved"] > 0,
              f"{name}: EMA moved {run['ema_moved']}, BN statistics {run['bn_moved']}")
        check_k1(run["eval_k1"], 1, f"EMA eval step at 128 px ({name})")
    check(vs_eager["within"] and eval_vs <= GRAPH_TOL["bfloat16"],
          f"train-128 graph vs eager: {vs_eager}, eval loss {eval_vs}")
    check(all(d["ratio"] <= STATE_DRIFT_TOL for d in drift.values()),
          f"train-128 graph vs eager state: {drift}, above {STATE_DRIFT_TOL}")
    return {"step_s_median": median, "eval_k1": graph["eval_k1"]}


DATA_STEPS = 20  # timed flagship steps per loader
HOST_LOADER_STEPS = 6  # the host loader's (~3.4 s a step, host-bound: a depth cut)
FUSED_K = 25  # configs/flagship_synth.yaml: training.fused_steps
FUSED_TOL = 1e-6  # fused vs one-step graph, cuDNN deterministic: per-step loss, relative
SAMPLE_KEYS = ("x", "cond_img", "lsm_cond", "topo_cond", "y", "lsm_hr")


def fused_vs_one_step(dev, tmp, train) -> dict:
    """``training.fused_steps`` = 25 (``training/fused.py``: its one-step
    graph, card sampler inside, replayed 25 times) against the one-step
    train-step graph on the same draws, through the pipeline on the device
    loader: two epochs of 25 steps each, cuDNN deterministic so that
    both routes take the same algorithms; the per-step losses, the seconds per
    step of the second epoch (the first holds the captures), each route's
    graphs (capture and instantiate seconds, pool bytes)."""
    from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for k in (FUSED_K, 0):
            pipe = TrainingPipeline(data_config(tmp, fused_steps=k, steps_per_epoch=FUSED_K),
                                    train, device=dev)
            losses = recorded_losses(pipe)
            walls = []
            for epoch in range(2):
                train.set_epoch(epoch)
                walls.append(timed(lambda: pipe.train_batches(FUSED_K))[1])
            runs[k] = dict(losses=losses, walls=walls,
                           graphs=graph_stats("fused" if k else "train step"))
            del pipe
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = saved
    fused, one = runs[FUSED_K], runs[0]
    return dict(k=FUSED_K, epochs_of_k_steps=2,
                losses_vs_one_step=losses_vs(fused["losses"], one["losses"], FUSED_TOL),
                finite=bool(all(np.isfinite(float(v)) for v in fused["losses"])),
                step_s=fused["walls"][1] / FUSED_K, one_step_graph_step_s=one["walls"][1] / FUSED_K,
                first_epoch_s=fused["walls"][0], one_step_graph_first_epoch_s=one["walls"][0],
                graphs=fused["graphs"], one_step_graphs=one["graphs"])


def phase_train_data(dev, tmp):
    """The flagship's data path on the card: synthetic stores at 589x789
    (32 days, no 'all' split: a depth cut), the card-resident train and valid
    stacks, the card sampler at batch 128 against the same sampler on the CPU
    with the same draws (every key equal, the SDF within 1e-6), its SDF against
    the host EDT on all 128 masks (1e-4; a mask without land is 0 on the card),
    the sampler's device time and launches, 20 flagship steps each on the
    device loader and random batches and ``HOST_LOADER_STEPS`` on the host
    loader (``num_workers`` 1, as configured) in one pipeline, ``train_main`` for one epoch of 10 steps
    with its checkpoint read back, and one EDM-18 full-domain sample
    conditioned on the first test day (``make_dataset(cfg, "test",
    full_domain=True)``) with the trained EMA weights, back-transformed to mm:
    272 K1 and 34 K2 launches. The data and the checkpoint stay under ``tmp``
    for the generate phase."""
    from sbgm_danra_tpu_torch.cli.entries import train_main
    from sbgm_danra_tpu_torch.cli.main_app import synthetic_data
    from sbgm_danra_tpu_torch.data.device_data import make_sample_fn
    from sbgm_danra_tpu_torch.data.factory import make_dataset, make_loaders
    from sbgm_danra_tpu_torch.data.loader import DataLoader, collate, extract_batch
    from sbgm_danra_tpu_torch.evaluate.full_domain import padded_dims, sample_full_domain
    from sbgm_danra_tpu_torch.models.unet import (build_score_model, inference_spec,
                                                  model_spec_from_config)
    from sbgm_danra_tpu_torch.ops.sdf import sdf_from_mask
    from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig
    from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline
    from sbgm_danra_tpu_torch.transforms import back_transforms_for_config

    cfg = data_config(tmp)
    t0 = time.perf_counter()
    synthetic_data(cfg, DATA_DAYS, no_all_split=True)
    gen_s = time.perf_counter() - t0
    train, valid, _ = make_loaders(cfg, device=dev)
    stacks = train.stacks
    resident_gib = (stacks.nbytes() + valid.stacks.nbytes()) / 2**30

    g = torch.Generator(dev).manual_seed(21)
    draws = train.draws(g)
    card = train.sample_from(*draws)
    ref = make_sample_fn(train.crop_hw)(*(d.cpu() for d in draws), stacks.fields.cpu(),
                                        stacks.statics.cpu(), stacks.classifier.cpu())
    unequal = [k for k in SAMPLE_KEYS if not torch.equal(card[k].cpu(), ref[k])]
    sdf_vs_cpu = (card["sdf"].cpu() - ref["sdf"]).abs().max().item()
    masks = card["lsm_hr"][..., 0].cpu().numpy()
    sdf = card["sdf"][..., 0].cpu().numpy()
    no_land = [i for i, m in enumerate(masks) if not m.any()]
    sdf_vs_edt = max(float(np.abs(sdf[i] - sdf_from_mask(masks[i])).max())
                     for i in range(len(masks)) if i not in no_land)
    no_land_zero = all(not sdf[i].any() for i in no_land)
    sampler = sampler_profile(torch, train, g)

    # the one-step graph (fused_steps 0) on each loader, timed step by step
    pipe = TrainingPipeline(data_config(tmp, fused_steps=0), train, valid, device=dev)
    host = DataLoader(RepeatedDays(make_dataset(cfg, "train"), 128), batch_size=128,
                      shuffle=True, num_workers=cfg.data_handling.num_workers, seed=0)
    random = OnCard(train_batches(torch, DATA_STEPS, 128, (128, 128), dev, seed=40))
    steps = {}
    for name, loader in (("device_loader", train), ("host_loader_1_worker", host),
                         ("random_batches", random)):
        step_seconds(torch, pipe, loader, 2)  # warm-up (the first step captures)
        steps[name] = step_seconds(torch, pipe, loader,
                                   HOST_LOADER_STEPS if loader is host else DATA_STEPS)
    losses_finite = all(np.isfinite(r["mean_loss"]) for r in steps.values())
    del pipe, random
    torch.cuda.empty_cache()

    fused = fused_vs_one_step(dev, tmp, train)
    torch.cuda.empty_cache()

    # configs/flagship_synth.yaml's training section: 25 steps per dispatch
    epoch_cfg = data_config(tmp, epochs=1, steps_per_epoch=FUSED_K)
    t0 = time.perf_counter()
    trained = train_main(epoch_cfg, device=dev)
    train_main_s = time.perf_counter() - t0
    train_main_graph = graph_stats("fused")
    # a pipeline that only reads the checkpoint trains nothing: no fused
    # steps to check against its (empty) loader
    reread = TrainingPipeline(data_config(tmp, epochs=1, steps_per_epoch=FUSED_K,
                                          fused_steps=0), [], device=dev)
    reread.load()
    read_back = (reread.state.step == trained.state.step == FUSED_K and reread.epoch == 1
                 and all(torch.equal(a, b) for a, b in zip(
                     reread.model.state_dict().values(),
                     trained.model.state_dict().values()))
                 and all(torch.equal(reread.state.ema_params[k], v)
                         for k, v in trained.state.ema_params.items()))
    history = trained.history

    day = make_dataset(cfg, "test", full_domain=True)
    b = extract_batch(collate([day[0]]), cfg.highres.variable)
    cond = {k: torch.as_tensor(b[k]).to(dev) for k in ("y", "cond_img", "lsm_cond",
                                                     "topo_cond")}
    spec = inference_spec(model_spec_from_config(cfg), padded_dims(*FULL_DOMAIN))
    model = build_score_model(spec).to(dev)
    weights = trained.model.state_dict()
    weights.update(trained.state.ema_params)
    model.load_state_dict(weights)
    del trained, reread
    config = SamplerConfig(num_steps=EDM_NODES, guidance_scale=3.0, s_churn=0.0)

    def sample():
        return sample_full_domain(model, torch.Generator(dev).manual_seed(3), cond,
                                  domain_hw=FULL_DOMAIN, batch=1, config=config,
                                  sampler="edm_sampler")

    with torch.inference_mode():
        _, capture_call_s = timed(sample)  # warm-up, capture, one replay
        launch_counts.reset()  # the conditioned full-domain sample's run starts here: a replay
        out, sample_s = timed(sample)
        k1c, k2c = k1_counts(), k2_counts()
    mm = np.asarray(back_transforms_for_config(cfg)["generated"](out))
    test_date = day.date_of(0)
    evaluations = 2 * (EDM_NODES - 1)
    median = {k: float(np.median(v["step_s"])) for k, v in steps.items()}
    emit(phase="train_data", settings="configs/flagship_synth.yaml (prcp log_zscore HR at "
         "128x128 inside [170, 350, 340, 520] of 589x789, LR temp and prcp, lsm, topo, SDF "
         "loss, CFG 0.1, 4 seasons, bf16 UNet, batch 128), 32 synthetic days (train 22, "
         "valid 4, test 6)", days=DATA_DAYS, generate_s=gen_s, resident_gib=resident_gib,
         train_load_s=stacks.load_s, train_upload_s=stacks.upload_s,
         sampler_vs_cpu_unequal_keys=unequal, sdf_vs_cpu_max_abs=sdf_vs_cpu,
         sdf_vs_cpu_tolerance=1e-6, sdf_vs_edt_max_abs=sdf_vs_edt, sdf_vs_edt_tolerance=1e-4,
         masks_without_land=len(no_land), **sampler, steps=steps, step_s_median=median,
         device_vs_random_step=median["device_loader"] / median["random_batches"],
         train_losses_finite=losses_finite, train_main_s=train_main_s,
         train_main_history=history, checkpoint_read_back=read_back,
         full_domain_test_date=test_date, full_domain_shape=list(out.shape),
         full_domain_finite=bool(np.isfinite(out).all() and np.isfinite(mm).all()),
         full_domain_mm_mean=float(mm.mean()), full_domain_mm_max=float(mm.max()),
         full_domain_capture_call_s=capture_call_s, full_domain_wall_s=sample_s,
         k1_launches=list(k1c), k2_launches_by_variant=k2c, fused=fused,
         train_main_fused_steps=FUSED_K, train_main_graph=train_main_graph)
    check(not unequal and sdf_vs_cpu <= 1e-6,
          f"card sampler differs from the CPU's: {unequal}, SDF {sdf_vs_cpu}")
    check(sdf_vs_edt <= 1e-4 and no_land_zero, f"card SDF vs host EDT {sdf_vs_edt}")
    check(losses_finite and all(np.isfinite(history["train_loss"] + history["val_loss"])),
          f"train losses {history}")
    check(read_back, "train_main's checkpoint did not read back to the same state")
    check(fused["losses_vs_one_step"]["within"] and fused["finite"],
          f"fused steps against the one-step graph: {fused['losses_vs_one_step']}")
    check(out.shape == (1, *FULL_DOMAIN) and np.isfinite(out).all() and np.isfinite(mm).all(),
          f"bad conditioned full-domain sample {out.shape}")
    check(k2c == {"tc_bf16": evaluations, "fp32": 0},
          f"conditioned full-domain sample: K2 launches {k2c}")
    check_k1(k1c, evaluations, "conditioned full-domain sample")
    return {"k2": k2c, "conv3x3_stats": k1c[0], "gn_apply": k1c[1]}


GEN_STEPS = 25  # configs/flagship_synth.yaml: evaluation.n_steps (dpmpp-25)
GEN_ARTIFACTS = {"multiple": ("multi_n_4", 4), "single": ("single", 1),
             "repeated": ("repeated_8", 8)}  # evaluation.n_gen_samples 4, n_repeats 8
STUDY_GRID = ("edm_18", "dpmpp_25", "pc_100")
STUDY_BAND = (0.9, 1.1)  # std ratio and spread/skill of the exact-score study


def _artifact_checks(sample_path: str, suffix: str, n: int, hw) -> dict:
    """The mode's npz files: names, shapes, finite values, prcp >= 0 after the
    back-transform; the members' distinct fields."""
    shapes = {"gen_samples": (n, *hw), "eval_samples": (n, *hw), "lsm_samples": (n, *hw, 2),
              "seasons": (n,), "cond_samples_prcp": (n, *hw), "cond_samples_temp": (n, *hw)}
    arrays = {k: np.load(os.path.join(sample_path, f"{k}_{suffix}.npz"))["arr_0"]
              for k in shapes}
    gen = arrays["gen_samples"]
    return dict(
        shapes_ok=all(arrays[k].shape == shape for k, shape in shapes.items()),
        finite=all(bool(np.isfinite(a).all()) for a in arrays.values()),
        prcp_min_mm=float(gen.min()), prcp_mean_mm=float(gen.mean()),
        prcp_max_mm=float(gen.max()), distinct_fields=len({g.tobytes() for g in gen}))


def _mode_graph(prefix: str) -> dict:
    stats = graph_stats(prefix)
    check(len(stats) == 1, f"graphs named {prefix!r}: {stats}")
    return stats[0]


def _sampler_alone_s(generator, mode: str, n: int, dev) -> float:
    """Wall seconds of a mode's sampler call alone, made through the public
    sampling API with the generator's score function, noise generator and
    settings on its loader's batch: a replay of the graph the mode captured."""
    from sbgm_danra_tpu_torch.data.loader import extract_batch
    from sbgm_danra_tpu_torch.evaluate.full_domain import sample_full_domain
    from sbgm_danra_tpu_torch.evaluate.generation import condition_tensors
    from sbgm_danra_tpu_torch.parallel.ensemble import generate_ensemble
    from sbgm_danra_tpu_torch.sampling import graphs

    g = generator
    batch = extract_batch(next(iter(g.dataloader)), g.cfg.highres.variable)
    rows = n if mode in ("multiple", "full_domain") else 1
    cond = condition_tensors({k: v[:rows] if getattr(v, "ndim", 0) else v
                              for k, v in batch.items()}, dev)
    hw = tuple(batch["x"].shape[1:3])
    common = dict(sde=g.sde, config=g.sampler_config)
    if mode == "repeated":
        def call():
            return generate_ensemble(g.score_fn, g.rng, n_members=n, sample_shape=(*hw, 1),
                                     cond=cond, sampler=g.sampler_name, capture=True, **common)
    elif mode == "full_domain":
        def call():
            return sample_full_domain(g.score_fn, g.rng, cond, domain_hw=hw, batch=n,
                                      sampler=g.sampler_name, capture=True,
                                      compute_dtype=g.cfg.model.compute_dtype, **common)
    else:
        def call():
            return graphs.call(g.sampler_name, g.score_fn, g.rng, (rows, *hw, 1), cond=cond,
                               graph=True, **common)
    with torch.no_grad():
        return timed(call)[1]


def phase_generate(dev, tmp):
    """Generation and evaluation through the port's CLI on the checkpoint that
    ``train_data``'s ``train_main`` wrote (the flagship settings, 32 days), as
    ``main_app.run_mode`` calls (no YAML):

    1. ``--mode generate`` with ``gen_type: [multiple, single, repeated]``
       (dpmpp-25, CFG w=3, 4 conditions, 8 members): the first call loads the
       checkpoint and captures each mode's graph (two eager warm-ups, the
       capture, one replay: 3 x 8 K1 launches a UNet evaluation); then each
       mode again, a replay of the same graph (no new capture), counted alone:
       8 K1 launches an evaluation, no K2; the npz names and shapes, finite,
       prcp >= 0, 8 distinct members; the sampler's call alone through the
       public API, a third replay; then each mode on the eager loop, for
       its wall time; the trained UNet at the modes' batches (2 and 8 rows)
       with K1 against the plain chain (5e-2 relative);
    2. ``--mode generate`` with ``gen_type: [full_domain]``, EDM-18
       (``configs/full_scale_demo.yaml``): 589x789 -> 608x800 through
       ``score_fn(image_hw=...)``; its replay alone: 272 K1 and exactly 34 K2
       launches, all ``tc_bf16``; then the eager loop, for its wall time;
    3. ``--mode evaluate`` with pixel and spatial statistics, CRPS and the
       power spectra on the four modes' artifacts: files written, values finite;
    4. ``quality_study.run_study`` at JAX's default sizes (64 members, 16x16,
       256 truths) on the headline regimes with edm-18, dpmpp-25 and pc-100,
       each on its graph: std ratio and spread/skill in ``STUDY_BAND``, no K1 or K2;
    5. ``generate_previews`` on its graph (``capture=True``) after captured
       train steps on the device loader, then again after more (the train
       replays made the K1 packs of the first preview stale; its graph went
       with its call), against the eager loop, the previews' default route,
       on fresh packs and the same draws (``GRAPH_TOL``).
    Each mode's wall time (load; the first call: warm-ups, capture and a
    replay; capture and instantiate; a replay; the eager loop), the graphs'
    pools and launches are printed."""
    import argparse
    import gc

    from sbgm_danra_tpu_torch.cli.main_app import run_mode
    from sbgm_danra_tpu_torch.data.factory import make_gen_loader, make_loaders
    from sbgm_danra_tpu_torch.evaluate import quality_study as qs
    from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1
    from sbgm_danra_tpu_torch.sampling import graphs
    from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline
    from sbgm_danra_tpu_torch.transforms import back_transforms_for_config

    args = argparse.Namespace(device=str(dev))
    evaluations = GEN_STEPS - 1  # dpmpp: one UNet evaluation (2n rows with CFG) a step, less one
    result = {"modes": {}}
    graphs.clear()

    # 1. the 128-px modes through the CLI
    cfg = data_config(tmp)
    cfg.evaluation.gen_type = tuple(GEN_ARTIFACTS)
    before = torch.cuda.memory_allocated(dev)
    launch_counts.reset()  # the generate call's run starts here
    run, call_s = timed(lambda: run_mode(cfg, "generate", args))
    first_k1, first_k2 = k1_counts(), k2_counts()
    load_gib = (torch.cuda.memory_allocated(dev) - before) / 2**30
    generator = run["generators"]["multiple"]
    sample_path = generator.sample_path
    for mode, (suffix, n) in GEN_ARTIFACTS.items():
        graph_name = f"dpmpp_sampler {n}x128x128"
        captured = _mode_graph(graph_name)
        call = getattr(generator, f"generate_{mode}")
        launch_counts.reset()  # the mode alone: a replay of its graph
        _, replay_s = timed(call)
        k1c, k2c = k1_counts(), k2_counts()
        again = _mode_graph(graph_name)
        checks = _artifact_checks(sample_path, suffix, n, (128, 128))
        sampler_s = _sampler_alone_s(generator, mode, n, dev)
        alone = _mode_graph(graph_name)
        generator.capture = False  # the same call on the eager loop, for its wall time
        _, eager_s = timed(call)
        generator.capture = True
        result["modes"][mode] = dict(
            suffix=suffix, first_call_s=run["mode_s"][mode], replay_s=replay_s,
            replay_sampler_alone_s=sampler_s, eager_s=eager_s,
            capture_s=captured["capture_s"], instantiate_s=captured["instantiate_s"],
            pool_bytes=captured["pool_bytes"],
            launches_per_replay=captured["launches_per_replay"], k1_launches=list(k1c),
            k2_launches_by_variant=k2c, replays=again["replays"], **checks)
        check(checks["shapes_ok"] and checks["finite"] and checks["prcp_min_mm"] >= 0.0,
              f"generate {mode}: artifacts {checks}")
        check(again["capture_s"] == captured["capture_s"] and again["replays"] == 2
              and alone["replays"] == 3,
              f"generate {mode}: the later calls did not replay the first call's graph")
        check_k1(k1c, evaluations, f"generate {mode} (replay)")
        check(not any(k2c.values()), f"generate {mode}: K2 launched {k2c}")
    check(result["modes"]["repeated"]["distinct_fields"] == 8, "repeated members not distinct")
    check_k1(first_k1, 3 * evaluations * len(GEN_ARTIFACTS),
             "generate call (warm-ups and replays)")
    check(not any(first_k2.values()), f"generate call: K2 launched {first_k2}")

    # the trained model at the modes' UNet batches (1 and 4 rows, doubled by
    # CFG): K1 against the plain chain, as phase_model holds batch 16
    model = run["pipeline"].model
    result["k1_vs_plain_chain"] = {}
    with torch.no_grad():
        for rows in (2, 8):
            cond = make_cond(rows, SERVE_HW, dev, 30 + rows)
            x = 2.0 * torch.randn(rows, *SERVE_HW, 1,
                                  generator=torch.Generator(dev).manual_seed(rows), device=dev)
            t = torch.linspace(0.05, 1.0, rows, device=dev)
            launch_counts.reset()
            got = model(x, t, **cond)
            counts = k1_counts()
            restore = plain_k1()
            try:
                ref = model(x, t, **cond)
            finally:
                restore()
            rel, finite = _rel(got, ref), bool(torch.isfinite(got).all())
            result["k1_vs_plain_chain"][f"batch_{rows}"] = dict(
                rel_err=rel, tolerance=5e-2, finite=finite, k1_launches=list(counts))
            check(rel <= 5e-2 and finite, f"trained UNet at batch {rows}, K1 vs plain chain: "
                                          f"rel err {rel}")
            check_k1(counts, 1, f"trained UNet forward at batch {rows}")
    result.update(load_s=run["load_s"], load_allocated_gib=load_gib, call_s=call_s,
                  k1_launches=list(first_k1), k2_launches_by_variant=first_k2)
    del run, generator, model
    gc.collect()
    graphs.clear()
    torch.cuda.empty_cache()

    # 2. full domain through the CLI
    fd_cfg = data_config(tmp)
    fd_cfg.sampler.sampler_type = "edm_sampler"
    fd_cfg.evaluation.n_steps = EDM_NODES
    fd_cfg.evaluation.gen_type = ("full_domain",)
    fd_evaluations = 2 * (EDM_NODES - 1)
    launch_counts.reset()
    run, fd_call_s = timed(lambda: run_mode(fd_cfg, "generate", args))
    fd_first = (k1_counts(), k2_counts())
    fd = run["generators"]["full_domain"]
    graph_name = "edm_sampler 1x608x800"
    captured = _mode_graph(graph_name)
    launch_counts.reset()  # the full-domain mode alone: a replay of its graph
    _, fd_replay_s = timed(fd.generate_full_domain)
    k1c, k2c = k1_counts(), k2_counts()
    checks = _artifact_checks(sample_path, "full_domain", 1, FULL_DOMAIN)
    fd_sampler_s = _sampler_alone_s(fd, "full_domain", 1, dev)
    fd_replays = _mode_graph(graph_name)["replays"]
    fd.capture = False  # the same call on the eager loop, for its wall time
    _, fd_eager_s = timed(fd.generate_full_domain)
    fd.capture = True
    result["modes"]["full_domain"] = dict(
        suffix="full_domain", load_s=run["load_s"], call_s=fd_call_s,
        first_call_s=run["mode_s"]["full_domain"], replay_s=fd_replay_s,
        replay_sampler_alone_s=fd_sampler_s, eager_s=fd_eager_s, replays=fd_replays,
        capture_s=captured["capture_s"], instantiate_s=captured["instantiate_s"],
        pool_bytes=captured["pool_bytes"], launches_per_replay=captured["launches_per_replay"],
        k1_launches=list(k1c), k2_launches_by_variant=k2c,
        first_call_k1_launches=list(fd_first[0]), first_call_k2_launches_by_variant=fd_first[1],
        **checks)
    check(checks["shapes_ok"] and checks["finite"] and checks["prcp_min_mm"] >= 0.0,
          f"generate full_domain: artifacts {checks}")
    check(fd_replays == 3, f"generate full_domain: {fd_replays} replays of its graph, not 3")
    check_k1(k1c, fd_evaluations, "generate full_domain (replay)")
    check(k2c == {"tc_bf16": fd_evaluations, "fp32": 0},
          f"generate full_domain: K2 launches {k2c}, expected {fd_evaluations} tc_bf16")
    check(fd_first[1] == {"tc_bf16": 3 * fd_evaluations, "fp32": 0},
          f"generate full_domain call: K2 launches {fd_first[1]}")
    del run, fd
    gc.collect()
    graphs.clear()
    torch.cuda.empty_cache()

    # 3. evaluation of the four modes' artifacts through the CLI
    ev_cfg = data_config(tmp)
    ev_cfg.evaluation.gen_type = (*GEN_ARTIFACTS, "full_domain")
    ev_cfg.evaluation.eval_stat_methods = ("pixel_stats", "spatial_stats", "crps",
                                           "power_spectrum")
    stats, ev_s = timed(lambda: run_mode(ev_cfg, "evaluate", args))
    fig_path = os.path.join(os.path.dirname(sample_path), "evaluation_figures")
    written = sorted(os.listdir(fig_path))
    finite = {gen_type: all(bool(np.isfinite(np.asarray(v, dtype=np.float64)).all())
                            for method in out.values() for key, v in method.items()
                            if key != "wavelengths")  # infinite at the DC bin by definition
              for gen_type, out in stats.items()}
    result["evaluate"] = dict(
        s=ev_s, files=written, finite=finite, crps=stats["repeated"]["crps"],
        rmse_per_sample={k: [float(x) for x in v["pixel_stats"]["rmse_per_sample"]]
                         for k, v in stats.items()},
        spectrum_log_mse={k: v["power_spectrum"]["log_mse"] for k, v in stats.items()})
    check(all(finite.values()), f"evaluate: non-finite statistics {finite}")
    check(all(f"{m}_{t}.npz" in written for m in ("pixel_stats", "spatial_stats")
              for t in ev_cfg.evaluation.gen_type), f"evaluate: files {written}")

    # 4. the exact-score quality study on the card
    grid = [s for s in qs.SAMPLER_GRID if s["label"] in STUDY_GRID]
    launch_counts.reset()
    study, study_s = timed(lambda: qs.run_study(sampler_grid=grid,
                                                regimes=qs.default_regimes(stress=False),
                                                device=dev))
    study_k1, study_k2 = k1_counts(), k2_counts()
    result["quality_study"] = dict(s=study_s, results=study, k1_launches=list(study_k1),
                                   k2_launches_by_variant=study_k2)
    for regime, rows in study.items():
        for label, m in rows.items():
            check(STUDY_BAND[0] <= m["std_ratio"] <= STUDY_BAND[1]
                  and STUDY_BAND[0] <= m["spread_skill"] <= STUDY_BAND[1],
                  f"quality study {regime}/{label}: {m}")
    check(set(study) == {"unimodal", "bimodal", "correlated"}, f"study regimes {set(study)}")
    check(study_k1 == (0, 0) and not any(study_k2.values()), "the study launched K1 or K2")
    graphs.clear()

    # 5. previews after captured train steps
    pv_cfg = data_config(tmp, fused_steps=0)
    train, _, _ = make_loaders(pv_cfg, device=dev)
    pipe = TrainingPipeline(pv_cfg, train, device=dev,
                            back_transforms=back_transforms_for_config(pv_cfg),
                            gen_loader=make_gen_loader(pv_cfg))
    pipe.load()

    def preview(capture=False):
        return timed(lambda: pipe.generate_previews(rng=torch.Generator(dev).manual_seed(4),
                                                    capture=capture))

    pipe.train_batches(3)  # the first step captures
    k1.clear_packs()
    p1, p1_s = preview(capture=True)
    stale_before = k1.stale_packs()  # the packs the first preview made, still current
    pipe.train_batches(3)
    stale_after = k1.stale_packs()  # written by the train replays (Graph.writes)
    launch_counts.reset()  # the second preview's run on its graph: captured, then replayed
    p2, p2_s = preview(capture=True)
    pv_k1 = k1_counts()
    held = graph_stats(f"dpmpp_sampler {GEN_ARTIFACTS['multiple'][1]}x128x128")
    k1.clear_packs()  # the reference packs the weights afresh
    eager, eager_s = preview()  # the previews' default route
    vs_eager = compare(p2, eager, GRAPH_TOL["bfloat16"])
    result["previews"] = dict(
        shape=list(p2.shape), finite=bool(np.isfinite(p2).all()), first_graph_s=p1_s,
        graph_s=p2_s, eager_s=eager_s, stale_packs_before_train=stale_before,
        stale_packs_after_train=stale_after, k1_launches=list(pv_k1),
        moved=not np.array_equal(p1, p2), graph_vs_eager=vs_eager,
        graphs_held_after_the_call=held)
    check(stale_before == 0 and stale_after > 0,
          f"previews: K1 packs stale {stale_before} before / {stale_after} after the train "
          "replays")
    check(not held, f"previews: the preview's graph outlived its call: {held}")
    check_k1(pv_k1, 3 * evaluations, "second preview (warm-ups and a replay)")
    check(result["previews"]["finite"] and result["previews"]["moved"],
          f"previews: {result['previews']}")
    check(vs_eager["within"], f"preview graph vs eager: {vs_eager}")
    del pipe, train
    gc.collect()
    graphs.clear()
    emit(phase="generate", settings="configs/flagship_synth.yaml's evaluation (dpmpp-25, "
         "CFG w=3, 4 conditions, 8 members) and configs/full_scale_demo.yaml's full domain "
         "(EDM-18), on train_data's checkpoint (EMA weights)", **result)
    return {"k2": result["modes"]["full_domain"]["k2_launches_by_variant"],
            **{f"{mode}/{name}": result["modes"][mode]["k1_launches"][i]
               for mode in result["modes"] for i, name in enumerate(("conv3x3_stats",
                                                                    "gn_apply"))},
            **{f"previews/{name}": pv_k1[i] for i, name in enumerate(("conv3x3_stats",
                                                                    "gn_apply"))}}


QUALITY_FLAGSHIP_ARGS = ["--n_dates", "2", "--members", "4", "--dpmpp", "--calibrate",
                         "--pc_chunk_dates", "2"]
QUALITY_FULL_ARGS = ["--n_dates", "1", "--members", "2", "--member_chunk", "2"]
QUALITY_STUDY_ARGS = ["--members", "8", "--truths", "16"]
QUALITY_TRAIN_STEPS = 2  # the traced epoch (its first step captures the train step)
QUALITY_TIMED_STEPS = 5  # steps timed with and without the trace, on the captured graph
K2_LAYERS_AT_FULL_DOMAIN = 1  # attention layers at >= 4096 tokens at 608x800: decoder block 1
QUALITY_FLAGSHIP_RUNS = ("edm_w3", "edm_w0", "edm_w7", "dpmpp25_w3", "dpmpp25_w0",
                         "dpmpp35_w3", "calibration/valid_edm_w3",
                         "calibration/valid_dpmpp25_w3", "pc1000_w3")
# the JSON keys tests/test_torch_quality_scripts.py holds against the JAX scripts'
QUALITY_FLAGSHIP_KEYS = {"n_dates", "members", "image_hw", "edm_w3", "edm_w0", "edm_w7",
                         "dpmpp25_w3", "dpmpp25_w0", "dpmpp35_w3", "calibration",
                         "edm_w3_cal_crps", "edm_w3_cal_spread_skill", "dpmpp25_w3_cal_crps",
                         "pc1000_w3"}
QUALITY_FULL_KEYS = {"n_dates", "members", "domain", "padded", "sampler", "w0", "w3"}


def _finite_tree(tree) -> bool:
    """Every number in a JSON-like tree is finite (None counts as not)."""
    if isinstance(tree, dict):
        return all(_finite_tree(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_finite_tree(v) for v in tree)
    if isinstance(tree, str):
        return True
    return tree is not None and bool(np.isfinite(tree))


def _traced_training(dev, tmp):
    """A 2-step epoch of the flagship trainer (``data_config``, the device
    loader, batch 128, the one-step graph) with ``training.profile_dir`` set:
    epoch 0 runs under ``utils/profiling.trace``, its first step capturing
    the train step inside the profiler; the Chrome trace must exist and name
    the graph's launch and card kernels, and the throughput line must be
    logged. Then ``QUALITY_TIMED_STEPS`` replays timed without the trace and
    under the profiler (epoch 1, inside ``utils/profiling.trace``), and the
    trace's export apart."""
    import glob
    import logging

    from sbgm_danra_tpu_torch.data.factory import make_loaders
    from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline
    from sbgm_danra_tpu_torch.utils.profiling import trace

    trace_dir = os.path.join(tmp, "profile")
    cfg = data_config(tmp, fused_steps=0, profile_dir=trace_dir)
    train, _, _ = make_loaders(cfg, device=dev)
    pipe = TrainingPipeline(cfg, train, device=dev)
    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Lines(level=logging.INFO)
    log = logging.getLogger("sbgm_danra_tpu_torch.training.pipeline")
    level = log.level
    log.setLevel(logging.INFO)
    log.addHandler(handler)
    try:
        _, traced_epoch_s = timed(lambda: pipe.train_batches(QUALITY_TRAIN_STEPS))
        files = sorted(glob.glob(os.path.join(trace_dir, "*.json")))
        first_throughput = [m for m in lines if m.startswith("epoch 0 throughput: ")]
        pipe.epoch = 1  # not traced by the trainer
        _, plain_s = timed(lambda: pipe.train_batches(QUALITY_TIMED_STEPS))
        tracing = trace(os.path.join(tmp, "profile_timed"), dev)
        tracing.__enter__()
        _, traced_s = timed(lambda: pipe.train_batches(QUALITY_TIMED_STEPS))
        _, export_s = timed(lambda: tracing.__exit__(None, None, None))
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    throughput = [m for m in lines if " throughput: " in m]
    names, kernels, graph_launches = set(), 0, 0
    if files:
        with open(files[0]) as f:
            events = json.load(f).get("traceEvents", [])
        for e in events:
            names.add(e.get("name", ""))
            kernels += e.get("cat") == "kernel"
            graph_launches += e.get("name") == "cudaGraphLaunch"
    trace_bytes = os.path.getsize(files[0]) if files else 0
    del pipe, train
    return dict(trace_files=[os.path.basename(f) for f in files], trace_bytes=trace_bytes,
                trace_kernel_events=kernels, trace_graph_launches=graph_launches,
                throughput_lines=throughput, first_epoch_throughput=first_throughput,
                traced_epoch_s=traced_epoch_s,
                step_s_without_trace=plain_s / QUALITY_TIMED_STEPS,
                step_s_with_trace=traced_s / QUALITY_TIMED_STEPS, trace_export_s=export_s)


def _convert_round_trip(tmp):
    """``convert.flax_from_state_dicts`` on train_data's best checkpoint (its
    EMA copy included), then back through ``state_dicts_from_flax``: every
    tensor bit-identical."""
    from sbgm_danra_tpu_torch.config import get_model_string
    from sbgm_danra_tpu_torch.convert import flatten, flax_from_state_dicts, state_dicts_from_flax
    from sbgm_danra_tpu_torch.models.unet import build_score_model, model_spec_from_config
    from sbgm_danra_tpu_torch.training.checkpointing import CheckpointManager, model_state_dict

    cfg = data_config(tmp)
    step, tree = CheckpointManager(os.path.join(cfg.paths.checkpoint_dir,
                                                get_model_string(cfg))).load_tree(best=True)
    model = build_score_model(model_spec_from_config(cfg))
    model.load_state_dict(model_state_dict(tree))
    flax = flax_from_state_dicts(model, tree["ema_params"])
    params, ema = state_dicts_from_flax(flax, model)
    want = model.state_dict()
    unequal = [k for k in want if not torch.equal(params[k], want[k])]
    unequal += [f"ema:{k}" for k in tree["ema_params"]
                if not torch.equal(ema[k], tree["ema_params"][k])]
    return dict(step=step, arrays=len(flatten(flax)), tensors=len(want),
                ema_tensors=len(tree["ema_params"]), unequal=unequal)


def phase_quality(dev, tmp):
    """The port's quality scripts on ``train_data``'s flagship checkpoint (full
    width, 19.08M parameters, its EMA weights), each through its ``main(argv,
    cfg)`` in this process on the card, then the trainer's profiler trace and
    the weight bridge's torch -> Flax direction:

    1. ``flagship_quality_eval`` with ``QUALITY_FLAGSHIP_ARGS`` (2 test dates x
       4 members, EDM-25 w in {3, 0, 7}, dpmpp 25 / 35, the valid-split
       calibration and PC-1000, on its eager route): every JSON key, every
       metric finite; each run's K1 launches = 8 x the UNet evaluations it
       ran (warm-ups and replays on a graph, the eager calls of PC-1000);
       the trained UNet at the runs' batches (16 rows with CFG, 8 without)
       with K1 against the plain chain (PC-1000's graph, the route not
       taken, is measured by ``profile_port.py --paths pc1000_capture``);
    2. ``full_domain_quality_eval`` with ``QUALITY_FULL_ARGS`` (1 test date,
       2 members, 589x789 -> 608x800, EDM-25 w in {0, 3}): K1 as above, K2
       ``tc_bf16`` launches = UNet evaluations x ``K2_LAYERS_AT_FULL_DOMAIN``,
       finite in-crop and out-of-crop CRPS; the UNet at 608x800 (4 rows) with
       K1 against the plain chain;
    3. ``edm_quality_study`` with ``QUALITY_STUDY_ARGS`` (the whole sampler
       grid on the five regimes, 16x16): std ratio and spread/skill finite;
    4. ``_traced_training``; 5. ``_convert_round_trip``."""
    import gc

    from sbgm_danra_tpu_torch.cli.entries import _load_pipeline_for_sampling
    from sbgm_danra_tpu_torch.sampling import graphs
    from sbgm_danra_tpu_torch.scripts import edm_quality_study, flagship_quality_eval
    from sbgm_danra_tpu_torch.scripts import full_domain_quality_eval

    graphs.clear()
    result = {}
    cfg = data_config(tmp)
    out_dir = os.path.join(tmp, "quality")

    # 1. the flagship quality script
    launch_counts.reset()
    flagship, flagship_s = timed(lambda: flagship_quality_eval.main(
        [*QUALITY_FLAGSHIP_ARGS, "--out", os.path.join(out_dir, "flagship.json"),
         "--device", str(dev)], cfg=cfg))
    res, runs = flagship["results"], flagship["runs"]
    check(set(res) == QUALITY_FLAGSHIP_KEYS, f"flagship_quality_eval keys {sorted(res)}")
    check(_finite_tree({k: v for k, v in res.items() if k != "calibration"}),
          "flagship_quality_eval: a metric is not finite")
    check(set(runs) == set(QUALITY_FLAGSHIP_RUNS), f"flagship runs {sorted(runs)}")
    for name, run in runs.items():
        check_k1(tuple(run["k1_launches"]), run["unet_evaluations"], f"flagship {name}")
        check(not any(run["k2_launches_by_variant"].values()),
              f"flagship {name}: K2 launched {run['k2_launches_by_variant']}")
    check(runs["pc1000_w3"]["route"] == "eager" and runs["edm_w3"]["route"] == "graph",
          f"flagship routes: PC-1000 {runs['pc1000_w3']['route']}, "
          f"EDM {runs['edm_w3']['route']}")
    pipeline, _ = _load_pipeline_for_sampling(cfg, dev)
    rows = res["n_dates"] * res["members"]
    result["k1_vs_plain_chain"] = {}
    for batch_rows in (2 * rows, rows):  # the CFG runs' UNet batch, and w=0's
        cond = make_cond(batch_rows, SERVE_HW, dev, 40 + batch_rows)
        batch = {"x": torch.randn(batch_rows, *SERVE_HW, 1,
                                  generator=torch.Generator(dev).manual_seed(batch_rows),
                                  device=dev), **cond}
        row = k1_vs_plain_forward(pipeline.model, batch, dev, "bfloat16", 50 + batch_rows)
        check_k1_forward(row, f"quality flagship UNet at {batch_rows} rows")
        result["k1_vs_plain_chain"][f"128px_batch_{batch_rows}"] = row
    result["flagship"] = dict(
        s=flagship_s, args=QUALITY_FLAGSHIP_ARGS, keys=sorted(res), runs=runs,
        crps_normalized={k: v["normalized"]["crps"] for k, v in res.items()
                         if isinstance(v, dict) and "normalized" in v},
        spread_skill_normalized={k: v["normalized"]["spread_skill"] for k, v in res.items()
                                 if isinstance(v, dict) and "normalized" in v},
        calibration=res["calibration"], pc1000_eager_run_s=runs["pc1000_w3"]["run_s"])
    del flagship
    gc.collect()
    graphs.clear()
    torch.cuda.empty_cache()

    # 2. the full-domain quality script
    launch_counts.reset()
    full, full_s = timed(lambda: full_domain_quality_eval.main(
        [*QUALITY_FULL_ARGS, "--out", os.path.join(out_dir, "full_domain.json"),
         "--device", str(dev)], cfg=cfg))
    res, runs = full["results"], full["runs"]
    check(set(res) == QUALITY_FULL_KEYS, f"full_domain_quality_eval keys {sorted(res)}")
    for w in ("w0", "w3"):
        run = runs[w]
        check_k1(tuple(run["k1_launches"]), run["unet_evaluations"], f"full domain {w}")
        expected = run["unet_evaluations"] * K2_LAYERS_AT_FULL_DOMAIN
        check(run["k2_launches_by_variant"] == {"tc_bf16": expected, "fp32": 0},
              f"full domain {w}: K2 launches {run['k2_launches_by_variant']}, expected "
              f"{expected} tc_bf16")
        check(all(np.isfinite(res[w][r]["crps"]) for r in ("overall", "in_crop", "out_of_crop")),
              f"full domain {w}: CRPS {res[w]}")
    from sbgm_danra_tpu_torch.models.unet import build_score_model, inference_spec
    from sbgm_danra_tpu_torch.training.pipeline import share_tensors

    big = share_tensors(build_score_model(inference_spec(pipeline.spec, FULL_DOMAIN),
                                          pipeline.sde), pipeline.model).to(dev)
    fd_rows = 4  # 2 members, doubled by CFG
    cond = make_cond(fd_rows, (608, 800), dev, 61)
    batch = {"x": torch.randn(fd_rows, 608, 800, 1, generator=torch.Generator(dev).manual_seed(62),
                              device=dev), **cond}
    row = k1_vs_plain_forward(big, batch, dev, "bfloat16", 63)
    check_k1_forward(row, "quality full-domain UNet at 4 rows")
    result["k1_vs_plain_chain"]["608x800_batch_4"] = row
    result["full_domain"] = dict(
        s=full_s, args=QUALITY_FULL_ARGS, keys=sorted(res), runs=runs,
        wall_s={w: runs[w]["wall_s"] for w in ("w0", "w3")},
        crps={w: {r: res[w][r]["crps"] for r in ("overall", "in_crop", "out_of_crop")}
              for w in ("w0", "w3")},
        out_of_crop_crps_penalty_pct={w: res[w]["out_of_crop_crps_penalty_pct"]
                                      for w in ("w0", "w3")})
    del full, big, batch, pipeline
    gc.collect()
    graphs.clear()
    torch.cuda.empty_cache()

    # 3. the exact-score study
    launch_counts.reset()
    study, study_s = timed(lambda: edm_quality_study.main([*QUALITY_STUDY_ARGS, "--device",
                                                            str(dev)]))
    check(all(np.isfinite(m["std_ratio"]) and np.isfinite(m["spread_skill"])
              for rows_ in study.values() for m in rows_.values()), "edm study: not finite")
    result["edm_study"] = dict(
        s=study_s, args=QUALITY_STUDY_ARGS, regimes=sorted(study),
        std_ratio={r: {k: m["std_ratio"] for k, m in rows_.items()} for r, rows_ in study.items()},
        spread_skill={r: {k: m["spread_skill"] for k, m in rows_.items()}
                      for r, rows_ in study.items()},
        k1_launches=list(k1_counts()))
    graphs.clear()

    # 4. the trainer's trace and throughput line; 5. the weight bridge
    traced = result["traced_training"] = _traced_training(dev, tmp)
    check(len(traced["trace_files"]) == 1 and traced["trace_kernel_events"] > 0
          and traced["trace_graph_launches"] > 0,
          f"training trace: {traced['trace_files']}, {traced['trace_kernel_events']} kernel "
          f"events, {traced['trace_graph_launches']} graph launches")
    check(len(traced["first_epoch_throughput"]) == 1 and len(traced["throughput_lines"]) == 3,
          f"training throughput lines: {traced['throughput_lines']}")
    gc.collect()
    graphs.clear()
    torch.cuda.empty_cache()
    bridge = result["convert"] = _convert_round_trip(tmp)
    check(not bridge["unequal"], f"torch -> Flax -> torch not bit-identical: {bridge['unequal'][:8]}")
    emit(phase="quality", settings="the port's quality scripts on train_data's flagship "
         "checkpoint (configs/flagship_synth.yaml's model, 32 synthetic days), the trainer's "
         "trace and the weight bridge", **result)
    flag, fd = result["flagship"]["runs"], result["full_domain"]["runs"]
    return {
        **{f"flagship_quality_eval/{name}/{k}": run["k1_launches"][i] for name, run in flag.items()
           for i, k in enumerate(("conv3x3_stats", "gn_apply"))},
        **{f"full_domain_quality_eval/{w}/{k}": run["k1_launches"][i] for w, run in fd.items()
           for i, k in enumerate(("conv3x3_stats", "gn_apply"))},
        "k2": {f"full_domain_quality_eval/{w}": run["k2_launches_by_variant"]["tc_bf16"]
               for w, run in fd.items()},
    }


PREP_SPLITS = ("train", "valid", "test")
PREP_STATS_TOL = {"mean": 1e-9, "min": 1e-9, "max": 1e-9, "log_mean": 1e-9, "log_min": 1e-9,
                  "log_max": 1e-9, "std": 1e-6, "log_std": 1e-6}  # relative
PREP_SMALL_DAYS = 8  # create_small_batches --n_samples
PREP_FIGURE_DAYS = 4  # run_statistics --figures --max_days


class LogLines(logging.Handler):
    """The log records of a block, as text (the skip lines are checked)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        logging.getLogger().addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger().removeHandler(self)


def _prep_split_checks(cfg, written) -> dict:
    """Each store's train/valid/test days: their counts add up to the days of
    its 'all' store, they are disjoint, and each written day's array equals
    the 'all' store's."""
    from sbgm_danra_tpu_torch.data import zarrlite
    from sbgm_danra_tpu_torch.data.paths import build_data_path

    dims = tuple(cfg.highres.full_domain_dims)
    out = {}
    for model, var in [(cfg.highres.model, cfg.highres.variable)] + [
            (cfg.lowres.model, v) for v in cfg.lowres.condition_variables]:
        every = zarrlite.open_group(build_data_path(cfg.paths.data_dir, model, var, dims, "all"))
        days, unequal = [], []
        counts = {}
        for split in PREP_SPLITS:
            store = zarrlite.open_group(build_data_path(cfg.paths.data_dir, model, var, dims,
                                                        split))
            keys = store.keys()
            counts[split] = len(keys)
            days += keys
            unequal += [k for k in keys if not np.array_equal(store[k]["data"][...],
                                                              every[k]["data"][...])]
        out[f"{model}/{var}"] = dict(
            days=counts, all_days=len(every.keys()),
            counts_match_written=all(written[f"{model}/{var}/{s}"] == n
                                     for s, n in counts.items()),
            sum_ok=sum(counts.values()) == len(every.keys()) == DATA_DAYS,
            disjoint=len(set(days)) == len(days), same_days=sorted(days) == every.keys(),
            unequal_days=unequal)
    return out


def _prep_stats_checks(results: dict, stats_root: str, synthetic_root: str) -> dict:
    """Every statistics JSON that ``run_statistics`` wrote against the one the
    synthetic writer wrote for the same variable, domain, crop and split: the
    largest relative deviation per key, within ``PREP_STATS_TOL``."""
    from sbgm_danra_tpu_torch import transforms as T

    out = {}
    for key in results:
        model, var, crop, split = key.split("/")
        domain = "x".join(map(str, FULL_DOMAIN))
        got = T.load_global_stats(stats_root, model, var, domain, crop, split)
        want = T.load_global_stats(synthetic_root, model, var, domain, crop, split)
        dev = {k: abs(got[k] - v) / abs(v) if v else abs(got[k]) for k, v in want.items()}
        out[key] = dict(n=got["n"], max_rel_dev=max(dev.values()),
                        within=all(dev[k] <= PREP_STATS_TOL[k] for k in dev),
                        rel_dev=dev)
    return out


def phase_data_prep(dev, tmp):
    """A raw archive to generated fields with the port alone, through its CLIs
    as a user calls them (the flagship settings of ``data_config``: 589x789,
    crop [170, 350, 340, 520], DANRA prcp and ERA5 temp and prcp, 32
    synthetic days, under ``tmp/data_prep``):

    1. ``--mode synthetic_data`` with the 'all' split (the raw stores);
    2. ``--mode data_splits`` with ``splits.method: Random`` and JAX's default
       fractions (every synthetic date falls in 2000, which the default Time
       ranges would put in train alone): each store's train/valid/test days
       add up to 32, are disjoint and equal the 'all' store's day for day;
    3. ``--mode run_statistics`` into a fresh ``paths.stats_load_dir``: each
       JSON within ``PREP_STATS_TOL`` of the synthetic writer's (whose sums
       are shifted, ``StreamingStats``' are not), the largest deviation
       printed;
    4. ``--mode train`` on those splits and statistics (one epoch of 2 steps,
       the device loader, the one-step graph), then ``--mode generate`` with
       ``gen_type: [single]`` on its checkpoint: finite artifacts, prcp >= 0
       after the back-transform, 8 K1 launches a UNet evaluation;
    5. ``main_data_app``: ``run_comparison``, ``run_correlation`` (with
       ``--figures``) and ``create_small_batches`` (finite results, 8 days a
       small store), then ``run_statistics --figures``: without matplotlib
       (the card machine's setting) one skip line a figure set and a normal
       exit, with it the PNGs.
    Each mode's wall seconds and the phase's are printed."""
    import argparse

    from sbgm_danra_tpu_torch.cli import main_data_app
    from sbgm_danra_tpu_torch.cli.main_app import run_mode
    from sbgm_danra_tpu_torch.sampling import graphs

    root = os.path.join(tmp, "data_prep")
    cfg = data_config(root, epochs=1, steps_per_epoch=2, fused_steps=0)
    cfg.splits.method = "Random"
    cfg.evaluation.gen_type = ("single",)
    synthetic_stats = cfg.paths.stats_load_dir
    cfg.paths.stats_load_dir = os.path.join(root, "stats_prep")
    args = argparse.Namespace(device=str(dev), n_days=DATA_DAYS, no_all_split=False)
    mode_s, result = {}, {}
    start = time.perf_counter()

    def mode(name, fn):
        out, mode_s[name] = timed(fn)
        return out

    mode("synthetic_data", lambda: run_mode(cfg, "synthetic_data", args))
    written = mode("data_splits", lambda: run_mode(cfg, "data_splits", args))
    result["splits"] = splits = _prep_split_checks(cfg, written)
    stats = mode("run_statistics", lambda: run_mode(cfg, "run_statistics", args))
    result["statistics"] = stats_checks = _prep_stats_checks(stats, cfg.paths.stats_load_dir,
                                                             synthetic_stats)
    result["stats_max_rel_dev"] = max(c["max_rel_dev"] for c in stats_checks.values())

    pipe = mode("train", lambda: run_mode(cfg, "train", args))
    history = pipe.history
    result["train"] = dict(step=pipe.state.step, history=history,
                           finite=all(np.isfinite(history["train_loss"] + history["val_loss"])))
    del pipe
    graphs.clear()
    torch.cuda.empty_cache()
    launch_counts.reset()  # the generate call's run starts here
    run = mode("generate_single", lambda: run_mode(cfg, "generate", args))
    k1c, k2c = k1_counts(), k2_counts()
    sample_path = run["generators"]["single"].sample_path
    result["generate_single"] = dict(k1_launches=list(k1c), k2_launches_by_variant=k2c,
                                     **_artifact_checks(sample_path, "single", 1, SERVE_HW))
    del run
    graphs.clear()
    torch.cuda.empty_cache()

    cfg_path = cfg.dump(os.path.join(root, "data_prep.yaml"))
    check(cfg_path is not None, "data_prep: the config dump needs PyYAML")

    def data_app(*argv):
        return main_data_app.main(["--config_path", cfg_path, *argv])

    small_dir = os.path.join(root, "small")
    with LogLines() as log:
        cmp = mode("run_comparison", lambda: data_app("--mode", "run_comparison"))["comparison"]
        corr = mode("run_correlation", lambda: data_app("--mode", "run_correlation",
                                                        "--figures"))["correlations"]
        small = mode("create_small_batches", lambda: data_app(
            "--mode", "create_small_batches", "--out_dir", small_dir,
            "--n_samples", str(PREP_SMALL_DAYS)))["small_batches"]
        figs = mode("run_statistics_figures", lambda: data_app(
            "--mode", "run_statistics", "--figures", "--max_days", str(PREP_FIGURE_DAYS)))
    skips = [line for line in log.lines if line.endswith("skipped: matplotlib missing")]
    try:
        import matplotlib  # noqa: F401  (absent on the card machine)
        have_mpl = True
    except ImportError:
        have_mpl = False
    fig_dir = os.path.join(cfg.paths.sample_dir, "figures")
    pngs = sorted(os.path.relpath(os.path.join(d, f), fig_dir)
                  for d, _, fs in os.walk(fig_dir) for f in fs)
    n_vars = 1 + len(cfg.lowres.condition_variables)
    ts = cmp["timeseries"]
    result["data_app"] = dict(
        comparison=dict(days=len(cmp["dates"]), bias=float(ts["bias"].mean()),
                        rmse=float(ts["rmse"].mean()), corr=float(ts["corr"].mean()),
                        spectrum_log_mse=cmp["spectrum"]["log_mse"],
                        seasons=sorted(cmp["seasonal_spectra"]),
                        finite=all(bool(np.isfinite(v).all()) for v in (
                            ts["bias"], ts["rmse"], ts["corr"], cmp["field"]["diff_map"],
                            cmp["spectrum"]["spectrum_a"], cmp["spectrum"]["spectrum_b"],
                            cmp["spectrum"]["log_mse"]))),
        correlations={v: dict(temporal_pearson=c["temporal_pearson"],
                              temporal_spearman=c["temporal_spearman"],
                              spatial_finite_share=float(np.isfinite(c["spatial_pearson"]).mean()),
                              spatial_in_range=bool(np.all(np.abs(
                                  c["spatial_pearson"][np.isfinite(c["spatial_pearson"])])
                                  <= 1 + 1e-9)))
                      for v, c in corr.items()},
        small_batches=small, statistics_figures=figs.get("figures"),
        matplotlib=have_mpl, skip_lines=skips, figures=pngs)
    result["mode_s"] = mode_s
    result["total_s"] = time.perf_counter() - start
    emit(phase="data_prep", settings="configs/flagship_synth.yaml's data (profile_port."
         "data_config): DANRA prcp, ERA5 temp and prcp at 589x789, crop [170, 350, 340, 520], "
         f"{DATA_DAYS} synthetic days, splits Random (0.7/0.15/0.15), one train epoch of 2 "
         "steps, generate single (dpmpp-25, CFG w=3)", **result)

    for store, c in splits.items():
        check(c["sum_ok"] and c["disjoint"] and c["same_days"] and c["counts_match_written"]
              and not c["unequal_days"], f"data_splits {store}: {c}")
    check(len(stats_checks) == 1 + 1 + len(cfg.lowres.condition_variables),
          f"run_statistics wrote {sorted(stats_checks)}")
    check(all(c["within"] for c in stats_checks.values()),
          f"run_statistics against the synthetic writer's: {stats_checks}")
    check(result["train"]["finite"] and result["train"]["step"] == 2,
          f"data_prep train: {result['train']}")
    gen = result["generate_single"]
    check(gen["shapes_ok"] and gen["finite"] and gen["prcp_min_mm"] >= 0.0,
          f"data_prep generate single: {gen}")
    check_k1(k1c, 3 * (GEN_STEPS - 1), "data_prep generate single (warm-ups and a replay)")
    check(not any(k2c.values()), f"data_prep generate single: K2 launched {k2c}")
    app = result["data_app"]
    check(app["comparison"]["finite"] and app["comparison"]["days"] == DATA_DAYS,
          f"run_comparison: {app['comparison']}")
    check(all(np.isfinite([c["temporal_pearson"], c["temporal_spearman"]]).all()
              and c["spatial_finite_share"] > 0 and c["spatial_in_range"]
              for c in app["correlations"].values()), f"run_correlation: {app['correlations']}")
    check(set(small.values()) == {PREP_SMALL_DAYS} and len(small) == n_vars,
          f"create_small_batches: {small}")
    if have_mpl:
        check(len(pngs) == 5 * n_vars + 3 * len(cfg.lowres.condition_variables),
              f"figures: {pngs}")
    else:
        check(len(skips) == n_vars + len(cfg.lowres.condition_variables) and not pngs,
              f"figures without matplotlib: skip lines {skips}, files {pngs}")
    return {name: k1c[i] for i, name in enumerate(("conv3x3_stats", "gn_apply"))}


WINDOW_DAYS = 6  # windowed phase: 22 train days in 4 windows, the last wrapping to day 0
ARCHIVE_30Y_DAYS = 10957  # a 30-year daily archive, for the stager's projection


def _same_tree(a, b) -> bool:
    """Checkpoint trees equal: every tensor bit for bit (on the CPU), every
    other value ``==``."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    return a == b


def _host_copy(tree):
    """A checkpoint tree with every tensor copied to the host now."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _slots_equal_host(loader) -> dict:
    """Each card slot against its block's days loaded on the host and cast
    by torch to the staging dtype: bit for bit."""
    from sbgm_danra_tpu_torch.data.device_data import load_days

    out = {}
    for slot, block in enumerate(loader._slot_block):
        if block < 0:
            continue
        hr, lr, classes = load_days(loader.dataset, loader._block_dates(block))
        host = torch.from_numpy(np.concatenate([hr[..., None], lr], axis=-1)).to(loader.dtype)
        out[f"slot{slot}_block{block}"] = bool(
            torch.equal(loader._slots[slot].cpu(), host)
            and torch.equal(loader._slot_classes[slot].cpu(), torch.from_numpy(classes)))
    return out


DECODE_ROUNDS = 3


def _decode_ms_per_day(dataset, days) -> dict:
    """Host milliseconds a day to read, decode and transform ``days``
    full-domain days (``load_days``, one thread) on the native codec and on
    the zlib path, ``DECODE_ROUNDS`` rounds alternating the two (the days in
    the page cache); and the chunk decode alone (``zarrlite`` reads of the
    three fields' full domains, no transform)."""
    from sbgm_danra_tpu_torch.data import native_codec
    from sbgm_danra_tpu_torch.data.dataset import extract_2d
    from sbgm_danra_tpu_torch.data.device_data import load_days

    sources = [(dataset.hr, dataset._hr_group, dataset._hr_map)] + [
        (c, dataset._lr_groups[c.name], dataset._lr_maps[c.name])
        for c in dataset.lr_conditions]
    out = {path: dict(ms_per_day=[], decode_only_ms_per_day=[]) for path in ("native", "zlib")}
    saved = os.environ.get("SBGM_ZARR_CODEC_DISABLE")
    try:
        for _ in range(DECODE_ROUNDS):
            for path, disable in (("native", None), ("zlib", "1")):
                if disable:
                    os.environ["SBGM_ZARR_CODEC_DISABLE"] = disable
                else:
                    os.environ.pop("SBGM_ZARR_CODEC_DISABLE", None)
                native_codec.reset()
                out[path]["path_taken"] = native_codec.decode_path()
                t0 = time.perf_counter()
                load_days(dataset, days)
                t1 = time.perf_counter()
                for date in days:
                    for src, group, day_map in sources:
                        extract_2d(group, day_map[date], src.name)
                t2 = time.perf_counter()
                out[path]["ms_per_day"].append(1e3 * (t1 - t0) / len(days))
                out[path]["decode_only_ms_per_day"].append(1e3 * (t2 - t1) / len(days))
        for path in out:
            out[path]["median_ms_per_day"] = float(np.median(out[path]["ms_per_day"]))
            out[path]["median_decode_only_ms_per_day"] = float(
                np.median(out[path]["decode_only_ms_per_day"]))
    finally:
        if saved is None:
            os.environ.pop("SBGM_ZARR_CODEC_DISABLE", None)
        else:
            os.environ["SBGM_ZARR_CODEC_DISABLE"] = saved
        native_codec.reset()
    return out


def _pinned_copy_gb_s(loader, repeats: int = 5) -> dict:
    """The window's pinned host buffer copied to a card tensor of its shape
    (``non_blocking``, on a side stream, as the stager copies): the median of
    ``repeats`` copies timed with CUDA events."""
    src = loader._host
    dst = torch.empty_like(loader._slots[0])
    stream = torch.cuda.Stream()
    times = []
    with torch.cuda.stream(stream):
        for _ in range(repeats):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            dst.copy_(src, non_blocking=True)
            end.record(stream)
            end.synchronize()
            times.append(start.elapsed_time(end))
    ms = float(np.median(times))
    nbytes = src.numel() * src.element_size()
    return dict(bytes=nbytes, ms=ms, gb_s=nbytes / ms / 1e6, pinned=bool(src.is_pinned()))


def phase_windowed(dev, tmp):
    """The rotating-window loader (``data/windowed_data.py``) on the flagship
    path, on ``train_data``'s stores: ``data_handling.device_window_days`` 6
    over the 22 train days (4 windows), bf16 staging, ``fused_steps`` 25,
    ``training.async_checkpointing`` on, built by ``make_loaders`` and
    trained by ``TrainingPipeline.train``:

    1. at construction, the card slots equal the host days after the bf16
       cast, bit for bit;
    2. two epochs in fixed mode (``device_window_steps`` 25: one fused chunk a
       window, 100 steps an epoch, 3 swaps an epoch), then one epoch of the
       same loader in swap-on-ready mode (``window_steps`` 0): every window
       visited each epoch, ``n_swaps``, ``stall_s``, finite losses, at most
       two fused-step graphs (one a card slot) after two epochs and the same
       graphs, replayed, after the third: no capture after the first epoch;
    3. K1's launches on the run (the eval steps', ``train=False``) against
       the count the run's validations call for (``eval_evaluations``: the
       valid batches of each epoch and each eval graph's warm-ups), then the
       trained UNet at the eval step's batch against ``plain_k1()``;
    4. each asynchronous save of the run (written by the worker while the
       next epoch trained) against a blocking host copy of what it saves,
       taken at the save;
    5. the resident loader's fused step on the same stores (its second
       epoch, 100 steps) against the windowed second epoch: samples/s;
    6. a windowed sample at fixed draws, fp32 staging, one window over the
       split, against the resident loader's: bit for bit;
    7. the host's decode ms a day on the native codec and on zlib, the
       pinned copy's GB/s, and from them a projection of the stager for a
       30-year archive."""
    import gc

    from sbgm_danra_tpu_torch.data import native_codec
    from sbgm_danra_tpu_torch.data.factory import make_dataset, make_loaders
    from sbgm_danra_tpu_torch.data.windowed_data import WindowedDeviceLoader
    from sbgm_danra_tpu_torch.training.checkpointing import state_tree
    from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline

    start = time.perf_counter()
    cfg = data_config(tmp, steps_per_epoch=None, async_checkpointing=True)
    cfg.data_handling.device_window_days = WINDOW_DAYS
    cfg.data_handling.device_window_steps = FUSED_K
    cfg.paths.checkpoint_dir = os.path.join(tmp, "windowed", "ckpt")
    cfg.paths.sample_dir = os.path.join(tmp, "windowed", "samples")
    train, valid, _ = make_loaders(cfg, device=dev)
    check(isinstance(train, WindowedDeviceLoader) and train.n_windows == 4
          and train.dtype == torch.bfloat16, f"make_loaders built {type(train).__name__}")
    slots_at_start = _slots_equal_host(train)

    pipe = TrainingPipeline(cfg, train, valid, device=dev)
    blocks, walls, swaps, refs = [], [], [], {}
    fused, batches = pipe._fused, pipe.train_batches

    def fused_call(*args):  # the window each chunk ran on
        blocks[-1].append(train.current_block)
        return fused(*args)

    def train_batches(max_steps=None):
        blocks.append([])
        before = train.n_swaps
        out, s = timed(lambda: batches(max_steps))
        walls.append(s)
        swaps.append(train.n_swaps - before)
        return out

    manager, save = pipe.checkpoints, pipe.checkpoints.save

    def save_and_copy(step, state, meta=None, scheduler=None, early_stop=None, block=True):
        # what a blocking save would write, copied to the host now; then the
        # asynchronous save, written by the worker while the next epoch trains
        refs[step] = (block, _host_copy(state_tree(state, scheduler, early_stop, meta)))
        return save(step, state, meta, scheduler, early_stop, block=block)

    manager.save = save_and_copy
    pipe._fused, pipe.train_batches = fused_call, train_batches
    losses = recorded_losses(pipe)
    with watched_validations() as validations:
        launch_counts.reset()  # the windowed run starts here
        pipe.train(epochs=2)
        graphs_two_epochs = graph_stats("fused")
        train.window_steps = 0  # the same loader, swap-on-ready
        stall_before = train.stall_s
        pipe.train(epochs=1)
        k1c = k1_counts()
    graphs_three_epochs = graph_stats("fused")
    ready_stall_s = train.stall_s - stall_before
    slots_at_end = _slots_equal_host(train)

    saved = {}
    for step, (block, ref) in refs.items():
        if step in pipe.checkpoints._index:
            _, tree = pipe.checkpoints.load_tree(step)
            saved[step] = dict(block=block, **{k: _same_tree(tree[k], ref[k]) for k in ref})

    # the trained UNet at the eval step's batch: K1 against the plain chain
    k1_fwd = k1_vs_plain_forward(pipe.model, next(iter(valid)), dev, "bfloat16", seed=8)
    history = pipe.history
    pipe.checkpoints.close()
    host_copy = _pinned_copy_gb_s(train)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    # the resident loader on the same stores: its second epoch of 100 steps
    rcfg = data_config(tmp, steps_per_epoch=None)
    rcfg.paths.checkpoint_dir = os.path.join(tmp, "windowed", "resident_ckpt")
    resident, _, _ = make_loaders(rcfg, device=dev)
    rpipe = TrainingPipeline(rcfg, resident, device=dev)
    _, resident_first_s = timed(lambda: rpipe.train_batches(FUSED_K))  # the capture
    _, resident_s = timed(lambda: rpipe.train_batches(len(blocks[1]) * FUSED_K))
    del rpipe
    gc.collect()
    torch.cuda.empty_cache()

    # one fp32 window over the split against the resident stacks, same draws
    one = WindowedDeviceLoader(make_dataset(cfg, "train"), cfg.training.batch_size,
                               window_days=10**6, seed=0, dtype=torch.float32,
                               cfg_dropout_prob=cfg.classifier_free_guidance.drop_prob,
                               device=dev)
    draws = one.draws(torch.Generator(dev).manual_seed(13))
    a, b = one.sample_from(*draws), resident.sample_from(*draws)
    one_window_unequal = [k for k in a if not torch.equal(a[k], b[k])]
    del one, resident, a, b

    decode = _decode_ms_per_day(train.dataset, list(train._block_dates(0)))
    day_bytes = host_copy["bytes"] / train.window_days
    window_step_s = walls[1] / (len(blocks[1]) * FUSED_K)  # fixed mode, second epoch
    ready_step_s = walls[2] / (len(blocks[2]) * FUSED_K)  # swap-on-ready
    resident_step_s = resident_s / (len(blocks[1]) * FUSED_K)
    projection = {}
    for w in (WINDOW_DAYS, 365):
        stage_s = w * (min(decode[p]["median_ms_per_day"] for p in decode) / 1e3) + w * day_bytes / (
            host_copy["gb_s"] * 1e9)
        projection[f"window_{w}_days"] = dict(
            windows=-(-ARCHIVE_30Y_DAYS // w), stage_s=stage_s,
            slot_gib=w * day_bytes / 2**30,
            train_steps_to_hide_staging=stage_s / ready_step_s)
    finite = all(np.isfinite(float(v)) for v in losses)
    evaluations = eval_evaluations(validations)
    result = dict(
        windows=train.n_windows, window_days=train.window_days, dtype="bfloat16",
        days=len(train.dates), slots_equal_host_at_start=slots_at_start,
        slots_equal_host_at_end=slots_at_end, blocks_by_epoch=blocks,
        swaps_by_epoch=swaps, epoch_s=walls, steps_by_epoch=[len(b) * FUSED_K for b in blocks],
        ready_mode_stall_s=ready_stall_s, stall_s=train.stall_s, n_swaps=train.n_swaps,
        host_load_s_by_window=train.load_s, losses_finite=finite, history=history,
        fused_graphs_after_two_epochs=graphs_two_epochs,
        fused_graphs_after_three_epochs=graphs_three_epochs,
        k1_launches=list(k1c), validation_batches=validations, eval_evaluations=evaluations,
        k1_vs_plain_chain=k1_fwd,
        async_saves_equal_blocking=saved, fixed_step_s=window_step_s,
        ready_step_s=ready_step_s, resident_step_s=resident_step_s,
        resident_first_chunk_s=resident_first_s,
        fixed_vs_resident_step=window_step_s / resident_step_s,
        ready_vs_resident_step=ready_step_s / resident_step_s,
        fixed_samples_per_s=cfg.training.batch_size / window_step_s,
        ready_samples_per_s=cfg.training.batch_size / ready_step_s,
        resident_samples_per_s=cfg.training.batch_size / resident_step_s,
        fixed_mode_stall_s=train.stall_s - ready_stall_s,
        one_window_fp32_vs_resident_unequal_keys=one_window_unequal,
        decode=decode, decode_path=native_codec.decode_path(), host_cores=os.cpu_count(),
        zlib_h=os.path.exists("/usr/include/zlib.h"), pinned_copy=host_copy,
        chunked_upload="not used: one copy a window (the 64 MiB slices of the JAX "
                       "loader would be one slice of this 17 MB window)",
        projection_30y=dict(note="projection, not a measurement: the faster path's decode "
                                 "ms a day x days a window + the window's bytes at the pinned "
                                 "copy's rate, against the swap-on-ready step time",
                            archive_days=ARCHIVE_30Y_DAYS, **projection),
        total_s=time.perf_counter() - start)
    emit(phase="windowed", settings="configs/flagship_synth.yaml (bf16 UNet, batch 128, "
         "128x128 crops inside [170, 350, 340, 520] of 589x789, SDF, CFG 0.1, fused_steps "
         f"25), 22 train days in windows of {WINDOW_DAYS} (bf16 staging), "
         "async_checkpointing", **result)
    fixed = blocks[:2]
    check(slots_at_start and all(slots_at_start.values()) and all(slots_at_end.values()),
          f"card slots differ from the host days: {slots_at_start} {slots_at_end}")
    check(all(sorted(set(b)) == list(range(train.n_windows)) for b in blocks),
          f"not every window visited: {blocks}")
    check(swaps == [train.n_windows - 1] * 3 and all(len(b) == train.n_windows for b in fixed),
          f"swaps {swaps}, chunks {blocks}")
    check(len(graphs_two_epochs) <= 2 and [g["capture_s"] for g in graphs_three_epochs]
          == [g["capture_s"] for g in graphs_two_epochs],
          f"fused graphs {graphs_two_epochs} -> {graphs_three_epochs}")
    check(finite and all(np.isfinite(history["train_loss"] + history["val_loss"])),
          f"windowed losses {history}")
    check(validations == [len(valid)] * 3, f"windowed validations {validations}")
    check_k1(k1c, evaluations, "windowed run's eval steps")
    check_k1_forward(k1_fwd, "trained UNet at the windowed eval batch")
    check(saved and all(not v["block"] and all(x for k, x in v.items() if k != "block")
                        for v in saved.values()),
          f"async saves against blocking copies: {saved}")
    check(not one_window_unequal, f"one fp32 window vs the resident loader: {one_window_unequal}")
    check(decode["native"]["path_taken"] == "native" and decode["zlib"]["path_taken"] == "zlib",
          f"decode paths {decode}")
    return {name: k1c[i] for i, name in enumerate(("conv3x3_stats", "gn_apply"))}


SWEEP_TRIALS = 2
SWEEP_GROWTH = 1.05  # reserved memory after trial 2 against trial 1


def phase_sweep(dev, tmp):
    """``sweep/run_sweep.py`` on the card: 2 trials of
    ``configs/sweep_tpu.yaml``'s model (its sampler, model, training,
    guidance and evaluation sections: fp32, 32x32 crops, batch 8, 1 epoch of
    its 8 steps each, GP sampler, SuccessiveHalving) on ``train_data``'s
    flagship stores (589x789, crop region [170, 350, 340, 520], the card
    loader), a sqlite study under ``tmp``. Each trial is a new architecture
    in this process; the card's reserved memory after each trial (once its
    memory is released, ``run_sweep.release_trial_memory``) is printed, and
    trial 2 may end at most 5% above trial 1. K1 (fp32) launches on the
    trials' eval steps are held against the count their validations call for
    (``eval_evaluations``), and after each validation, while the trial's
    pipeline lives, its UNet at the eval batch against ``plain_k1()``
    (``K1_FWD_TOL``, TF32 off as in the eval step)."""
    import dataclasses
    import json as json_

    import yaml

    from sbgm_danra_tpu_torch.sweep.run_sweep import run_sweep

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                           "sweep_tpu.yaml")) as f:
        sweep = yaml.safe_load(f)
    flagship = json_.loads(json_.dumps(dataclasses.asdict(data_config(tmp))))
    base = {k: flagship[k] for k in ("paths", "highres", "lowres", "data_handling",
                                     "stationary_conditions", "transforms")}
    base.update({k: sweep[k] for k in ("experiment", "sampler", "model", "training",
                                        "classifier_free_guidance", "evaluation",
                                        "visualization")})
    base["highres"]["data_size"] = sweep["highres"]["data_size"]
    root = os.path.join(tmp, "sweep")
    base["paths"].update(checkpoint_dir=os.path.join(root, "ckpt"),
                         sample_dir=os.path.join(root, "samples"))
    reserved = []

    def after_trial(trial):
        torch.cuda.synchronize()
        reserved.append(dict(trial=trial.trial_id, params=dict(trial.params),
                             reserved_bytes=torch.cuda.memory_reserved(dev),
                             allocated_bytes=torch.cuda.memory_allocated(dev),
                             at_s=time.perf_counter() - t0))

    os.makedirs(root, exist_ok=True)
    config_path = os.path.join(root, "base.yaml")
    with open(config_path, "w") as f:
        yaml.safe_dump(base, f)
    k1_fwd = []

    def k1_at_eval_batch(pipe):  # the trial's UNet at the shapes its eval step ran
        k1_fwd.append(k1_vs_plain_forward(pipe.model, next(iter(pipe.valid_loader)), dev,
                                          pipe.cfg.model.compute_dtype, seed=40 + len(k1_fwd)))

    before = torch.cuda.memory_reserved(dev)
    with watched_validations(k1_at_eval_batch) as validations:
        launch_counts.reset()  # the sweep's run starts here
        t0 = time.perf_counter()
        study = run_sweep(config_path, os.path.join(root, "study.db"), n_trials=SWEEP_TRIALS,
                          epochs=1, steps_per_epoch=sweep["training"]["steps_per_epoch"],
                          device=dev, after_trial=after_trial)
        wall = time.perf_counter() - t0
        k1c = k1_counts()
    trials = study.trials
    evaluations = eval_evaluations(validations)
    growth = reserved[1]["reserved_bytes"] / max(reserved[0]["reserved_bytes"], 1)
    emit(phase="sweep", settings="configs/sweep_tpu.yaml's sampler/model/training sections "
         "(fp32, 32x32 crops, batch 8, 8 steps, 1 epoch) on the flagship stores, GP sampler, "
         "SuccessiveHalving", trials=trials, reserved_before_bytes=before,
         reserved_after_trial=reserved, growth_trial2_over_trial1=growth,
         growth_limit=SWEEP_GROWTH, wall_s=wall, k1_fp32_launches=list(k1c),
         validation_batches=validations, eval_evaluations=evaluations,
         k1_vs_plain_chain=k1_fwd)
    check(len(trials) == SWEEP_TRIALS and all(t["state"] in ("complete", "pruned")
                                               for t in trials), f"sweep trials {trials}")
    check(len(reserved) == SWEEP_TRIALS and growth <= SWEEP_GROWTH,
          f"reserved memory grew from trial 1 to trial 2: {reserved}")
    check(len(validations) == sum(len(t["intermediate"]) for t in trials) == len(k1_fwd),
          f"sweep validations {validations}, trials {trials}")
    check_k1(k1c, evaluations, "sweep trials' eval steps")
    for i, row in enumerate(k1_fwd):
        check_k1_forward(row, f"sweep validation {i}'s UNet at the eval batch")
    return {name: k1c[i] for i, name in enumerate(("conv3x3_stats", "gn_apply"))}

# -- parallel: the parallel layer on the one card --------------------------------

PAR_RANKS = 2  # gloo ranks sharing the card (NCCL refuses two ranks on one device)
PAR_ENSEMBLE = 8  # members at 128 px, 4 a rank (configs/flagship_synth.yaml: n_repeats 8)
PAR_WINDOW_DAYS = 22  # the windowed phase's 22 train days, one window, 11 a rank
PAR_TP_BATCH = 8  # the DP+TP step's global batch at 128 px
# the flagship's (ModelSpec(in_channels=6, num_classes=4)) fraction of parameter
# elements that the tensor-parallel rules shard; tests/test_torch_parallel.py
# holds it equal to JAX's sharded_param_fraction on the same model
TP_FLAGSHIP_FRACTION = 0.9624762141711297
PAR_LOSS_TOL = {"nccl_graph": 1e-3, "gloo_eager": 1e-3, "full_domain": 1e-2, "tp": 1e-2}
# one Adam step of the two-rank step against one device's: a gradient that is 0
# in exact arithmetic (the key third of a qkv bias) is float noise on both, and
# Adam turns its sign into +-lr; the first run read 0.224 over the parameters
# (the worst tensor encoder.attn4.qkv.bias, 0.84) and 6e-4 over the BatchNorm
# statistics, which keep STATE_DRIFT_TOL; the gradients themselves are held to
# PAR_GRAD_TOL
PAR_DRIFT_TOL = 0.5
# each gradient (part) of a DP step against one device's, of its max |ref|: the
# one-rank NCCL step is the same computation (read 0); two bf16 gloo ranks split
# the batch, so cuDNN sums in another order: the first run read 6.7e-2 at worst
# (encoder.layer4.block0.conv1.weight), median 4.1e-3 (a bf16 ulp is 3.9e-3);
# the single step's own repeat (``single_repeat_grad_err_*``) is reported beside
PAR_GRAD_TOL = 0.1
PAR_FP32_BATCH = 16  # the fp32 comparison's global batch, 8 rows a rank
PAR_GRAD_TOL_FP32 = 1e-3  # its gradients (parts), of max |ref|
PAR_ROWS_TOL = 5e-2  # ensemble rows, 4 a rank against 8 in one call: of max |ref| (bf16)
RING_TOL = {"bfloat16": BF16_TOLERANCE, "float32": "fp32: |err| <= 2e-5 + 2e-5 |ref| against "
            "the plain version with TF32 off"}


def _par_setup():
    """A rank's device and the imports every parallel body uses."""
    dev = torch.device("cuda", torch.cuda.current_device())
    from sbgm_danra_tpu_torch.ops import cuda_attention, fused_conv_gn

    for m in (cuda_attention, fused_conv_gn):  # built by the parent: loaded here
        m.build_library()
    return dev


def _grads(model) -> dict:
    """Each parameter's gradient after a step (the all-reduced mean on a
    mesh; 0 where the loss reads none, as the step fills it in)."""
    return {k: p.grad.detach().float().clone() for k, p in model.named_parameters()}


def _grad_err(got: dict, ref: dict) -> dict:
    """max |got - ref| / max |ref| of each gradient part (``_grad_parts``)."""
    got, ref = _grad_parts(got), _grad_parts(ref)
    return {k: (got[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
            for k, g in ref.items()}


def _dp_step_vs_single(dev, tmp, mesh, cfg, batch, seed: int, steps: int, t_eps=1e-3):
    """One step of ``TrainingPipeline(mesh=mesh)`` on this rank's rows of
    ``batch`` against the single-device pipeline's step on the whole batch
    (rank 0 computes it; the same seeded weights, batch, t and z), then
    ``steps`` timed steps of the DP pipeline on the same batch. Returns the
    DP step's loss, route, step times and K2 counts, and on rank 0 the
    comparison: the losses, the trained states (``state_drift``) and each
    parameter's gradient, max |DP - single| over max |single|."""
    from sbgm_danra_tpu_torch.sde import dsm_draws
    from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline

    g = torch.Generator(dev).manual_seed(seed)
    t, z = dsm_draws(batch["x"], g, t_eps)  # the global batch's draws
    pipe = TrainingPipeline(cfg, [], device=dev, mesh=mesh)
    before, _ = _snapshot(pipe.state)
    local = pipe.shard(batch)
    launch_counts.reset()
    dp_loss = pipe._train_step(pipe.state, local, t=t, z=z)["loss"].item()
    k2f, k2b = k2_counts(), k2_counts("bwd")
    dp_after, dp_ema = _snapshot(pipe.state)
    dp_grads = _grads(pipe.model)
    out = dict(loss=dp_loss, route=pipe._train_step.route, rows=int(local["x"].shape[0]),
               k2_fwd=sum(k2f.values()), k2_bwd=sum(k2b.values()), k2_fwd_by_variant=k2f)
    if steps:
        loader = TimedBatches([batch] * steps)
        pipe.train_loader = loader
        pipe.train_batches(steps)
        out["step_s"] = loader.step_s()
        if out["route"]["graphs"]:
            out["graph"] = graph_stats("dp train step")
    del pipe
    torch.cuda.empty_cache()
    if mesh.rank == 0:
        single = TrainingPipeline(cfg, [], device=dev, capture=out["route"]["graphs"])
        s_loss, s_grads, saved = _step_grads(single, batch, t, z, single._train_step)
        s_after, s_ema = _snapshot(single.state)
        _restore(single, saved)  # the single step again: its own run-to-run spread
        _, again, _ = _step_grads(single, batch, t, z, single._train_step)
        grad_err, noise = _grad_err(dp_grads, s_grads), _grad_err(again, s_grads)
        if steps:
            loader = TimedBatches([batch] * steps)
            single.train_loader = loader
            single.train_batches(steps)
            out["single_step_s"] = loader.step_s()
        worst = max(grad_err, key=grad_err.get)
        out.update(single_loss=s_loss, loss_rel_diff=abs(dp_loss - s_loss) / abs(s_loss),
                   state_drift=state_drift(before, {"after": dp_after, "ema": dp_ema},
                                           {"after": s_after, "ema": s_ema}),
                   grad_err_max=grad_err[worst], grad_err_worst=worst,
                   grad_err_median=float(np.median(list(grad_err.values()))),
                   single_repeat_grad_err_max=max(noise.values()),
                   single_repeat_grad_err_median=float(np.median(list(noise.values()))))
        del single
        torch.cuda.empty_cache()
    return out


def parallel_nccl_rank(p):
    """(a) NCCL on one rank: the flagship train-128 DP step on its CUDA graph
    (the all-reduce captured) against the single-device step's graph."""
    dev = _par_setup()
    from sbgm_danra_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device=dev)
    spec = TRAIN_128
    batch = train_batches(torch, 1, spec["batch"], spec["hw"], dev, seed=30)[0]
    with tempfile.TemporaryDirectory() as tmp:
        out = _dp_step_vs_single(dev, tmp, mesh, train_config(tmp, "bfloat16", "xla", False),
                                 batch, seed=5, steps=spec["steps"])
    out.update(backend=mesh.backend, route_collectives=mesh.route(),
               nccl_collectives=_one_rank_collectives(dev, mesh))
    return out


def _one_rank_collectives(dev, mesh) -> dict:
    """Each NCCL call of ``parallel/collectives.py`` on a one-rank group, on
    the card: the identity, so each must give its input back."""
    from sbgm_danra_tpu_torch.parallel import collectives as C

    x = torch.randn(4, 6, 3, generator=torch.Generator(dev).manual_seed(9), device=dev)
    group = mesh.world
    return {"route": C.route(group, x),
            "all_reduce": bool(torch.equal(C.all_reduce_(x.clone(), group, "mean"), x)),
            "broadcast": bool(torch.equal(C.broadcast_(x.clone(), 0, group), x)),
            "all_gather": bool(torch.equal(C.all_gather(x, group, 1), x)),
            "reduce_scatter": bool(torch.equal(C.reduce_scatter_mean(x, group, 1), x))}


def _ensemble(dev, mesh):
    """(b3) 8 members at 128 px, 4 a rank, dpmpp-25 with CFG w=3, on the
    sampler's graph (a capture, then a replay counted) against the one-card
    call of 8 (rank 0), and K1 against the plain chain at the rank's batch."""
    from sbgm_danra_tpu_torch.models.unet import build_score_model
    from sbgm_danra_tpu_torch.parallel.ensemble import generate_ensemble
    from sbgm_danra_tpu_torch.sampling import graphs
    from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig

    model = build_score_model(flagship_spec(compute_dtype="bfloat16"),
                              generator=torch.Generator().manual_seed(0)).to(dev).eval()
    config = SamplerConfig(num_steps=GEN_STEPS, guidance_scale=3.0)
    cond = make_cond(1, SERVE_HW, dev, 21)

    def call(m):
        return generate_ensemble(model, torch.Generator(dev).manual_seed(22), PAR_ENSEMBLE,
                                 (*SERVE_HW, 1), cond=cond, sampler="dpmpp_sampler",
                                 config=config, mesh=m)

    with torch.inference_mode():
        call(mesh)  # the capture
        launch_counts.reset()  # this rank's ensemble run: one replay
        rows, wall = timed(lambda: call(mesh))
        counts = k1_counts()
    per = PAR_ENSEMBLE // mesh.size
    batch = make_cond(2 * per, SERVE_HW, dev, 23)  # CFG doubles the rank's members
    batch["x"] = torch.randn(2 * per, *SERVE_HW, 1, generator=torch.Generator(dev).manual_seed(24),
                             device=dev)
    k1_row = k1_vs_plain_forward(model, batch, dev, "bfloat16", seed=25)
    out = dict(members=PAR_ENSEMBLE, members_a_rank=per, k1_launches=list(counts),
               unet_evaluations=GEN_STEPS - 1, wall_s=wall, k1_vs_plain=k1_row,
               finite=bool(torch.isfinite(rows).all()), shape=list(rows.shape),
               distinct_members=len({r.float().cpu().numpy().tobytes() for r in rows}))
    if mesh.rank == 0:
        with torch.inference_mode():
            call(None)
            one, one_wall = timed(lambda: call(None))
        out.update(one_card_wall_s=one_wall, rows_rel_err=_rel(rows, one),
                   rows_bit_identical=bool(torch.equal(rows, one)))
    graphs.clear()
    return out


def _ring(dev, mesh):
    """(b4) ring attention at [2, 7600, 4, 32] in bf16 and fp32 against K2
    and the plain version on one card; the full-domain UNet forward with
    attention 'ring' against 'pallas', and which layers ran ring-sharded."""
    from sbgm_danra_tpu_torch.evaluate.full_domain import padded_dims
    from sbgm_danra_tpu_torch.models.unet import build_score_model
    from sbgm_danra_tpu_torch.ops import cuda_attention
    from sbgm_danra_tpu_torch.parallel import collectives as C
    from sbgm_danra_tpu_torch.parallel import ring_attention as ra

    out = {"route": None, "kernels": []}
    group = mesh.group("data")
    shape = K2_MAIN[0]
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(dev).manual_seed(31)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(3))
        out["route"] = C.route(group, q)
        blocks = ra.ring_self_attention(q, k, v, mesh)
        whole = C.all_gather(blocks, group, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            ra.ring_self_attention(q, k, v, mesh)
        torch.cuda.synchronize()
        ring_ms = (time.perf_counter() - t0) / 3 * 1e3
        row = dict(shape=list(shape), dtype=dtype_name(dtype), ring_ms=ring_ms,
                   tolerance=RING_TOL[dtype_name(dtype)])
        if mesh.rank == 0:  # TF32 is off for cuBLAS by PyTorch's default
            ref = cuda_attention.flash_attention_reference(q.float(), k.float(), v.float())
            k2 = cuda_attention.flash_attention_cuda(q, k, v)
            err = (whole.float() - ref).abs()
            if dtype == torch.bfloat16:
                bound = 2 ** -8 * ref.abs() + 2 ** -8 * ref.abs().max()
            else:
                bound = 2e-5 + 2e-5 * ref.abs()
            row.update(max_abs_err=err.max().item(), worst_err_over_tolerance=(err / bound).max()
                       .item(), vs_k2_max_abs=(whole.float() - k2.float()).abs().max().item(),
                       k2_ms=cuda_ms(lambda: cuda_attention.flash_attention_cuda(q, k, v), 10))
        out["kernels"].append(row)
    hw = padded_dims(*FULL_DOMAIN)
    batch = train_batches(torch, 1, 1, FULL_DOMAIN, dev, seed=32)[0]
    t = torch.full((1,), 0.4, device=dev)
    cond = {k: batch[k] for k in ("y", "cond_img", "lsm_cond", "topo_cond")}
    models = {b: build_score_model(flagship_spec(compute_dtype="bfloat16", attention_backend=b),
                                   generator=torch.Generator().manual_seed(0)).to(dev).eval()
              for b in ("ring", "pallas")}
    ra.reset_ring_stats(models["ring"])
    with torch.no_grad():
        with ra.ring_context(mesh):
            got = models["ring"](batch["x"], t, **cond)
        ref = models["pallas"](batch["x"], t, **cond)
    out.update(full_domain_hw=list(hw), forward_rel_err=_rel(got, ref),
               forward_finite=bool(torch.isfinite(got).all()),
               ring_stats=ra.ring_stats(models["ring"]))
    return out


def _tp(dev, mesh_tp, mesh_dp):
    """(b5) TP on {model: 2}: the flagship 128-px forward against the
    unsharded one, the sharded fraction, and one DP+TP step against flat DP."""
    from sbgm_danra_tpu_torch.models.unet import build_score_model
    from sbgm_danra_tpu_torch.parallel import tp
    from sbgm_danra_tpu_torch.parallel.train import make_parallel_steps
    from sbgm_danra_tpu_torch.sde import VESDE, dsm_draws
    from sbgm_danra_tpu_torch.training.state import create_train_state

    def flagship():
        return build_score_model(flagship_spec(compute_dtype="bfloat16"),
                                 generator=torch.Generator().manual_seed(0))

    batch = train_batches(torch, 1, PAR_TP_BATCH, SERVE_HW, dev, seed=33)[0]
    cond = {k: batch[k] for k in ("y", "cond_img", "lsm_cond", "topo_cond")}
    t = torch.linspace(0.1, 0.9, PAR_TP_BATCH, device=dev)
    model = flagship().to(dev).eval()
    fraction = tp.sharded_param_fraction(model)
    with torch.no_grad():
        ref = model(batch["x"], t, **cond)
        specs = tp.shard_params(model, mesh_tp)
        got = model(batch["x"], t, **cond)
    parts = sum(p.numel() for p in tp.sharded_parts(model))
    out = dict(sharded_param_fraction=fraction, forward_rel_err=_rel(got, ref),
               forward_bit_identical=bool(torch.equal(got, ref)),
               sharded_weights=sum(1 for s in specs.values() if s), part_elements=parts)
    del model
    with tempfile.TemporaryDirectory() as tmp:
        cfg = train_config(tmp, "bfloat16", "xla", False)
        tz = dsm_draws(batch["x"], torch.Generator(dev).manual_seed(34))
        for name, mesh, use_tp in (("flat_dp", mesh_dp, False), ("dp_tp", mesh_tp, True)):
            model = flagship()  # the state made on the CPU, then moved, as the trainer does
            state = create_train_state(cfg, model, torch.Generator().manual_seed(0))
            model.to(dev)
            state.to(dev)
            step, evaluate, state, shard = make_parallel_steps(model, VESDE(), cfg, state, mesh,
                                                               tp=use_tp)
            local = shard(batch)
            loss = step(state, local, t=tz[0], z=tz[1])["loss"].item()
            after = evaluate(state, local, t=tz[0], z=tz[1])["loss"].item()
            out[name] = dict(loss=loss, eval_after=after, rows=int(local["x"].shape[0]),
                             route=step.route)
            del model, state, step, evaluate
            torch.cuda.empty_cache()
    return out


def _windowed(dev, tmp, mesh):
    """(b6) the windowed stacks of the train split (one 22-day window),
    day-sharded, sampled per rank, each row checked against the rank's own
    days of the whole window, and one DP step on them."""
    from sbgm_danra_tpu_torch.data.factory import make_dataset
    from sbgm_danra_tpu_torch.data.windowed_data import WindowedDeviceLoader
    from sbgm_danra_tpu_torch.parallel import windowed_dp as wdp
    from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline

    cfg = data_config(tmp, fused_steps=0)  # a mesh trains one step a dispatch
    loader = WindowedDeviceLoader(make_dataset(cfg, "train"), batch_size=cfg.training.batch_size,
                                  window_days=PAR_WINDOW_DAYS, device=dev)
    whole = loader.buffers()
    fields, statics, classifier = wdp.day_sharded_buffers(whole, mesh)
    n_days = fields.shape[0] * mesh.size
    sampler = wdp.make_dp_batch_sampler(
        mesh, n_days, loader.full_hw, loader.crop_hw, loader.cutout_domains,
        cfg.training.batch_size, cfg_dropout_prob=loader.cfg_dropout_prob, seed=cfg.training.seed)
    batch = sampler(0, 0, fields, statics, classifier)
    day, ox, oy, _ = sampler.draws(0, 0, dev)
    first = mesh.rank * fields.shape[0]
    ch, cw = loader.crop_hw
    own = torch.stack([whole[0][first + int(d), int(a):int(a) + ch, int(b):int(b) + cw, :1]
                       for d, a, b in zip(day, ox, oy)])
    rows_own = bool(torch.equal(batch["x"], own))
    keys = ("x", "y", "cond_img", "lsm_cond", "topo_cond", "sdf")
    pipe = TrainingPipeline(cfg, [], device=dev, mesh=mesh)
    loss = pipe._train_step(pipe.state, {k: batch[k] for k in keys if k in batch},
                            torch.Generator(dev).manual_seed(35))["loss"].item()
    out = dict(window_days=loader.window_days, days_a_rank=int(fields.shape[0]),
               trimmed_days=n_days, rows=int(batch["x"].shape[0]), rows_from_own_days=rows_own,
               local_days_drawn=sorted({int(d) for d in day}), loss=loss,
               first_param_sum=float(next(pipe.model.parameters()).double().sum()))
    del pipe, loader
    torch.cuda.empty_cache()
    return out


def parallel_gloo_rank(p):
    """(b) two gloo ranks on the one card (CUDA tensors, collectives staged
    through pinned host memory): the train-128 and full-domain DP steps
    against one device, the member-sharded ensemble, ring attention, TP and
    the day-sharded windows; each part's seconds."""
    dev = _par_setup()
    from sbgm_danra_tpu_torch.parallel import collectives as C
    from sbgm_danra_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": PAR_RANKS}, device=dev)
    mesh_tp = make_mesh({"data": 1, "model": PAR_RANKS}, device=dev)
    out, seconds = {"rank": mesh.rank, "backend": mesh.backend}, {}

    def part(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn(*args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        spec = TRAIN_128
        batch = train_batches(torch, 1, spec["batch"], spec["hw"], dev, seed=30)[0]
        part("train_128", _dp_step_vs_single, dev, tmp, mesh,
             train_config(tmp, "bfloat16", "xla", False), batch, 5, 3)
        grads = torch.zeros(p["n_params"], device=dev)  # the all-reduce of a step's gradients
        C.flat_all_reduce_mean([grads], mesh.world)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            C.flat_all_reduce_mean([grads], mesh.world)
        torch.cuda.synchronize()
        out["train_128"]["grad_all_reduce_s"] = (time.perf_counter() - t0) / 3
        # the same comparison in fp32 (TF32 off in both steps), at 8 rows a rank:
        # what the batch split costs without bf16's rounding
        small = train_batches(torch, 1, PAR_FP32_BATCH, spec["hw"], dev, seed=36)[0]
        part("train_128_fp32", _dp_step_vs_single, dev, tmp, mesh,
             train_config(tmp, "float32", "xla", False), small, 7, 0)
        full = train_batches(torch, 1, TRAIN_FULL["batch"], FULL_DOMAIN, dev, seed=40)[0]
        part("train_full_domain", _dp_step_vs_single, dev, tmp, mesh,
             train_config(tmp, "bfloat16", "pallas", True), full, 6, 0)
    part("ensemble", _ensemble, dev, mesh)
    part("ring", _ring, dev, mesh)
    part("tp", _tp, dev, mesh_tp, mesh)
    part("windowed", _windowed, dev, p["tmp"], mesh)
    out["seconds"] = seconds
    return out


def phase_parallel(dev, tmp):
    """The parallel layer (``sbgm_danra_tpu_torch/parallel/``) with its ranks
    as child processes of this script (``parallel.launch.spawn``: a
    rendezvous on a free localhost port, results back through files):

    a. NCCL, one rank: the flagship train-128 DP step (bf16, batch 128, Adam,
       EMA) on its CUDA graph, the all-reduce captured, against the
       single-device pipeline's step on its graph (same weights, batch, t and
       z): loss within ``PAR_LOSS_TOL``, parameters, BatchNorm statistics and
       EMA within ``STATE_DRIFT_TOL`` of what the step moved them; 5 timed
       steps of each;
    b. gloo, two ranks on the one card (CUDA tensors; NCCL refuses two ranks
       on one device), each step eager (gloo cannot be captured):
       - the same train-128 step, 64 rows a rank, against the single-device
         step at batch 128 (global-batch BatchNorm, the gradient mean: the
         loss, each gradient, the states), the host-staged all-reduce of the
         flagship's gradients alone, and the comparison again in fp32 at 8
         rows a rank (TF32 off), without bf16's rounding;
       - the full-domain DP step (608x800, 'pallas', remat, batch 2: one row a
         rank): 2 K2 forward and 1 backward launch on each rank, the loss
         against the single-device step;
       - the member-sharded ensemble (8 members at 128 px, 4 a rank,
         dpmpp-25, CFG w=3) on each rank's sampler graph against the one-card
         call of 8, K1 launches = 8 x 24 evaluations a rank, K1 against the
         plain chain at the rank's batch;
       - ring attention at [2, 7600, 4, 32] in bf16 and fp32 against the plain
         version and K2, the full-domain UNet with attention 'ring' against
         'pallas', and the layers that ran ring-sharded (every attention
         layer whose token count divides 2);
       - TP on {model: 2}: the flagship forward against the unsharded one,
         ``sharded_param_fraction``, one DP+TP step against flat DP;
       - windowed_dp: the 22 train days of ``train_data``'s stores as one
         window, 11 a rank, each rank's 64 rows from its own days, one DP
         step.
    """
    from sbgm_danra_tpu_torch.models.unet import build_score_model
    from sbgm_danra_tpu_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    n_params = sum(p.numel() for p in build_score_model(flagship_spec()).parameters())
    nccl = spawn("chip_smoke:parallel_nccl_rank", 1, {}, backend="nccl", device="cuda",
                 timeout=400, threads=4)[0]
    nccl_s = time.perf_counter() - t0
    ranks = spawn("chip_smoke:parallel_gloo_rank", PAR_RANKS, {"tmp": tmp, "n_params": n_params},
                  backend="gloo", device="cuda", timeout=600, threads=4)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    smi = nvidia_smi()

    # (a)
    a_median = float(np.median(nccl["step_s"]))
    a_single = float(np.median(nccl["single_step_s"]))
    emit(phase="parallel", part="nccl_one_rank", route=dict(backend=nccl["backend"],
         collectives=nccl["route_collectives"], graphs=nccl["route"]["graphs"]),
         loss=nccl["loss"], single_loss=nccl["single_loss"],
         loss_rel_diff=nccl["loss_rel_diff"], loss_tolerance=PAR_LOSS_TOL["nccl_graph"],
         state_drift=nccl["state_drift"], state_drift_tolerance=STATE_DRIFT_TOL,
         dp_step_s=nccl["step_s"], dp_step_s_median=a_median, single_step_s=nccl["single_step_s"],
         single_step_s_median=a_single, dp_over_single=a_median / a_single,
         grad_err_max=nccl["grad_err_max"], grad_err_worst=nccl["grad_err_worst"],
         single_repeat_grad_err_max=nccl["single_repeat_grad_err_max"],
         grad_tolerance=PAR_GRAD_TOL, nccl_collectives=nccl["nccl_collectives"],
         graph=nccl.get("graph"), card=smi)
    check(nccl["route"] == {"collectives": "nccl", "graphs": True},
          f"NCCL one-rank route {nccl['route']}")
    check(nccl["nccl_collectives"]["route"] == "nccl"
          and all(v for k, v in nccl["nccl_collectives"].items() if k != "route"),
          f"NCCL one-rank collectives: {nccl['nccl_collectives']}")
    check(nccl["loss_rel_diff"] <= PAR_LOSS_TOL["nccl_graph"]
          and nccl["grad_err_max"] <= PAR_GRAD_TOL
          and all(d["ratio"] <= STATE_DRIFT_TOL for d in nccl["state_drift"].values()),
          f"NCCL one-rank DP step vs single device: {nccl['loss_rel_diff']}, "
          f"{nccl['state_drift']}")

    # (b) train-128
    tr = [r["train_128"] for r in ranks]
    b_median = float(np.median(tr[0]["step_s"]))
    emit(phase="parallel", part="gloo_train_128", route=tr[0]["route"],
         rows_a_rank=[t["rows"] for t in tr], loss=[t["loss"] for t in tr],
         single_loss=tr[0]["single_loss"], loss_rel_diff=tr[0]["loss_rel_diff"],
         loss_tolerance=PAR_LOSS_TOL["gloo_eager"], grad_err_max=tr[0]["grad_err_max"],
         grad_err_worst=tr[0]["grad_err_worst"], grad_err_median=tr[0]["grad_err_median"],
         single_repeat_grad_err_max=tr[0]["single_repeat_grad_err_max"],
         single_repeat_grad_err_median=tr[0]["single_repeat_grad_err_median"],
         grad_tolerance=PAR_GRAD_TOL, state_drift=tr[0]["state_drift"],
         state_drift_tolerance=PAR_DRIFT_TOL,
         step_s=tr[0]["step_s"], step_s_median=b_median, single_eager_step_s=tr[0][
             "single_step_s"], grad_all_reduce_s=[t["grad_all_reduce_s"] for t in tr],
         grad_elements=n_params, all_reduce_share=tr[0]["grad_all_reduce_s"] / b_median)
    check(all(t["route"] == {"collectives": "gloo-host-staged", "graphs": False} for t in tr),
          f"gloo route {[t['route'] for t in tr]}")
    check(tr[0]["loss"] == tr[1]["loss"] and tr[0]["loss_rel_diff"] <= PAR_LOSS_TOL["gloo_eager"]
          and tr[0]["grad_err_max"] <= PAR_GRAD_TOL
          and tr[0]["state_drift"]["bn_stats"]["ratio"] <= STATE_DRIFT_TOL
          and all(d["ratio"] <= PAR_DRIFT_TOL for d in tr[0]["state_drift"].values()),
          f"gloo train-128 DP vs single device: {tr}")

    f32 = [r["train_128_fp32"] for r in ranks]
    emit(phase="parallel", part="gloo_train_128_fp32", route=f32[0]["route"],
         rows_a_rank=[f["rows"] for f in f32], loss=[f["loss"] for f in f32],
         single_loss=f32[0]["single_loss"], loss_rel_diff=f32[0]["loss_rel_diff"],
         grad_err_max=f32[0]["grad_err_max"], grad_err_worst=f32[0]["grad_err_worst"],
         grad_err_median=f32[0]["grad_err_median"],
         single_repeat_grad_err_max=f32[0]["single_repeat_grad_err_max"],
         grad_tolerance=PAR_GRAD_TOL_FP32, state_drift=f32[0]["state_drift"])
    check(f32[0]["loss"] == f32[1]["loss"] and f32[0]["loss_rel_diff"] <= 1e-5
          and f32[0]["grad_err_max"] <= PAR_GRAD_TOL_FP32,
          f"gloo fp32 train-128 DP vs single device: {f32[0]}")

    # (b) full domain
    fd = [r["train_full_domain"] for r in ranks]
    emit(phase="parallel", part="gloo_train_full_domain", route=fd[0]["route"],
         rows_a_rank=[f["rows"] for f in fd], loss=[f["loss"] for f in fd],
         single_loss=fd[0]["single_loss"], loss_rel_diff=fd[0]["loss_rel_diff"],
         loss_tolerance=PAR_LOSS_TOL["full_domain"], grad_err_max=fd[0]["grad_err_max"],
         grad_err_worst=fd[0]["grad_err_worst"], grad_err_median=fd[0]["grad_err_median"],
         single_repeat_grad_err_max=fd[0]["single_repeat_grad_err_max"],
         grad_tolerance=PAR_GRAD_TOL,
         k2_fwd_by_rank=[f["k2_fwd"] for f in fd], k2_bwd_by_rank=[f["k2_bwd"] for f in fd],
         k2_fwd_by_variant=fd[0]["k2_fwd_by_variant"])
    check(all(f["k2_fwd"] == 2 and f["k2_bwd"] == 1 and f["k2_fwd_by_variant"]["tc_bf16"] == 2
              for f in fd), f"full-domain DP step K2 launches {fd}")
    check(fd[0]["loss"] == fd[1]["loss"] and fd[0]["loss_rel_diff"] <= PAR_LOSS_TOL["full_domain"]
          and fd[0]["grad_err_max"] <= PAR_GRAD_TOL,
          f"full-domain DP step vs single device: {fd}")

    # (b) ensemble
    en = [r["ensemble"] for r in ranks]
    emit(phase="parallel", part="gloo_ensemble", members=PAR_ENSEMBLE,
         members_a_rank=en[0]["members_a_rank"], k1_launches_by_rank=[e["k1_launches"] for e in en],
         unet_evaluations=en[0]["unet_evaluations"], rows_rel_err=en[0]["rows_rel_err"],
         rows_tolerance=PAR_ROWS_TOL, rows_bit_identical=en[0]["rows_bit_identical"],
         wall_s=[e["wall_s"] for e in en], one_card_wall_s=en[0]["one_card_wall_s"],
         k1_vs_plain=[e["k1_vs_plain"] for e in en], distinct_members=en[0]["distinct_members"])
    for rank, e in enumerate(en):
        check_k1(tuple(e["k1_launches"]), GEN_STEPS - 1, f"ensemble rank {rank} (replay)")
        check_k1_forward(e["k1_vs_plain"], f"ensemble rank {rank}'s UNet at its batch")
        check(e["finite"] and e["shape"] == [PAR_ENSEMBLE, *SERVE_HW, 1],
              f"ensemble rank {rank}: {e['shape']} finite {e['finite']}")
    check(en[0]["rows_rel_err"] <= PAR_ROWS_TOL and en[0]["distinct_members"] == PAR_ENSEMBLE,
          f"sharded ensemble vs one card: {en[0]['rows_rel_err']}")

    # (b) ring
    ring = r0["ring"]
    ring_layers = {k: v for k, v in ring["ring_stats"].items()}
    even = {k for k, v in ring_layers.items() if v["tokens"] % PAR_RANKS == 0}
    emit(phase="parallel", part="gloo_ring", hop=ring["route"], kernels=ring["kernels"],
         full_domain_hw=ring["full_domain_hw"], forward_rel_err=ring["forward_rel_err"],
         forward_tolerance=K1_FWD_TOL["bfloat16"], ring_layers=ring_layers,
         ring_sharded=sorted(k for k, v in ring_layers.items() if v["ring"]))
    check(ring["route"] == "gloo-host-staged", f"ring hop route {ring['route']}")
    check(all(row["worst_err_over_tolerance"] <= 1 for row in ring["kernels"]),
          f"ring attention vs the plain version: {ring['kernels']}")
    check(ring["forward_finite"] and ring["forward_rel_err"] <= K1_FWD_TOL["bfloat16"],
          f"full-domain 'ring' forward vs 'pallas': {ring['forward_rel_err']}")
    check(even and all((v["ring"], v["dense"]) == ((1, 0) if k in even else (0, 1))
                       for k, v in ring_layers.items()), f"ring-sharded layers {ring_layers}")

    # (b) TP
    tps = [r["tp"] for r in ranks]
    emit(phase="parallel", part="gloo_tp", mesh={"data": 1, "model": PAR_RANKS},
         sharded_param_fraction=tps[0]["sharded_param_fraction"],
         expected_fraction=TP_FLAGSHIP_FRACTION, forward_rel_err=[t["forward_rel_err"] for t in tps],
         forward_bit_identical=[t["forward_bit_identical"] for t in tps],
         sharded_weights=tps[0]["sharded_weights"], part_elements=tps[0]["part_elements"],
         flat_dp=tps[0]["flat_dp"], dp_tp=tps[0]["dp_tp"],
         dp_tp_loss_rel_diff=abs(tps[0]["dp_tp"]["loss"] - tps[0]["flat_dp"]["loss"])
         / abs(tps[0]["flat_dp"]["loss"]), loss_tolerance=PAR_LOSS_TOL["tp"])
    for t in tps:
        check(t["sharded_param_fraction"] == TP_FLAGSHIP_FRACTION,
              f"sharded fraction {t['sharded_param_fraction']}")
        check(t["forward_rel_err"] <= 1e-3, f"TP forward vs unsharded {t['forward_rel_err']}")
        for key in ("loss", "eval_after"):
            rel = abs(t["dp_tp"][key] - t["flat_dp"][key]) / abs(t["flat_dp"][key])
            check(rel <= PAR_LOSS_TOL["tp"], f"DP+TP {key} vs flat DP: {rel}")

    # (b) windowed
    wd = [r["windowed"] for r in ranks]
    emit(phase="parallel", part="gloo_windowed_dp", window_days=wd[0]["window_days"],
         days_a_rank=wd[0]["days_a_rank"], rows_a_rank=[w["rows"] for w in wd],
         rows_from_own_days=[w["rows_from_own_days"] for w in wd],
         local_days_drawn=[w["local_days_drawn"] for w in wd], loss=[w["loss"] for w in wd])
    check(all(w["rows_from_own_days"] and w["rows"] == 64 for w in wd)
          and wd[0]["loss"] == wd[1]["loss"] and np.isfinite(wd[0]["loss"])
          and wd[0]["first_param_sum"] == wd[1]["first_param_sum"],
          f"windowed DP: {wd}")

    emit(phase="parallel", part="timing", wall_s=wall, nccl_s=nccl_s,
         gloo_rank_seconds=[r["seconds"] for r in ranks],
         routes={"nccl_one_rank": "nccl, captured (CUDA graphs)",
                 "gloo_two_ranks": "gloo-host-staged, eager",
                 "ring_hop": ring["route"]})
    return {"ensemble": [e["k1_launches"][0] for e in en],
            "ensemble_gn": [e["k1_launches"][1] for e in en],
            "train_full_domain": [f["k2_fwd"] for f in fd],
            "train_full_domain_bwd": [f["k2_bwd"] for f in fd]}


def _plain_k2():
    """Swap the plain attention (autograd through the dense fp32 version) in
    for K2 (restore by calling the result)."""
    from sbgm_danra_tpu_torch.ops import cuda_attention, flash_attention as fa

    fa.flash_attention_cuda = cuda_attention.flash_attention_reference
    return lambda: setattr(fa, "flash_attention_cuda", cuda_attention.flash_attention_cuda)


def _step_grads(pipe, batch, t, z, step=None):
    """One train step (``step``, by default the pipeline's eager step) from
    the pipeline's current state; returns the loss, the gradients it applied,
    and the state as it was before (restore with ``_restore``)."""
    import copy

    saved = (_snapshot(pipe.state), copy.deepcopy(pipe.state.optimizer.state_dict()),
             pipe.state.step)
    loss = (step or pipe.eager_train_step)(pipe.state, batch, t=t, z=z)["loss"].item()
    grads = {n: p.grad.detach().float().clone() for n, p in pipe.model.named_parameters()}
    return loss, grads, saved


def _grad_parts(grads):
    """Each parameter's gradient, a fused qkv projection's as its q, k and v
    parts (a fault in dq or dk is small beside dv's share of the whole), less
    the key bias, whose gradient is 0 in exact arithmetic: softmax takes no
    shift of a row's scores."""
    out = {}
    for n, g in grads.items():
        if not n.endswith(("qkv.weight", "qkv.bias")):
            out[n] = g
            continue
        for part, chunk in zip("qkv", g.chunk(3)):
            if not (part == "k" and n.endswith("bias")):
                out[f"{n}[{part}]"] = chunk
    return out


def _restore(pipe, saved):
    (model_sd, ema), opt, step = saved
    pipe.model.load_state_dict(model_sd)
    with torch.no_grad():
        for k, v in pipe.state.ema_params.items():
            v.copy_(ema[k])
    pipe.state.optimizer.load_state_dict(opt)
    pipe.state.step = step


def phase_train_full_domain(dev, dtype: str, steps: int, compare: bool):
    """The flagship trained at the padded full domain (589x789 -> 608x800),
    batch 2, attention 'pallas', remat, through ``TrainingPipeline`` on the
    step's CUDA graph: a first step (the capture), then ``steps`` replays, each
    with 2 K2 forward launches (forward and the remat recompute, decoder block
    1 at [2, 7600, 4, 32]) and 1 K2 backward; the loss finite. With
    ``compare``, from one saved state: the graph's step against the eager step
    (same t and z), and the eager step with K2 swapped for the plain attention
    (forward and backward): the loss and every parameter's gradient against
    the kernel step's."""

    from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline

    spec = TRAIN_FULL
    variant = K2_VARIANT[getattr(torch, dtype)]
    with tempfile.TemporaryDirectory() as tmp:
        pipe = TrainingPipeline(train_config(tmp, dtype, "pallas", True), [], device=dev)
        batches = train_batches(torch, steps + 1, spec["batch"], spec["hw"], dev, seed=40)
        pipe.train_loader = OnCard(batches[:1])
        _, capture_step_s = timed(lambda: pipe.train_batches(1))  # the step graph's capture
        loader = TimedBatches(batches[1:])
        pipe.train_loader = loader
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launch_counts.reset()  # the full-domain training path's run starts here: graph replays
        loss = pipe.train_batches(steps)
        k1c, k2f, k2b = k1_counts(), k2_counts(), k2_counts("bwd")
        peak = torch.cuda.max_memory_allocated() / 1e9
        step_s = loader.step_s()
        stats = graph_stats("train step")
        cmp, vs_eager = {}, {}
        if compare:
            g = torch.Generator(dev).manual_seed(50)
            t = torch.rand(spec["batch"], generator=g, device=dev) * (1 - 1e-3) + 1e-3
            z = torch.randn(batches[0]["x"].shape, generator=g, device=dev)
            # the graph's step against the eager step from one state, same t and z
            loss_g, grads_g, saved = _step_grads(pipe, batches[0], t, z, step=pipe._train_step)
            _restore(pipe, saved)
            launch_counts.reset()
            _, eager_s = timed(lambda: _step_grads(pipe, batches[0], t, z))
            eager_k2 = (k2_counts()[variant], k2_counts("bwd")[variant])
            _restore(pipe, saved)
            loss_k, grads_k, _ = _step_grads(pipe, batches[0], t, z)
            _restore(pipe, saved)
            grad_diff = max((grads_g[n] - grads_k[n]).abs().max().item() for n in grads_k)
            vs_eager = dict(loss_graph=loss_g, loss_eager=loss_k,
                            loss_rel_diff=abs(loss_g - loss_k) / abs(loss_k),
                            bit_identical=bool(loss_g == loss_k and all(
                                torch.equal(grads_g[n], grads_k[n]) for n in grads_k)),
                            grad_max_abs_diff=grad_diff,
                            grad_max_abs=max(v.abs().max().item() for v in grads_k.values()),
                            tolerance=f"loss within {GRAPH_TOL[dtype]} relative",
                            eager_step_s=eager_s, eager_k2_fwd_bwd=list(eager_k2))
            # the eager step with K2 against the same step with the plain attention
            restore = _plain_k2()
            try:
                loss_p, grads_p, _ = _step_grads(pipe, batches[0], t, z)
            finally:
                restore()
            parts_k, parts_p = _grad_parts(grads_k), _grad_parts(grads_p)
            rel = {n: ((parts_k[n] - parts_p[n]).abs().max()
                       / parts_p[n].abs().max().clamp_min(1e-30)).item() for n in parts_p}
            worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
            # reported only: the largest gradient difference against the largest gradient
            overall = max((grads_k[n] - grads_p[n]).abs().max().item() for n in grads_p) / max(
                grads_p[n].abs().max().item() for n in grads_p)
            cmp = dict(loss_kernel=loss_k, loss_plain=loss_p,
                       loss_rel_err=abs(loss_k - loss_p) / abs(loss_p),
                       grad_rel_err_max=max(rel.values()),
                       grad_rel_err_median=float(np.median(list(rel.values()))),
                       grad_rel_err_worst=worst, grad_rel_err_overall=overall)
    median = float(np.median(step_s))
    per_step = {"k2_fwd": k2f[variant] / steps, "k2_bwd": k2b[variant] / steps}
    emit(phase="train_full_domain", settings=f"flagship UNet, {dtype}, 589x789 -> 608x800, "
         "batch 2, attention 'pallas', remat, Adam lr 5e-4, EMA 0.999", steps=steps,
         route="CUDA graph of the step (the comparisons on the eager step)",
         mean_loss=loss, finite=bool(np.isfinite(loss)), capture_step_s=capture_step_s,
         graph=stats, graph_vs_eager=vs_eager, step_s=step_s, step_s_median=median,
         samples_per_s=spec["batch"] / median, peak_memory_gb=peak, k1_launches=list(k1c),
         k2_launches_by_variant=k2f, k2_bwd_launches_by_variant=k2b,
         k2_launches_per_step=per_step, kernel_vs_plain_attention=cmp,
         tolerance=f"loss within 1e-2, each parameter's gradient (q, k, v of a fused "
                   f"projection apart) within {GRAD_REL_TOL} of its max |ref| (bf16: the "
                   "kernel rounds P to bf16 for P.V)")
    check(np.isfinite(loss), f"full-domain train loss {loss}")
    check(per_step == {"k2_fwd": 2, "k2_bwd": 1} and k1c == (0, 0),
          f"full-domain train: K2 per step {per_step}, K1 {k1c}; expected 2 + 1 and no K1")
    check(stats and all(g["launches_per_replay"] == {
        f"flash_attention_fwd_{variant}": 2, f"flash_attention_bwd_{variant}": 1}
        for g in stats), f"full-domain train step graph launches {stats}")
    if compare:
        check(cmp["loss_rel_err"] <= 1e-2 and cmp["grad_rel_err_max"] <= GRAD_REL_TOL,
              f"full-domain train step, kernel vs plain attention: {cmp}")
        check(vs_eager["loss_rel_diff"] <= GRAPH_TOL[dtype] and vs_eager["eager_k2_fwd_bwd"]
              == [2, 1], f"full-domain train step, graph vs eager: {vs_eager}")
    return {"k2_bwd": k2b[variant], "k2_fwd": k2f[variant], "step_s_median": median}


CORRDIFF = dict(hw=(448, 448), members=8, evaluations=34)  # portbench/workloads/corrdiff-448-ens


def phase_corrdiff(dev):
    """CorrDiff's generation at its published widths (the cell's call), its
    kernels' launches read from a call after a reset: the regression's eager
    evaluation plus one replay of the residual's sampler graph."""
    import gc

    from sbgm_danra_tpu_torch.evaluate.corrdiff import generate
    from sbgm_danra_tpu_torch.models.songunet import SongUNetSpec, UNetBlock, build_corrdiff

    (h, w), members, evals = CORRDIFF["hw"], CORRDIFF["members"], CORRDIFF["evaluations"]
    spec = SongUNetSpec(cond_channels=6, img_resolution=h, compute_dtype="bfloat16")
    with torch.device(dev):
        net = build_corrdiff(spec, generator=torch.Generator(dev).manual_seed(0))
    blocks = [m for m in net.residual.modules() if isinstance(m, UNetBlock)]
    per_eval = {"k1": len(blocks), "group_norm": len(blocks) + sum(b.attention for b in blocks) + 1}
    gen = torch.Generator(dev).manual_seed(9)
    cond = {k: torch.randn(1, h, w, 2, generator=gen, device=dev)
            for k in ("cond_img", "lsm_cond", "topo_cond")}

    def call(seed):
        return timed(lambda: generate(net, cond, members, torch.Generator(dev).manual_seed(seed)))

    _, capture_call_s = call(1)  # the regression, the sampler's warm-up and capture, a replay
    launch_counts.reset()  # the main path's run starts here: the regression eagerly, one replay
    out, call_s = call(2)
    counts = {name: launch_counts.counts[name] for name in (
        "group_norm", "group_norm_stats", "conv3x3_stats", "conv3x3_stats_sample_bias", "gn_apply")}
    stats = graph_stats(f"edm_sampler {members}x{h}x{w}x1")
    per_replay = stats[-1]["launches_per_replay"] if stats else {}
    expected_replay = {name: evals * per_eval["k1" if name.startswith(("conv", "gn_")) else
                                              "group_norm"] for name in counts}
    expected = {name: n + n // evals for name, n in expected_replay.items()}
    finite = bool(np.isfinite(out).all())
    emit(phase="corrdiff", hw=[h, w], members=members, shape=list(out.shape), finite=finite,
         per_eval=per_eval, launches=counts, expected=expected, graph=stats,
         capture_call_s=capture_call_s, call_s=call_s, fields_per_s=out.shape[0] / call_s)
    check(out.shape == (members, h, w) and finite, f"bad CorrDiff output {out.shape}")
    check(per_eval == {"k1": 55, "group_norm": 62}, f"CorrDiff's nets per evaluation {per_eval}")
    check(len(stats) == 1 and all(per_replay.get(k) == n for k, n in expected_replay.items()),
          f"CorrDiff graph launches {stats}, expected {expected_replay} a replay")
    check(counts == expected, f"CorrDiff call launches {counts}, expected {expected}")
    del net, out, stats
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        payload = json.loads(resp.read())
    return payload, time.perf_counter() - t0


def phase_serving(dev):
    """The serving engine with the flagship_synth settings on its graph (one
    replay per dispatch at the member capacity 8): behind the HTTP handler,
    /healthz, three concurrent /generate requests (1, 2 and 4 members), then
    each again alone, which must come back bit-identical; K1 launches = the
    graph's per replay x dispatches. Then the same three requests on the
    engine's eager loop (``capture=False``) against the graph engine's, both
    called directly: latency and max |diff|."""
    from sbgm_danra_tpu_torch.models.unet import build_score_model
    from sbgm_danra_tpu_torch.serve import FLAGSHIP_SYNTH, InferenceEngine, make_handler

    weights = build_score_model(FLAGSHIP_SYNTH.spec, generator=torch.Generator().manual_seed(1))
    engine = InferenceEngine(FLAGSHIP_SYNTH, weights.state_dict(), dev, max_members=8)
    warm_s = engine.warmup()  # the dispatch graph's capture
    stats = graph_stats("dpmpp_sampler 8x128x128")
    per_replay = stats[0]["launches_per_replay"] if stats else {}
    launch_counts.reset()  # the serving path's run starts here: one replay per dispatch
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(0)
    hw = FLAGSHIP_SYNTH.sample_hw
    mask = np.ones((*hw, 1), np.float32)
    conditions = {
        "y": 2,
        "cond_img": rng.normal(size=(*hw, 2)).astype(np.float32).tolist(),
        "lsm_cond": np.concatenate([(rng.random((*hw, 1)) > 0.5), mask], -1)
        .astype(np.float32).tolist(),
        "topo_cond": np.concatenate([rng.normal(size=(*hw, 1)), mask], -1)
        .astype(np.float32).tolist(),
    }
    requests = [(1, 11), (2, 12), (4, 13)]
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        check(health["status"] == "ok" and health["platform"] == "cuda", f"healthz {health}")
        results = {}

        def client(n, seed):
            results[n] = _post(base + "/generate",
                               {"conditions": conditions, "n_members": n, "seed": seed})

        threads = [threading.Thread(target=client, args=r) for r in requests]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        check(all(not th.is_alive() for th in threads) and len(results) == 3,
              "concurrent requests did not all finish")
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        alone = {n: _post(base + "/generate",
                          {"conditions": conditions, "n_members": n, "seed": seed})
                 for n, seed in requests}
        dispatches = engine.n_dispatches
        counts = k1_counts()
        direct = {n: timed(lambda n=n, seed=seed: engine.generate(conditions, n, seed))
                  for n, seed in requests}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        engine.close()
    eager_engine = InferenceEngine(FLAGSHIP_SYNTH, weights.state_dict(), dev, max_members=8,
                                   capture=False)
    try:
        eager_warm_s = eager_engine.warmup()
        launch_counts.reset()
        eager = {n: timed(lambda n=n, seed=seed: eager_engine.generate(conditions, n, seed))
                 for n, seed in requests}
        eager_counts = k1_counts()
    finally:
        eager_engine.close()

    arrays = {n: np.asarray(results[n][0]["generated"], np.float32) for n, _ in requests}
    shapes_ok = all(arrays[n].shape == (n, *hw) for n, _ in requests)
    finite = all(np.isfinite(a).all() for a in arrays.values())
    repeats = {n: np.asarray(alone[n][0]["generated"], np.float32) for n, _ in requests}
    identical = all(np.array_equal(repeats[n], arrays[n]) for n, _ in requests)
    vs_eager = {str(n): compare(direct[n][0], eager[n][0], GRAPH_TOL["bfloat16"])
                for n, _ in requests}
    evaluations = dispatches * per_replay.get("conv3x3_stats", 0) // K1_PER_EVAL
    emit(phase="serving", settings="flagship_synth: 128x128, dpmpp-25, CFG w=3, bf16",
         route="CUDA graph per dispatch (sampling/graphs.py), then the eager loop",
         max_members=8, warmup_s=warm_s, graph=stats,
         latency_s={str(n): results[n][1] for n, _ in requests},
         latency_alone_s={str(n): alone[n][1] for n, _ in requests},
         shapes_ok=shapes_ok, finite=finite, repeat_bit_identical=identical,
         repeat_max_abs_diff=max(float(np.abs(repeats[n] - arrays[n]).max()) for n, _ in requests),
         n_dispatches_concurrent=health["n_dispatches"],
         mean_rows_per_dispatch=health["mean_rows_per_dispatch"],
         dispatches=dispatches, unet_evaluations=evaluations, k1_launches=list(counts),
         direct_latency_s={str(n): direct[n][1] for n, _ in requests},
         eager_warmup_s=eager_warm_s,
         eager_direct_latency_s={str(n): eager[n][1] for n, _ in requests},
         eager_k1_launches=list(eager_counts), graph_vs_eager=vs_eager)
    check(shapes_ok and finite, "serving returned bad shapes or non-finite values")
    check(identical, "requests repeated alone did not reproduce their concurrent results")
    check(dispatches > 0 and len(stats) == 1, f"serving: {dispatches} dispatches, graphs {stats}")
    check_k1(counts, evaluations, "serving (graph replays)")
    check_k1(eager_counts, 3 * (FLAGSHIP_SYNTH.sampler.num_steps - 1), "serving (eager loop)")
    check(all(v["within"] for v in vs_eager.values()), f"serving graph vs eager: {vs_eager}")
    return {"conv3x3_stats": counts[0], "gn_apply": counts[1],
            "eager": {"conv3x3_stats": eager_counts[0], "gn_apply": eager_counts[1]}}


def phase_samplers(dev, model):
    """pc (the bench headline), em and the probability-flow ODE at 128 px, each
    on its graph (``sampling/graphs.py``: the first call captures, the second
    replays with K1 launches = 8 x its score evaluations) and on the eager
    loop from the same generator seed, which counts the evaluations."""
    from sbgm_danra_tpu_torch.sampling import graphs
    from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig, get_sampler

    cond = make_cond(CONTRACT_BATCH, SERVE_HW, dev, 11)
    shape = (CONTRACT_BATCH, *SERVE_HW, 1)
    launches = {}
    for name, method in (("pc_sampler", "rk4"), ("em_sampler", "rk4"), ("ode_sampler", "rk4"),
                         ("ode_sampler", "heun")):
        config = SamplerConfig(num_steps=SAMPLER_STEPS, guidance_scale=3.0, ode_method=method)
        evaluations = [0]

        def score_fn(x, t, **c):
            evaluations[0] += 1
            return model(x, t, **c)

        label = name if name != "ode_sampler" else f"ode_sampler/{method}"

        def graph_call():
            return graphs.sample(name, model, torch.Generator(dev).manual_seed(12), shape,
                                 config=config, cond=cond)

        with torch.inference_mode():
            _, capture_call_s = timed(graph_call)  # warm-up, capture, one replay
            launch_counts.reset()  # this sampler's run starts here: a replay of its graph
            out, wall = timed(graph_call)
            counts = k1_counts()
            launch_counts.reset()
            eager, eager_wall = timed(lambda: get_sampler(name)(
                score_fn, torch.Generator(dev).manual_seed(12), shape, config=config, cond=cond))
            eager_counts = k1_counts()
        finite = bool(torch.isfinite(out).all())
        vs_eager = compare(out, eager, GRAPH_TOL["bfloat16"])
        stats = graph_stats(f"{name}{'/' + method if name == 'ode_sampler' else ''} "
                            f"{CONTRACT_BATCH}x")
        emit(phase="samplers", sampler=label, batch=CONTRACT_BATCH, steps=SAMPLER_STEPS,
             cfg=3.0, route="CUDA graph (sampling/graphs.py), then the eager loop",
             shape=list(out.shape), finite=finite, capture_call_s=capture_call_s, wall_s=wall,
             eager_wall_s=eager_wall, unet_evaluations=evaluations[0], k1_launches=list(counts),
             eager_k1_launches=list(eager_counts), graph=stats, graph_vs_eager=vs_eager,
             field_std=float(out.float().std()))
        check(tuple(out.shape) == shape and finite, f"{label}: bad output {tuple(out.shape)}")
        check_k1(counts, evaluations[0], f"{label} (graph replay)")
        check_k1(eager_counts, evaluations[0], f"{label} (eager loop)")
        check(vs_eager["within"], f"{label} graph vs eager: {vs_eager}")
        launches[label] = counts[0]
    graphs.clear()
    return launches


def _k1_summary(rows, kernel: str, dtype: str) -> dict:
    """A K1 kernel's numbers in ``dtype`` summed over the 8 chains of one
    full-domain UNet evaluation (batch 2); its largest error over every row of
    that dtype."""
    rows = [r for r in rows if r["dtype"] == dtype]
    by_shape = {(r["hw"][0], r["hw"][1], r["cin"], r["cout"]): r[kernel] for r in rows
                if r["path"] == "full-domain"}
    chains = [by_shape[c] for c in CHAINS_FULL]
    total = {key: sum(c[key] for c in chains)
             for key in ("ms", "kernel_ms", "plain_ms", "library_ms", "library_kernel_ms",
                         "bound_ms")}
    ops = sum(c["bound_ms"] for c in chains if c["bound_by"] == "operations")
    return dict(max_abs_err=max(r[kernel]["max_abs_err"] for r in rows), **total,
                bound_by="operations" if ops >= total["bound_ms"] / 2 else "bytes",
                library_ms_is=chains[0]["library"],
                at=f"sum over the 8 decoder chains of one 608x800 UNet evaluation, {dtype}, "
                   "batch 2")


def _k2_summary(rows, variant: str, mma: str, **launches) -> dict:
    """One K2 variant: its time, plain, library and bound at the full-domain
    shape in its dtype; its largest errors over every row of that variant."""
    mine = [r for r in rows if r["variant"] == variant]
    at = next(r for r in mine if r["shape"] == list(K2_MAIN[0]) and not r["packed_qkv_views"])
    return {
        "name": f"flash_attention_fwd_{variant}",
        "route": "cuda",
        "mma": mma,
        "source": "sbgm_danra_tpu_torch/csrc/flash_attention.cu",
        "replaces": "sbgm_danra_tpu/ops/pallas_attention.py:86",
        **launches,
        **{key: max(r[key] for r in mine) for key in (
            "max_abs_err", "max_abs_err_over_ref_max", "worst_err_over_tolerance")},
        **{key: at[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        # the SFU's exponentials are operations; bound_term says which term won
        "bound_by": "bytes" if at["bound_by"] == "bytes" else "operations",
        "bound_term": at["bound_by"],
        "at": f"{at['shape']} {at['dtype']}, decoder block 1 at 608x800",
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    # the port itself; fails here when the script is run outside a checkout
    from sbgm_danra_tpu_torch.ops import _nvcc, cuda_attention, fused_conv_gn, upsample

    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi, sfu = nvidia_smi(), sfu_rate(torch)
    emit(phase="device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi, **sfu,
         torch=torch.__version__, cuda=torch.version.cuda)

    modules = (cuda_attention, fused_conv_gn, upsample)
    start = t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:  # one nvcc per source, all at once
        builds = list(pool.map(lambda m: m.build_library(), modules))
    for built in builds:
        print(built.log, file=sys.stderr)
    build_s = time.perf_counter() - t0
    emit(phase="build", seconds=build_s, flags=" ".join(_nvcc.NVCC_FLAGS),
         libraries=[dict(source=m.SOURCE.name, library=b.path.name, compiled=b.compiled,
                         seconds=b.seconds) for m, b in zip(modules, builds)])

    seconds = {}  # wall seconds of each phase, the card synchronised at its end

    def run(name, phase, *args, **kw):
        t = time.perf_counter()
        out = phase(*args, **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t
        return out

    attention_rows = run("kernel", phase_attention_kernel, dev, sfu["exp_per_s"])
    bwd_rows = run("kernel_backward", phase_attention_backward, dev)
    k1_rows = run("kernel_k1", phase_conv_gn_kernel, dev)
    up_rows = run("kernel_upsample", phase_upsample_kernel, dev)
    run("kernel_k1_corrdiff", phase_corrdiff_k1, dev)
    gn_rows = run("kernel_group_norm", phase_group_norm_kernel, dev)
    model, serve_model, tiny_k2 = run("model", phase_model, dev)
    launches = run("full_domain", phase_full_domain, dev, model)
    del model
    torch.cuda.empty_cache()
    fp32 = run("fp32_full_width", phase_fp32_full_width, dev, launches["wall_s"])
    # training before serving: the serving engine sets cudnn.deterministic
    train_128 = run("train_128", phase_train_128, dev)
    with tempfile.TemporaryDirectory() as tmp:  # train_data's data and checkpoint
        train_data = run("train_data", phase_train_data, dev, tmp)
        generate = run("generate", phase_generate, dev, tmp)
        quality = run("quality", phase_quality, dev, tmp)
        data_prep = run("data_prep", phase_data_prep, dev, tmp)
        windowed = run("windowed", phase_windowed, dev, tmp)
        sweep = run("sweep", phase_sweep, dev, tmp)
        parallel = run("parallel", phase_parallel, dev, tmp)
    train_bf16 = run("train_full_domain_bf16", phase_train_full_domain, dev, "bfloat16",
                     TRAIN_FULL["steps"], compare=True)
    train_fp32 = run("train_full_domain_fp32", phase_train_full_domain, dev, "float32", 1,
                     compare=False)
    corrdiff = run("corrdiff", phase_corrdiff, dev)
    serving = run("serving", phase_serving, dev)
    samplers = run("samplers", phase_samplers, dev, serve_model)
    emit(phase="timing", build_s=build_s, phase_s=seconds,
         total_s=time.perf_counter() - start)

    # each kernel's launches on the path that runs it: bf16 full domain (and
    # serving and the samplers) for the bf16 kernels, fp32 full domain for
    # the 3xTF32 ones; the tiny fp32 UNet of the model phase is no main path
    k2 = launches["k2"]
    kernels = [
        _k2_summary(attention_rows, "tc_bf16", "mma.sync bf16", launches=k2["tc_bf16"],
                    launches_by_path={"full_domain": k2["tc_bf16"],
                                      "full_domain/eager": launches["eager"]["k2"]["tc_bf16"],
                                      "train_data/full_domain": train_data["k2"]["tc_bf16"],
                                      "generate/full_domain": generate["k2"]["tc_bf16"],
                                      **{f"quality/{k}": n for k, n in quality["k2"].items()},
                                      "fp32_full_domain": fp32["k2"]["tc_bf16"],
                                      "train_full_domain_tc_bf16": train_bf16["k2_fwd"],
                                      **{f"parallel/train_full_domain_rank{r}": n for r, n in
                                         enumerate(parallel["train_full_domain"])}}),
        _k2_summary(attention_rows, "fp32", "tf32x3 (mma.sync)", launches=fp32["k2"]["fp32"],
                    launches_by_path={"full_domain": k2["fp32"],
                                      "fp32_full_domain": fp32["k2"]["fp32"],
                                      "fp32_full_domain/eager": fp32["eager"]["k2"]["fp32"],
                                      "train_full_domain_fp32": train_fp32["k2_fwd"]},
                    launches_outside_main_path={"model/tiny_fp32_unet": tiny_k2["fp32"]}),
    ]
    for variant, run in (("tc_bf16", train_bf16), ("fp32", train_fp32)):
        at = next(r for r in bwd_rows if r["variant"] == variant and r["shape"] == [2, 7600, 4, 32])
        mine = [r for r in bwd_rows if r["variant"] == variant]
        kernels.append({
            "name": f"flash_attention_bwd_{variant}",
            "route": "cuda",
            "mma": "bf16 (mma.sync)" if variant == "tc_bf16" else "tf32x3 (mma.sync)",
            "source": "sbgm_danra_tpu_torch/csrc/flash_attention.cu",
            "replaces": "sbgm_danra_tpu/ops/pallas_attention.py:143",
            "launches": run["k2_bwd"],
            "launches_by_path": {f"train_full_domain_{variant}": run["k2_bwd"],
                                 **({f"parallel/train_full_domain_rank{r}": n for r, n in
                                     enumerate(parallel["train_full_domain_bwd"])}
                                    if variant == "tc_bf16" else {})},
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "worst_err_over_tolerance": max(r["worst_err_over_tolerance"] for r in mine),
            **{key: at[key] for key in ("ms", "kernel_ms", "kernel_ms_by_kernel", "plain_ms",
                                        "bound_ms", "library_ms")},
            "bound_by": "bytes" if at["bound_by"] == "bytes" else "operations",
            "bound_term": at["bound_by"],
            "at": f"{at['shape']} {at['dtype']}, decoder block 1 at 608x800, one backward "
                  "(delta, dk/dv, dq); max_abs_err is the largest gradient error over its "
                  "max |ref|",
        })
    for name in ("conv3x3_stats", "gn_apply"):
        kernels.append({
            "name": name,
            "route": "cuda",
            "mma": "wgmma bf16" if name == "conv3x3_stats" else None,
            "source": "sbgm_danra_tpu_torch/csrc/conv3x3_gn.cu",
            "replaces": "sbgm_danra_tpu/ops/fused_conv_gn.py:66",
            "launches": launches[name],
            "launches_by_path": {"full_domain": launches[name],
                                 "full_domain/eager": launches["eager"][name],
                                 "train_data/full_domain": train_data[name],
                                 **{f"generate/{mode}": generate[f"{mode}/{name}"]
                                    for mode in (*GEN_ARTIFACTS, "full_domain", "previews")},
                                 **{f"quality/{k.rsplit('/', 1)[0]}": n
                                    for k, n in quality.items() if k.endswith(f"/{name}")},
                                 "data_prep/generate_single": data_prep[name],
                                 "serving": serving[name],
                                 "serving/eager": serving["eager"][name],
                                 "train_128/ema_eval_step": train_128["eval_k1"][
                                     name == "gn_apply"],
                                 "windowed/eval_steps": windowed[name],
                                 **{f"samplers/{k}": v for k, v in samplers.items()},
                                 **{f"parallel/ensemble_rank{r}": n for r, n in enumerate(
                                     parallel["ensemble" if name == "conv3x3_stats"
                                              else "ensemble_gn"])}},
            **_k1_summary(k1_rows, name, "bfloat16"),
        })
        kernels.append({
            "name": f"{name}_fp32",
            "route": "cuda",
            "mma": "tf32x3 (wgmma)" if name == "conv3x3_stats" else None,
            "source": "sbgm_danra_tpu_torch/csrc/conv3x3_gn.cu",
            "replaces": "sbgm_danra_tpu/ops/fused_conv_gn.py:66",
            "launches": fp32[name],
            "launches_by_path": {"fp32_full_domain": fp32[name],
                                 "fp32_full_domain/eager": fp32["eager"][name],
                                 "sweep/eval_steps": sweep[name]},
            **_k1_summary(k1_rows, name, "float32"),
        })
    kernels.append({
        "name": "upsample2x",
        "route": "cuda",
        "mma": None,
        "source": "sbgm_danra_tpu_torch/csrc/upsample2x.cu",
        "replaces": "no TPU kernel: the plain chain of sbgm_danra_tpu_torch/ops/upsample.py "
                    "(XLA fuses sbgm_danra_tpu/ops/upsample.py's)",
        "launches": launches["upsample2x"],
        "launches_by_path": {"full_domain": launches["upsample2x"],
                             "full_domain/eager": launches["eager"]["upsample2x"]},
        "rows": [{key: r[key] for key in ("path", "shape", "dtype", "ms", "kernel_ms",
                                          "bound_ms", "roofline_pct", "plain_ms", "library_ms")}
                 for r in up_rows],
    })
    kernels.append({
        "name": "group_norm",
        "route": "cuda",
        "mma": None,
        "source": "sbgm_danra_tpu_torch/csrc/conv3x3_gn.cu",
        "replaces": "no TPU kernel: F.group_norm on CorrDiff's channels-last maps "
                    "(sbgm_danra_tpu_torch/models/songunet.py's GroupNorm, no JAX counterpart)",
        "launches": corrdiff["group_norm"],
        "launches_by_path": {"corrdiff": corrdiff["group_norm"]},
        "rows": [{key: r[key] for key in ("path", "shape", "dtype", "stats_kernel_ms",
                                          "stats_roofline_pct", "apply_kernel_ms",
                                          "apply_roofline_pct", "library_ms")}
                 for r in gn_rows],
    })
    kernels.append({
        "name": "group_norm_stats",
        "route": "cuda",
        "mma": None,
        "source": "sbgm_danra_tpu_torch/csrc/conv3x3_gn.cu",
        "replaces": "no TPU kernel: the statistics of F.group_norm on CorrDiff's channels-last "
                    "maps (timed in group_norm's rows)",
        "launches": corrdiff["group_norm_stats"],
        "launches_by_path": {"corrdiff": corrdiff["group_norm_stats"]},
    })
    check(all(k["launches"] > 0 for k in kernels),
          "a kernel was not launched on its path: " + str({k["name"]: k["launches"] for k in kernels}))
    emit(kernels=kernels)
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
