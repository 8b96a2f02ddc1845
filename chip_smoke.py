#!/usr/bin/env python3
"""Drive the torch port's generation paths once on one CUDA card and check them.

    python3 chip_smoke.py          # from the repo root; one CUDA GPU and nvcc

Phases, one JSON line each on stdout:

1. device: the card's name, count and power limit;
2. build: both CUDA sources of ``sbgm_danra_tpu_torch/csrc`` compiled with
   nvcc for sm_90a, in parallel, into ``sbgm_danra_tpu_torch/_build/``
   (nvcc's ``-Xptxas -v`` report on stderr);
3. kernel: each kernel against its plain PyTorch version on the card, with
   its time, the plain version's, the time of one PyTorch library call of the
   same function and the card's bound for the work:
   - K2 flash attention at the full-domain decoder shape and at padded-D /
     ragged-S / forced shapes (fp32: |err| <= 2e-5 + 2e-5 |ref| with TF32
     off; bf16: |err| <= 2e-2 against the fp32 plain version on the same
     bf16-rounded inputs);
   - K1 conv3x3 + GroupNorm (``conv3x3_stats`` then ``gn_apply``) at every
     decoder chain shape of the 128-px path (batch 16, bf16 and fp32), of the
     608x800 path (batch 2) and at the two ``perf_probe`` shapes (batch 26);
     tolerances in each row;
4. model: a tiny fp32 UNet on the card against the same weights on the CPU
   (TF32 off, attention kernel forced: max |err| <= 1e-4 max |ref|, with 8 K1
   launches), and flagship bf16 forwards at 128 px (batch 16) and 608x800
   (batch 2) against the same forward with the plain chain in place of K1 and,
   at 608x800, the plain attention in place of K2 (max |err| <= 5e-2 max |ref|);
5. full_domain: ``sample_full_domain`` 589x789 -> 608x800, EDM-18, CFG w=3,
   flagship bf16 UNet with attention backend 'pallas', seeded weights, two
   samples; each must be finite of shape (1, 589, 789) with exactly 34 K2 and
   272 K1 launches (8 per UNet evaluation, 2 x 17 evaluations);
6. serving: the engine with the flagship_synth settings behind the HTTP
   handler on a localhost port: /healthz, three concurrent /generate requests
   (1, 2 and 4 members), then each again alone, which must come back
   bit-identical; K1 launches = 8 x the UNet evaluations the dispatches ran;
7. samplers: at 128 px, flagship bf16 UNet, CFG w=3, batch 13 (the bench's
   contract batch), 10 steps: pc, em, ode rk4 and ode heun, each finite of the
   right shape with K1 launches = 8 x its score evaluations.

Each path's launch counts are set to 0 just before it runs and read just
after. Then the kernels' summary line, the ``nvidia-smi`` name and power limit
line, and ``{"ok": true, "device": {...}}`` as the last line. Any failure
raises and exits non-zero; without a CUDA device the script exits 1 and
prints nothing on stdout.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import numpy as np
import torch

FULL_DOMAIN = (589, 789)
EDM_NODES = 18
SERVE_HW = (128, 128)
CONTRACT_BATCH = 13  # bench.py's PC+CFG headline batch
SAMPLER_STEPS = 10
K1_PER_EVAL = 8  # decoder chains per UNet evaluation: 4 GroupNorm blocks x 2
# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores, fp32 CUDA cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
KERNEL_SHAPES = [  # (shape, dtype, through the dispatcher with the kernel forced)
    ((2, 7600, 4, 32), torch.bfloat16, False),  # decoder block 1 at 608x800
    ((2, 7600, 4, 32), torch.float32, False),
    ((2, 1000, 2, 24), torch.float32, False),  # padded head dim, ragged S
    ((2, 1000, 2, 24), torch.bfloat16, False),
    ((1, 4096, 4, 64), torch.float32, False),
    ((1, 4096, 4, 64), torch.bfloat16, False),
    ((1, 300, 4, 128), torch.float32, True),
    ((1, 300, 4, 128), torch.bfloat16, True),
]


# Decoder chains (H, W, Cin, Cout) of one flagship UNet evaluation, blocks 0-3,
# conv_up -> norm1 then conv -> norm2; block 3's two chains share a shape.
CHAINS_128 = [(8, 8, 512, 512), (8, 8, 512, 256), (16, 16, 256, 256), (16, 16, 256, 128),
              (32, 32, 128, 128), (32, 32, 128, 64), (64, 64, 64, 64), (64, 64, 64, 64)]
CHAINS_FULL = [(38, 50, 512, 512), (38, 50, 512, 256), (76, 100, 256, 256),
               (76, 100, 256, 128), (152, 200, 128, 128), (152, 200, 128, 64),
               (304, 400, 64, 64), (304, 400, 64, 64)]
K1_SHAPES = (  # (path, batch, (H, W, Cin, Cout), dtype, activation)
    [("serve-128", 16, c, torch.bfloat16, False) for c in dict.fromkeys(CHAINS_128)]
    + [("serve-128", 16, c, torch.float32, False) for c in dict.fromkeys(CHAINS_128)]
    + [("full-domain", 2, c, torch.bfloat16, False) for c in dict.fromkeys(CHAINS_FULL)]
    + [("perf_probe", 26, (64, 64, 64, 64), torch.bfloat16, False),
       ("perf_probe", 26, (32, 32, 128, 64), torch.bfloat16, False),
       ("perf_probe", 26, (64, 64, 64, 64), torch.bfloat16, True)]
)


def bound(flops: float, nbytes: float, dtype) -> dict:
    """The least time the card could take: operations at the dtype's peak or
    bytes at the memory rate, whichever is longer."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


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


def phase_attention_kernel(dev):
    from sbgm_danra_tpu_torch.ops import flash_attention as fa
    from sbgm_danra_tpu_torch.ops.cuda_attention import (
        flash_attention_cuda,
        flash_attention_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(dev).manual_seed(0)
    results = []
    for shape, dtype, forced in KERNEL_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
        if forced:
            fa._FORCE_KERNEL = True
            run = lambda: fa.flash_attention(q, k, v)  # noqa: E731
        else:
            run = lambda: flash_attention_cuda(q, k, v)  # noqa: E731
        try:
            out = run().float()
            torch.cuda.synchronize()
            ref = flash_attention_reference(q.float(), k.float(), v.float())
            err = (out - ref).abs()
            max_err = err.max().item()
            if dtype == torch.float32:
                ok = bool((err <= 2e-5 + 2e-5 * ref.abs()).all())
                tol = "2e-5 abs + 2e-5 rel"
            else:
                ok = max_err <= 2e-2
                tol = "2e-2 abs vs fp32 plain"
            ms = cuda_ms(run, 20)
        finally:
            fa._FORCE_KERNEL = False
        plain_ms = cuda_ms(lambda: flash_attention_reference(q.float(), k.float(), v.float()), 5)
        library_ms = cuda_ms(lambda: fa.dense_attention(q, k, v), 20)
        b, s_len, h, d = shape
        row = dict(phase="kernel", kernel="flash_attention_fwd", shape=list(shape),
                   dtype=str(dtype).split(".")[-1], forced_dispatch=forced,
                   max_abs_err=max_err, tolerance=tol, ok=ok, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, library="F.scaled_dot_product_attention",
                   **bound(4.0 * b * h * s_len * s_len * d,
                           4 * q.numel() * q.element_size(), dtype))
        emit(**row)
        check(ok, f"kernel disagrees with its plain version at {shape} {dtype}: {max_err}")
        results.append(row)
    return results


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
            conv_tol = "fp32, TF32 off: |err| <= 1e-4 max|ref| (summation order only)"
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
        ms_conv = cuda_ms(lambda: k1.conv3x3_stats(*args), 20)
        ms_apply = cuda_ms(lambda: k1.gn_apply(conv, stats, gamma, beta, groups,
                                               activation=act), 20)
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

        def lib_gn():
            y = F.group_norm(conv_nchw, groups, g_d, b_d, 1e-5)
            return torch.relu(y) if act else y

        lib_apply = cuda_ms(lib_gn, 20)
        es, pixels = x.element_size(), n * h * w
        flops = 2.0 * 9 * cin * cout * pixels
        conv_bytes = (pixels * (cin + cout) + 9 * cin * cout) * es + 4 * (cout + 2 * n * groups)
        apply_bytes = 2 * pixels * cout * es + 4 * (2 * n * groups + 2 * cout)
        row = dict(phase="kernel", kernel="conv3x3_gn", path=path, batch=n,
                   hw=[h, w], cin=cin, cout=cout, groups=groups,
                   dtype=str(dtype).split(".")[-1], activation=act,
                   conv3x3_stats=dict(max_abs_err=conv_err.max().item(), ok=conv_ok,
                                      tolerance=conv_tol, stats_rel_err=stats_rel,
                                      stats_ok=stats_ok, ms=ms_conv, plain_ms=plain_ms_conv,
                                      library_ms=lib_conv, library="F.conv2d",
                                      **bound(flops, conv_bytes, dtype)),
                   gn_apply=dict(max_abs_err=apply_err, ok=apply_ok, tolerance=out_tol,
                                 ms=ms_apply, plain_ms=plain_ms_apply, library_ms=lib_apply,
                                 library="F.group_norm" + (" + relu" if act else ""),
                                 **bound(4.0 * pixels * cout, apply_bytes, torch.float32)),
                   chain=dict(max_abs_err=chain_err, ok=chain_ok, tolerance=chain_tol,
                              ms=ms_conv + ms_apply,
                              plain_ms=plain_ms_conv + plain_ms_apply,
                              library_ms=lib_conv + lib_apply))
        emit(**row)
        check(conv_ok and stats_ok and apply_ok and chain_ok,
              f"K1 disagrees with its plain version at {path} {n}x{h}x{w}x{cin}->{cout} "
              f"{dtype}: conv {conv_err.max().item()}, stats {stats_rel}, apply {apply_err}, "
              f"chain {chain_err}")
        rows.append(row)
    torch.backends.cudnn.allow_tf32 = True
    return rows


def k1_counts():
    from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1

    return k1.conv3x3_stats_launches, k1.gn_apply_launches


def reset_counts():
    from sbgm_danra_tpu_torch.ops import cuda_attention
    from sbgm_danra_tpu_torch.ops import fused_conv_gn as k1

    cuda_attention.launches = 0
    k1.conv3x3_stats_launches = k1.gn_apply_launches = 0


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
        reset_counts()
        try:
            got = model(x.to(dev), t.to(dev), **{k: v.to(dev) for k, v in cond.items()}).cpu()
        finally:
            fa._FORCE_KERNEL = False
            torch.backends.cudnn.allow_tf32 = True
        tiny_counts = k1_counts()
    tiny_rel = _rel(got, ref)
    emit(phase="model", check="tiny fp32 UNet, card vs CPU", rel_err=tiny_rel, tolerance=1e-4,
         k1_launches=list(tiny_counts))
    check(tiny_rel <= 1e-4, f"tiny UNet on the card disagrees with the CPU: {tiny_rel}")
    check_k1(tiny_counts, 1, "tiny UNet forward")

    serve_model = build_score_model(flagship_spec(compute_dtype="bfloat16"),
                                    generator=torch.Generator().manual_seed(2)).to(dev)
    cond = make_cond(16, SERVE_HW, dev, 9)
    x = 2.0 * torch.randn(16, *SERVE_HW, 1, generator=torch.Generator(dev).manual_seed(10),
                          device=dev)
    t = torch.linspace(0.05, 1.0, 16, device=dev)
    with torch.inference_mode():
        reset_counts()
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
        reset_counts()
        got = model(x, t, **cond)
        check(cuda_attention.launches == 1, "the full-domain forward did not use the kernel")
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
    return model, serve_model


def phase_full_domain(dev, model):
    from sbgm_danra_tpu_torch.evaluate.full_domain import sample_full_domain
    from sbgm_danra_tpu_torch.ops import cuda_attention
    from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig

    cond = make_cond(1, FULL_DOMAIN, dev, 8)
    config = SamplerConfig(num_steps=EDM_NODES, guidance_scale=3.0, s_churn=0.0)

    def run(seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample_full_domain(
            lambda x, t, **c: model(x, t, **c), torch.Generator(dev).manual_seed(seed), cond,
            domain_hw=FULL_DOMAIN, batch=1, config=config, sampler="edm_sampler",
        )
        return out, time.perf_counter() - t0

    reset_counts()  # the main path's run starts here
    out, first_s = run(0)
    launches, k1_first = cuda_attention.launches, k1_counts()
    reset_counts()
    out2, second_s = run(1)
    launches2, k1_second = cuda_attention.launches, k1_counts()
    evaluations = 2 * (EDM_NODES - 1)
    finite = bool(np.isfinite(out).all() and np.isfinite(out2).all())
    emit(phase="full_domain", domain="589x789->608x800", sampler=f"edm-{EDM_NODES}", cfg=3.0,
         shape=list(out.shape), finite=finite, kernel_launches=launches,
         kernel_launches_second_run=launches2, expected_launches=evaluations,
         k1_launches=list(k1_first), k1_launches_second_run=list(k1_second),
         k1_expected=K1_PER_EVAL * evaluations,
         wall_s_first=first_s, wall_s_second=second_s, field_std=float(out.std()))
    check(out.shape == (1, *FULL_DOMAIN) and finite, f"bad full-domain output {out.shape}")
    check(launches == evaluations and launches2 == evaluations,
          f"kernel launched {launches}/{launches2} times, expected {evaluations}")
    check_k1(k1_first, evaluations, "full-domain sample")
    check_k1(k1_second, evaluations, "second full-domain sample")
    return {"flash_attention_fwd": launches, "conv3x3_stats": k1_first[0],
            "gn_apply": k1_first[1]}


def _post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        payload = json.loads(resp.read())
    return payload, time.perf_counter() - t0


def phase_serving(dev):
    from sbgm_danra_tpu_torch.models.unet import build_score_model
    from sbgm_danra_tpu_torch.serve import FLAGSHIP_SYNTH, InferenceEngine, make_handler

    weights = build_score_model(FLAGSHIP_SYNTH.spec, generator=torch.Generator().manual_seed(1))
    engine = InferenceEngine(FLAGSHIP_SYNTH, weights.state_dict(), dev, max_members=8)
    warm_s = engine.warmup()
    evaluations = [0]
    engine.model.register_forward_hook(lambda *_: evaluations.__setitem__(0, evaluations[0] + 1))
    reset_counts()  # the serving path's run starts here
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        check(health["status"] == "ok" and health["platform"] == "cuda", f"healthz {health}")

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
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        engine.close()
    counts = k1_counts()

    arrays = {n: np.asarray(results[n][0]["generated"], np.float32) for n, _ in requests}
    shapes_ok = all(arrays[n].shape == (n, *hw) for n, _ in requests)
    finite = all(np.isfinite(a).all() for a in arrays.values())
    repeats = {n: np.asarray(alone[n][0]["generated"], np.float32) for n, _ in requests}
    identical = all(np.array_equal(repeats[n], arrays[n]) for n, _ in requests)
    emit(phase="serving", settings="flagship_synth: 128x128, dpmpp-25, CFG w=3, bf16",
         max_members=8, warmup_s=warm_s,
         latency_s={str(n): results[n][1] for n, _ in requests},
         latency_alone_s={str(n): alone[n][1] for n, _ in requests},
         shapes_ok=shapes_ok, finite=finite, repeat_bit_identical=identical,
         repeat_max_abs_diff=max(float(np.abs(repeats[n] - arrays[n]).max()) for n, _ in requests),
         n_dispatches_concurrent=health["n_dispatches"],
         mean_rows_per_dispatch=health["mean_rows_per_dispatch"],
         unet_evaluations=evaluations[0], k1_launches=list(counts))
    check(shapes_ok and finite, "serving returned bad shapes or non-finite values")
    check(identical, "requests repeated alone did not reproduce their concurrent results")
    check_k1(counts, evaluations[0], "serving")
    return {"conv3x3_stats": counts[0], "gn_apply": counts[1]}


def phase_samplers(dev, model):
    """pc (the bench headline), em and the probability-flow ODE at 128 px."""
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
        torch.cuda.synchronize()
        reset_counts()  # this sampler's run starts here
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = get_sampler(name)(score_fn, torch.Generator(dev).manual_seed(12), shape,
                                    config=config, cond=cond)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = k1_counts()
        finite = bool(torch.isfinite(out).all())
        emit(phase="samplers", sampler=label, batch=CONTRACT_BATCH, steps=SAMPLER_STEPS,
             cfg=3.0, shape=list(out.shape), finite=finite, wall_s=wall,
             unet_evaluations=evaluations[0], k1_launches=list(counts),
             field_std=float(out.float().std()))
        check(tuple(out.shape) == shape and finite, f"{label}: bad output {tuple(out.shape)}")
        check_k1(counts, evaluations[0], label)
        launches[label] = counts[0]
    return launches


def _k1_summary(rows, kernel: str) -> dict:
    """A K1 kernel's numbers summed over the 8 chains of one full-domain UNet
    evaluation (bf16, batch 2); its largest error over every row."""
    by_shape = {(r["hw"][0], r["hw"][1], r["cin"], r["cout"]): r[kernel] for r in rows
                if r["path"] == "full-domain"}
    chains = [by_shape[c] for c in CHAINS_FULL]
    total = {key: sum(c[key] for c in chains)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    ops = sum(c["bound_ms"] for c in chains if c["bound_by"] == "operations")
    return dict(max_abs_err=max(r[kernel]["max_abs_err"] for r in rows), **total,
                bound_by="operations" if ops >= total["bound_ms"] / 2 else "bytes",
                library_ms_is=chains[0]["library"],
                at="sum over the 8 decoder chains of one 608x800 UNet evaluation, bf16, batch 2")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    # the port itself; fails here when the script is run outside a checkout
    from sbgm_danra_tpu_torch.ops import _nvcc, cuda_attention, fused_conv_gn

    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit(phase="device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    modules = (cuda_attention, fused_conv_gn)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:  # one nvcc per source, all at once
        builds = list(pool.map(lambda m: m.build_library(), modules))
    for built in builds:
        print(built.log, file=sys.stderr)
    emit(phase="build", seconds=time.perf_counter() - t0, flags=" ".join(_nvcc.NVCC_FLAGS),
         libraries=[dict(source=m.SOURCE.name, library=b.path.name, compiled=b.compiled,
                         seconds=b.seconds) for m, b in zip(modules, builds)])

    attention_rows = phase_attention_kernel(dev)
    k1_rows = phase_conv_gn_kernel(dev)
    model, serve_model = phase_model(dev)
    launches = phase_full_domain(dev, model)
    del model
    torch.cuda.empty_cache()
    serving = phase_serving(dev)
    samplers = phase_samplers(dev, serve_model)

    main_row = attention_rows[0]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "sbgm_danra_tpu_torch/csrc/flash_attention.cu",
        "replaces": "sbgm_danra_tpu/ops/pallas_attention.py:86",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in attention_rows),
        **{key: main_row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")},
        "at": "[2, 7600, 4, 32] bf16, decoder block 1 at 608x800",
    }]
    for name in ("conv3x3_stats", "gn_apply"):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "sbgm_danra_tpu_torch/csrc/conv3x3_gn.cu",
            "replaces": "sbgm_danra_tpu/ops/fused_conv_gn.py:66",
            "launches": launches[name],
            "launches_by_path": {"full_domain": launches[name], "serving": serving[name],
                                 **{f"samplers/{k}": v for k, v in samplers.items()}},
            **_k1_summary(k1_rows, name),
        })
    emit(kernels=kernels)
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
