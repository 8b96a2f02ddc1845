#!/usr/bin/env python3
"""Time and profile the torch port's two generation paths on one CUDA card.

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
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# kernel-name patterns, first match wins
CLASSES = (
    ("K2 flash_attention_fwd", ("flash_attention_fwd_kernel",)),
    ("K1 conv3x3_stats", ("conv3x3_stats_kernel",)),
    ("K1 gn_apply", ("gn_apply_kernel",)),
    ("GroupNorm (PyTorch)", ("GroupNorm", "group_norm", "RowwiseMoments", "ComputeFusedParams")),
    ("BatchNorm", ("batch_norm", "BatchNorm")),
    ("cat", ("CatArrayBatchedCopy",)),
    ("dtype and layout copies", ("copy_kernel", "direct_copy")),
    ("conv (cuDNN)", ("conv", "Conv", "implicit", "fprop", "cudnn")),
    ("matmul (cuBLAS)", ("gemm", "Gemm", "gemv", "xmma")),
    ("attention (SDPA)", ("fmha", "flash_fwd", "attention", "efficient")),
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
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
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
    return dict(
        profiled_wall_ms=wall_us / 1e3,
        device_busy_ms=busy / 1e3,
        idle_share=1.0 - busy / wall_us if wall_us else None,
        kernel_launches=len(kernels),
        kernel_ms_by_class={k: v / 1e3 for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])},
        kernel_share_by_class={k: v / kernel_total for k, v in by_class.items()},
        top_kernels=[dict(name=n[:120], calls=c, ms=t / 1e3) for n, (c, t) in top],
    )


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                   help="checkout whose sbgm_danra_tpu_torch is measured")
    p.add_argument("--label", default="change")
    p.add_argument("--paths", default="full_domain,serving")
    p.add_argument("--repeats", type=int, default=3)
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

    runs = {}
    if "full_domain" in args.paths:
        domain = (589, 789)
        spec = inference_spec(ModelSpec(in_channels=6, num_classes=4, compute_dtype="bfloat16",
                                        attention_backend="pallas"), padded_dims(*domain))
        model = build_score_model(spec, generator=torch.Generator().manual_seed(0)).to(dev)
        cond = cond_for(1, domain, 8)
        config = SamplerConfig(num_steps=18, guidance_scale=3.0, s_churn=0.0)
        runs["full_domain"] = ("EDM-18 sample, 589x789 -> 608x800, CFG w=3, batch 1", lambda: (
            sample_full_domain(lambda x, t, **c: model(x, t, **c),
                               torch.Generator(dev).manual_seed(0), cond, domain_hw=domain,
                               batch=1, config=config, sampler="edm_sampler")))
    if "serving" in args.paths:
        settings = FLAGSHIP_SYNTH
        serve_model = build_score_model(settings.spec, VESDE(),
                                        generator=torch.Generator().manual_seed(1)).to(dev)
        scond = cond_for(8, settings.sample_hw, 9)
        sampler = get_sampler(settings.sampler_type)
        gens = lambda: [torch.Generator(dev).manual_seed(s) for s in range(8)]  # noqa: E731

        def dispatch():
            with torch.inference_mode():
                out = sampler(lambda x, t, **c: serve_model(x, t, **c), gens(),
                              (8, *settings.sample_hw, 1), VESDE(), settings.sampler, cond=scond)
                return out.float().cpu().numpy()

        runs["serving"] = ("one 8-row dpmpp-25 dispatch at 128 px, CFG w=3", dispatch)

    results = []
    for path, (what, fn) in runs.items():
        torch.backends.cudnn.benchmark = False
        out = fn()  # warm-up
        walls = []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()
        prof = profile(torch, fn)
        row = dict(label=args.label, root=args.root, path=path, what=what, card=smi,
                   wall_s=walls, finite=bool(np.isfinite(out).all()),
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **prof)
        print(json.dumps(row), flush=True)
        results.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
