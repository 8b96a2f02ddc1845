#!/usr/bin/env python3
"""Drive the torch port's generation path once on one CUDA card and check it.

    python3 chip_smoke.py          # from the repo root; one CUDA GPU and nvcc

Phases, one JSON line each on stdout:

1. device: the card's name, count and power limit;
2. build: the CUDA flash-attention kernel compiled with nvcc for sm_90a from
   ``sbgm_danra_tpu_torch/csrc`` into ``sbgm_danra_tpu_torch/_build/``;
3. kernel: the kernel against its plain PyTorch version on the card, at the
   full-domain decoder shape and at padded-D / ragged-S / forced shapes
   (fp32: |err| <= 2e-5 + 2e-5 |ref| with TF32 off; bf16: |err| <= 2e-2
   against the fp32 plain version on the same bf16-rounded inputs);
4. model: a tiny UNet forward on the card against the same weights on the CPU
   (fp32, TF32 off, kernel forced: max |err| <= 1e-4 max |ref|), and one
   flagship forward at 608x800 with the kernel against the same forward with
   the plain attention (bf16: max |err| <= 5e-2 max |ref|);
5. full_domain: ``sample_full_domain`` 589x789 -> 608x800, EDM-18, CFG w=3,
   flagship bf16 UNet with attention backend 'pallas', seeded weights; the
   output must be finite of shape (1, 589, 789) and the kernel must have been
   launched exactly 34 times (2 x 17 UNet evaluations, one call each);
6. serving: the engine with the flagship_synth settings behind the HTTP
   handler on a localhost port: /healthz, three concurrent /generate requests
   (1, 2 and 4 members), then each again alone, which must come back
   bit-identical.

Then the kernels' summary line, the ``nvidia-smi`` name and power limit line,
and ``{"ok": true, "device": {...}}`` as the last line. Any failure raises and
exits non-zero; without a CUDA device the script exits 1 and prints nothing on
stdout.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import torch

FULL_DOMAIN = (589, 789)
EDM_NODES = 18
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


def phase_kernel(dev):
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
        row = dict(phase="kernel", shape=list(shape), dtype=str(dtype).split(".")[-1],
                   forced_dispatch=forced, max_abs_err=max_err, tolerance=tol, ok=ok,
                   ms=ms, plain_ms=plain_ms)
        emit(**row)
        check(ok, f"kernel disagrees with its plain version at {shape} {dtype}: {max_err}")
        results.append(row)
    return results


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


def phase_model(dev):
    """The UNet on the card against the CPU, and kernel vs plain attention at full domain."""
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
        try:
            got = model(x.to(dev), t.to(dev), **{k: v.to(dev) for k, v in cond.items()}).cpu()
        finally:
            fa._FORCE_KERNEL = False
            torch.backends.cudnn.allow_tf32 = True
    tiny_rel = ((got - ref).abs().max() / ref.abs().max()).item()
    emit(phase="model", check="tiny fp32 UNet, card vs CPU", rel_err=tiny_rel, tolerance=1e-4)
    check(tiny_rel <= 1e-4, f"tiny UNet on the card disagrees with the CPU: {tiny_rel}")

    hw = padded_dims(*FULL_DOMAIN)
    spec = inference_spec(flagship_spec(compute_dtype="bfloat16", attention_backend="pallas"), hw)
    model = build_score_model(spec, generator=torch.Generator().manual_seed(0)).to(dev)
    cond = make_cond(2, hw, dev, 6)
    x = 2.0 * torch.randn(2, *hw, 1, generator=torch.Generator(dev).manual_seed(7), device=dev)
    t = torch.full((2,), 0.5, device=dev)
    with torch.inference_mode():
        before = cuda_attention.launches
        got = model(x, t, **cond)
        check(cuda_attention.launches == before + 1,
              "the full-domain forward did not use the kernel")
        fa.flash_attention_cuda = cuda_attention.flash_attention_reference
        try:
            ref = model(x, t, **cond)
        finally:
            fa.flash_attention_cuda = cuda_attention.flash_attention_cuda
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    emit(phase="model", check="flagship bf16 forward at 608x800, kernel vs plain attention",
         rel_err=rel, tolerance=5e-2, finite=bool(torch.isfinite(got).all()))
    check(rel <= 5e-2 and bool(torch.isfinite(got).all()), f"full-domain forward rel err {rel}")
    return model


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

    cuda_attention.launches = 0  # the main path's run starts here
    out, first_s = run(0)
    launches = cuda_attention.launches
    cuda_attention.launches = 0
    out2, second_s = run(1)
    launches2 = cuda_attention.launches
    expected = 2 * (EDM_NODES - 1)
    finite = bool(np.isfinite(out).all() and np.isfinite(out2).all())
    emit(phase="full_domain", domain="589x789->608x800", sampler=f"edm-{EDM_NODES}", cfg=3.0,
         shape=list(out.shape), finite=finite, kernel_launches=launches,
         kernel_launches_second_run=launches2, expected_launches=expected,
         wall_s_first=first_s, wall_s_second=second_s, field_std=float(out.std()))
    check(out.shape == (1, *FULL_DOMAIN) and finite, f"bad full-domain output {out.shape}")
    check(launches == expected and launches2 == expected,
          f"kernel launched {launches}/{launches2} times, expected {expected}")
    return launches


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
         mean_rows_per_dispatch=health["mean_rows_per_dispatch"])
    check(shapes_ok and finite, "serving returned bad shapes or non-finite values")
    check(identical, "requests repeated alone did not reproduce their concurrent results")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    # the port itself; fails here when the script is run outside a checkout
    from sbgm_danra_tpu_torch.ops import cuda_attention

    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit(phase="device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    built = cuda_attention.build_library()
    print(built.log, file=sys.stderr)
    emit(phase="build", compiled=built.compiled, seconds=built.seconds,
         library=str(built.path.name),
         flags=" ".join(cuda_attention.NVCC_FLAGS), source=str(cuda_attention.SOURCE.name))

    kernel_rows = phase_kernel(dev)
    model = phase_model(dev)
    launches = phase_full_domain(dev, model)
    del model
    torch.cuda.empty_cache()
    phase_serving(dev)

    main_row = kernel_rows[0]
    emit(kernels=[{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "sbgm_danra_tpu_torch/csrc/flash_attention.cu",
        "replaces": "sbgm_danra_tpu/ops/pallas_attention.py:86",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
    }])
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
