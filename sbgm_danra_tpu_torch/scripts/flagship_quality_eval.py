"""Learned-model ensemble quality study on the port (counterpart of
``scripts/flagship_quality_eval.py``, same arguments, defaults, output file
and JSON keys).

Evaluates the flagship checkpoint trained by configs/flagship_synth.yaml:

1. deterministic test-split conditions (fixed crop per date);
2. K-member ensembles with EDM+churn (the fast path) and PC-1000 (the
   reference-parity sampler) at CFG w=3, from the same learned score;
3. per-date CRPS, ensemble-mean RMSE, spread/skill, pooled rank histogram,
   in normalized model space and back-transformed physical units;
4. CFG effect: w in {0, 3, 7} with EDM; optional churn and node-count
   sweeps, DPM-Solver++(2M) rows and a spread calibration fitted on the
   valid split;
5. generated-vs-truth radial power spectra (log-space MSE).

Writes ``{paths.sample_dir}/flagship_quality_eval.json`` (or ``--out``) and
prints a markdown table fragment.

    python -m sbgm_danra_tpu_torch.scripts.flagship_quality_eval
        [--config configs/flagship_synth.yaml] [--n_dates 16] [--members 32]
        [--skip_pc] [--churn_sweep] [--nfe_sweep] [--dpmpp] [--calibrate]
        [--pc_chunk_dates 2] [--out PATH] [--device cpu]

Each sampler call runs through ``sampling/graphs.call``: on the card one
replay of the run's CUDA graph. JAX's ahead-of-time compile
(``compile_options.compile_lowered``) has no counterpart; the capture takes
its place, and ``compile_s`` is the first call's wall time (two eager
warm-ups, the capture and instantiation, and one replay), ``run_s`` the
replays of every date chunk after it. A run keeps its graph only while it
runs. Each date chunk draws from its own generator, seeded from
``(seed, first date of the chunk)`` as JAX folds the chunk's first date into
its key; the streams differ from JAX's (ROADMAP F4), so the numbers agree
with JAX's in distribution only.

PC-1000 (2,000 UNet evaluations a call) runs on the eager loop on the card
(``capture.use_graphs(False, device)``), a route chosen and recorded, not a
fallback: its graph holds 2,000 UNet evaluations' kernels, and the capture
and instantiation alone cost about twice one eager call, with gigabytes of
host memory, before two warm-up calls and the first replay (PERF.md §6;
``profile_port.py --paths pc1000_capture`` measures it).

``main(argv, cfg=None)`` returns ``{"results": the JSON's contents, "runs":
each sampler run's route, calls, UNet evaluations, K1 / K2 launches and
graph seconds and pool (``scripts/common.Run``), "out": the JSON's path}``;
``cfg``, when given, is the run config in place of ``--config``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from sbgm_danra_tpu_torch.capture import use_graphs
from sbgm_danra_tpu_torch.data.device_data import require_device
from sbgm_danra_tpu_torch.data.factory import make_dataset
from sbgm_danra_tpu_torch.data.loader import collate, extract_batch
from sbgm_danra_tpu_torch.evaluate.crps import crps_ensemble
from sbgm_danra_tpu_torch.pipelines.comparison import compute_2d_power_spectrum, radial_average
from sbgm_danra_tpu_torch.precision import exact_fp32
from sbgm_danra_tpu_torch.sampling import graphs
from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig
from sbgm_danra_tpu_torch.scripts.common import CountedScore, RunMeter, chunk_generator

COND_KEYS = ("y", "cond_img", "lsm_cond", "topo_cond")
BASE_ROWS = ("pc1000_w3", "edm_w3", "edm_w0", "edm_w7")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Learned-model ensemble quality study (port)")
    p.add_argument("--config", default="configs/flagship_synth.yaml")
    p.add_argument("--n_dates", type=int, default=16)
    p.add_argument("--members", type=int, default=32)
    p.add_argument("--skip_pc", action="store_true")
    p.add_argument("--churn_sweep", action="store_true",
                   help="EDM s_churn in {0,7,21,28} at w=3 (14 is the default run)")
    p.add_argument("--nfe_sweep", action="store_true",
                   help="EDM node count in {18,50,80} at w=3 (35 is the default run)")
    p.add_argument("--dpmpp", action="store_true",
                   help="add DPM-Solver++(2M) rows (25 nodes, w in {0,3}) — "
                        "the 24-NFE deterministic path, learned-score check")
    p.add_argument("--calibrate", action="store_true",
                   help="fit spread calibration on VALID-split ensembles and "
                        "report calibrated test metrics (evaluate/calibration.py)")
    p.add_argument("--pc_chunk_dates", type=int, default=2,
                   help="dates per PC-1000 sampler call")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def tile_members(arr, k: int) -> np.ndarray:
    """[N, ...] -> [N*K, ...] (member-major per date: date i occupies i*K:(i+1)*K)."""
    return np.repeat(np.asarray(arr), k, axis=0)


def build_conditions(cfg, split: str, n: int, seed_base: int, k: int, device):
    """The first ``n`` dates of ``split``, each at a fixed crop: the
    conditioning tiled over ``k`` members on ``device`` and the truth [N, H, W]
    in normalised space."""
    ds = make_dataset(cfg, split)
    n = min(n, len(ds))
    samples = [ds.__getitem__(i, rng=np.random.default_rng((seed_base, i))) for i in range(n)]
    batch = extract_batch(collate(samples), cfg.highres.variable)
    truth = np.asarray(batch["x"])[..., 0]
    conds = {key: torch.as_tensor(tile_members(batch[key], k)).to(device)
             for key in COND_KEYS if key in batch}
    return conds, truth


def metrics(members: np.ndarray, truth: np.ndarray, back: Dict) -> dict:
    """members [N, K, H, W] vs truth [N, H, W]; normalised and, with a
    ``generated`` back-transform, physical (JAX's ``metrics``)."""
    n_dates, k, h, w = members.shape
    out = {}
    gen_bt = back.get("generated")
    for space, mem, tru in (
        ("normalized", members, truth),
        ("physical", None if gen_bt is None else np.asarray(gen_bt(members)),
         None if gen_bt is None else np.asarray(gen_bt(truth))),
    ):
        if mem is None:
            continue
        crps = np.mean([crps_ensemble(mem[i], tru[i]).mean() for i in range(n_dates)])
        mean = mem.mean(axis=1)
        rmse = float(np.sqrt(((mean - tru) ** 2).mean()))
        # fair spread/skill: sqrt((K+1)/K) * ensemble std vs mean RMSE
        spread = float(np.sqrt(((mem - mean[:, None]) ** 2).sum(axis=1).mean() / (k - 1)))
        ss = spread * np.sqrt((k + 1) / k) / rmse if rmse > 0 else np.nan
        out[space] = {"crps": float(crps), "rmse_mean": rmse, "spread": spread,
                      "spread_skill": float(ss)}
    # pooled rank histogram (normalised space, subsampled pixels)
    rng = np.random.default_rng(0)
    ii = rng.integers(0, h, 400)
    jj = rng.integers(0, w, 400)
    ranks = (members[:, :, ii, jj] < truth[:, None, ii, jj]).sum(axis=1).ravel()
    hist, _ = np.histogram(ranks, bins=np.arange(k + 2) - 0.5)
    out["rank_histogram"] = (hist / hist.sum()).round(5).tolist()

    def spec(fields):  # radial power of generated members vs truth
        return radial_average(np.mean([compute_2d_power_spectrum(f) for f in fields], axis=0))

    s_truth = spec(truth)
    s_gen = spec(members.reshape(-1, h, w)[:: max(1, k // 4)])
    eps = 1e-12
    out["spectrum_log_mse"] = float(np.mean((np.log(s_gen + eps) - np.log(s_truth + eps)) ** 2))
    return out


def markdown(results: dict) -> str:
    """The BASELINE.md table fragment of JAX's script."""
    sweep_rows = sorted(n for n in results if isinstance(results.get(n), dict)
                        and "normalized" in results[n] and n not in BASE_ROWS)
    rows = []
    for name in (*BASE_ROWS, *sweep_rows):
        r = results.get(name)
        if not r:
            continue
        nrm = r["normalized"]
        rows.append(
            f"| {name} | {nrm['crps']:.4f} | {nrm['rmse_mean']:.4f} | "
            f"{nrm['spread_skill']:.3f} | {r.get('spectrum_log_mse', float('nan')):.3f} | "
            f"{r.get('run_s', '')} |")
    return "\n".join(["", "| sampler | CRPS | RMSE(mean) | spread/skill | spec logMSE | run_s |",
                      "|---|---|---|---|---|---|", *rows])


def run_sampler(score_fn, sde, cfg, conds: Dict[str, torch.Tensor], k: int, hw, name: str,
                num_steps: int, guidance: Optional[float], s_churn: float = 0.0, seed: int = 0,
                chunk_dates: Optional[int] = None, graph: bool = False):
    """One sampler over every date of ``conds`` in chunks of ``chunk_dates``
    dates (all at once by default): (members [N, K, H, W], compile_s, run_s,
    ``Run``). A short tail chunk repeats the last date, so that every call
    has the graph's shape; the padded rows are trimmed."""
    g = cfg.classifier_free_guidance
    h, w = hw
    nd = next(iter(conds.values())).shape[0] // k
    scfg = SamplerConfig(num_steps=num_steps, snr=cfg.sampler.snr, eps=cfg.sampler.t_eps,
                         guidance_scale=guidance, guidance_scale_max=g.guidance_scale_max,
                         edm_rho=cfg.sampler.edm_rho, s_churn=s_churn)
    nd_chunk = chunk_dates or nd
    shape = (nd_chunk * k, h, w, 1)
    device = next(iter(conds.values())).device

    def cond_slice(d0):
        sl = {key: v[d0 * k:(d0 + nd_chunk) * k] for key, v in conds.items()}
        short = nd_chunk * k - next(iter(sl.values())).shape[0]
        if short > 0:
            sl = {key: torch.cat([v, v[-1:].expand(short, *v.shape[1:])]) for key, v in sl.items()}
        return sl

    score = CountedScore(score_fn)
    meter = RunMeter(score, graph)

    def call(d0):
        return meter.call(lambda: graphs.call(name, score, chunk_generator(device, seed, d0),
                                              shape, sde, scfg, cond=cond_slice(d0),
                                              graph=graph))

    with exact_fp32(cfg.model.compute_dtype), torch.no_grad():
        t0 = time.time()
        if graph:  # warm-ups, the capture and one replay
            call(0)
            torch.cuda.synchronize(device)
        t_compile = time.time() - t0
        t0 = time.time()
        outs = [call(d0)[..., 0].float().cpu().numpy() for d0 in range(0, nd, nd_chunk)]
        t_run = time.time() - t0
    run = meter.finish()
    members = np.concatenate(outs)[: nd * k].reshape(nd, k, h, w)
    return members, t_compile, t_run, run


def main(argv=None, cfg=None) -> dict:
    args = build_parser().parse_args(argv)
    from sbgm_danra_tpu_torch.cli.entries import _load_pipeline_for_sampling
    from sbgm_danra_tpu_torch.transforms import back_transforms_for_config

    if cfg is None:
        from sbgm_danra_tpu_torch.config import load_config

        cfg = load_config(args.config)
    device = require_device(args.device)
    route = use_graphs(None, device)
    # an evaluation process: host loaders for the checkpoint and the handful
    # of test conditions; the train split is not put on the card
    load_cfg = copy.deepcopy(cfg)
    load_cfg.data_handling.device_dataset = False
    load_cfg.training.batch_size = 4
    pipeline, _ = _load_pipeline_for_sampling(load_cfg, device)
    back = back_transforms_for_config(cfg)
    score_fn = pipeline.score_fn(use_ema=cfg.training.load_ema)
    sde = pipeline.sde
    k = args.members

    cond, truth_test = build_conditions(load_cfg, "test", args.n_dates, 1234, k, device)
    n_dates = truth_test.shape[0]
    hw = truth_test.shape[1:]
    g = cfg.classifier_free_guidance
    runs: Dict[str, dict] = {}

    def sampled(key, name, num_steps, guidance, s_churn=0.0, seed=0, chunk_dates=None,
                cond_set=None, graph=route):
        members, tc, tr, run = run_sampler(score_fn, sde, cfg, cond if cond_set is None
                                           else cond_set, k, hw, name, num_steps, guidance,
                                           s_churn, seed, chunk_dates, graph)
        runs[key] = {**run.as_dict(), "compile_s": tc, "run_s": tr}
        return members, tc, tr

    results = {"n_dates": n_dates, "members": k, "image_hw": [int(hw[0]), int(hw[1])]}
    out_path = args.out or os.path.join(cfg.paths.sample_dir, "flagship_quality_eval.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)

    def checkpoint_results():
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)

    edm, tc, tr = sampled("edm_w3", "edm_sampler", cfg.sampler.n_timesteps, g.guidance_scale,
                          cfg.sampler.s_churn)
    results["edm_w3"] = metrics(edm, truth_test, back)
    results["edm_w3"]["compile_s"] = round(tc, 2)
    results["edm_w3"]["run_s"] = round(tr, 3)
    checkpoint_results()
    print("EDM+churn w=3:", json.dumps(results["edm_w3"], indent=2)[:400])

    for wgt in (0.0, 7.0):
        key = f"edm_w{int(wgt)}"
        m_, tc, tr = sampled(key, "edm_sampler", cfg.sampler.n_timesteps,
                             None if wgt == 0.0 else wgt, cfg.sampler.s_churn, seed=1)
        results[key] = metrics(m_, truth_test, back)
        results[key]["run_s"] = round(tr, 3)
        checkpoint_results()
        print(key, "crps:", results[key]["normalized"]["crps"])

    if args.churn_sweep:
        for sc in (0.0, 7.0, 21.0, 28.0):
            key = f"edm_w3_churn{int(sc)}"
            m_, tc, tr = sampled(key, "edm_sampler", cfg.sampler.n_timesteps, g.guidance_scale,
                                 sc, seed=2)
            results[key] = metrics(m_, truth_test, back)
            results[key]["run_s"] = round(tr, 3)
            checkpoint_results()
            print(key, "crps:", results[key]["normalized"]["crps"],
                  "spread/skill:", results[key]["normalized"]["spread_skill"])

    if args.nfe_sweep:
        for n in (18, 50, 80):
            key = f"edm{n}_w3"
            m_, tc, tr = sampled(key, "edm_sampler", n, g.guidance_scale, cfg.sampler.s_churn,
                                 seed=3)
            results[key] = metrics(m_, truth_test, back)
            results[key]["run_s"] = round(tr, 3)
            checkpoint_results()
            print(key, "crps:", results[key]["normalized"]["crps"])

    dpmpp_test = None
    if args.dpmpp:
        for nodes, wgt in ((25, 3.0), (25, 0.0), (35, 3.0)):
            key = f"dpmpp{nodes}_w{int(wgt)}"
            m_, tc, tr = sampled(key, "dpmpp_sampler", nodes, None if wgt == 0.0 else wgt, 0.0,
                                 seed=5)
            if key == "dpmpp25_w3":
                dpmpp_test = m_
            results[key] = metrics(m_, truth_test, back)
            results[key]["compile_s"] = round(tc, 2)
            results[key]["run_s"] = round(tr, 3)
            checkpoint_results()
            print(key, "crps:", results[key]["normalized"]["crps"])

    if args.calibrate:
        # ensemble inflation fitted on VALID-split ensembles (same sampler and
        # seed protocol, disjoint dates), applied to the test EDM w=3 members
        from sbgm_danra_tpu_torch.evaluate.calibration import apply_spread_scale, fit_spread_scale

        vcond, truth_val = build_conditions(load_cfg, "valid", args.n_dates, 5678, k, device)
        vm, tc, tr = sampled("calibration/valid_edm_w3", "edm_sampler",
                             cfg.sampler.n_timesteps, g.guidance_scale, cfg.sampler.s_churn,
                             seed=4, cond_set=vcond)
        alphas = {rule: fit_spread_scale(vm, truth_val, rule=rule)
                  for rule in ("crps", "spread_skill")}
        results["calibration"] = {
            "fit_split": "valid", "fit_dates": int(truth_val.shape[0]),
            "val_run_s": round(tr, 3),
            **{f"alpha_{k_}": round(v, 4) for k_, v in alphas.items()},
        }
        for rule, alpha in alphas.items():
            key = f"edm_w3_cal_{rule}"
            results[key] = metrics(apply_spread_scale(edm, alpha), truth_test, back)
            results[key]["alpha"] = round(alpha, 4)
            checkpoint_results()
            nrm = results[key]["normalized"]
            print(key, f"alpha={alpha:.3f}", "crps:", nrm["crps"],
                  "spread/skill:", nrm["spread_skill"])

        if dpmpp_test is not None:
            # dpmpp's own calibration leg: fit on VALID dpmpp-25 ensembles,
            # apply to the test dpmpp-25 members
            vm_d, _, tr_d = sampled("calibration/valid_dpmpp25_w3", "dpmpp_sampler", 25,
                                    g.guidance_scale, 0.0, seed=6, cond_set=vcond)
            alpha_d = fit_spread_scale(vm_d, truth_val, rule="crps")
            key = "dpmpp25_w3_cal_crps"
            results[key] = metrics(apply_spread_scale(dpmpp_test, alpha_d), truth_test, back)
            results[key]["alpha"] = round(alpha_d, 4)
            results[key]["val_run_s"] = round(tr_d, 3)
            checkpoint_results()
            nrm = results[key]["normalized"]
            print(key, f"alpha={alpha_d:.3f}", "crps:", nrm["crps"],
                  "spread/skill:", nrm["spread_skill"])

    if not args.skip_pc:
        pc, tc, tr = sampled("pc1000_w3", "pc_sampler", 1000, g.guidance_scale,
                             chunk_dates=args.pc_chunk_dates,
                             graph=use_graphs(False, device))  # eager: see the module's notes
        results["pc1000_w3"] = metrics(pc, truth_test, back)
        results["pc1000_w3"]["compile_s"] = round(tc, 2)
        results["pc1000_w3"]["run_s"] = round(tr, 3)
        print("PC-1000 w=3:", json.dumps(results["pc1000_w3"], indent=2)[:400])

    checkpoint_results()
    print("wrote", out_path)
    print(markdown(results))
    return {"results": results, "runs": runs, "out": out_path}


if __name__ == "__main__":
    main()
