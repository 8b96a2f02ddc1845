"""Full-domain ensemble quality with a learned score, on the port
(counterpart of ``scripts/full_domain_quality_eval.py``, same arguments,
defaults, output file and JSON keys).

1. loads the flagship trained by configs/full_scale_quality.yaml (a 589x789
   synthetic archive, 128x128 crop training);
2. draws test-split dates full-domain (truth and conditioning at 589x789),
   normalised with the training-crop statistics, exactly as serving would
   (``data/factory.make_dataset(..., full_domain=True)``: the statistics are
   not recomputed at the full domain);
3. generates K-member full-domain ensembles (padded to 608x800,
   ``evaluate/full_domain.py``; EDM, s_churn 0) at CFG w in {0, 3}, in
   chunks of ``--member_chunk`` members;
4. scores CRPS, ensemble-mean RMSE, spread/skill and radial spectra in
   normalised space, overall and split in-crop (the config's
   ``highres.cutout_domains``, rows 170:350, cols 340:520) and out-of-crop.

The score function is built for the domain (``TrainingPipeline.score_fn(
image_hw=highres.full_domain_dims)``): at 608x800 the attention of decoder
block 1 (7,600 tokens) runs the CUDA flash kernel (K2). Each member chunk is
one ``sample_full_domain`` call, on the card a replay of one CUDA graph per
guidance weight (the first call captures it), drawing from a generator
seeded from ``(17, date * 1000 + first member)`` as JAX folds that index
into its key (the streams differ, ROADMAP F4). ``gen_wall_s`` includes the
capture, as JAX's includes its compile.

    python -m sbgm_danra_tpu_torch.scripts.full_domain_quality_eval
        [--config configs/full_scale_quality.yaml] [--n_dates 8] [--members 16]
        [--member_chunk 4] [--guidance 0,3] [--out PATH] [--device cpu]

``main(argv, cfg=None)`` returns ``{"results": the JSON's contents, "runs":
each weight's ``scripts/common.Run`` with its wall seconds, "out": the
JSON's path}``; ``cfg``, when given, is the run config in place of
``--config``.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import time

import numpy as np
import torch

from sbgm_danra_tpu_torch.capture import use_graphs
from sbgm_danra_tpu_torch.data.device_data import require_device
from sbgm_danra_tpu_torch.data.factory import make_dataset
from sbgm_danra_tpu_torch.data.loader import collate, extract_batch
from sbgm_danra_tpu_torch.evaluate.calibration import ensemble_spread_skill
from sbgm_danra_tpu_torch.evaluate.crps import crps_ensemble
from sbgm_danra_tpu_torch.evaluate.full_domain import padded_dims, sample_full_domain
from sbgm_danra_tpu_torch.pipelines.comparison import compute_2d_power_spectrum, radial_average
from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig
from sbgm_danra_tpu_torch.scripts.common import CountedScore, RunMeter, chunk_generator

logger = logging.getLogger("full_domain_quality")

COND_KEYS = ("y", "cond_img", "lsm_cond", "topo_cond")


def region_masks(h: int, w: int, crop):
    x1, x2, y1, y2 = crop
    m = np.zeros((h, w), bool)
    m[x1:x2, y1:y2] = True
    return m, ~m


def ens_metrics(members: np.ndarray, truth: np.ndarray, mask=None):
    """members [N, K, H, W], truth [N, H, W] -> pooled metrics (optionally
    restricted to a boolean HxW mask)."""
    crps_px = np.stack([crps_ensemble(members[i], truth[i]) for i in range(len(truth))])
    mean = members.mean(axis=1)
    err2 = (mean - truth) ** 2
    if mask is not None:
        crps_v = crps_px[:, mask]
        rmse = float(np.sqrt(err2[:, mask].mean()))
        # masked selections are flat pixel vectors; ensemble_spread_skill
        # expects 2-D fields, so the pooled pixels get a singleton width
        spread, _ = ensemble_spread_skill(members[:, :, mask][..., None],
                                          truth[:, mask][..., None])
    else:
        crps_v = crps_px
        rmse = float(np.sqrt(err2.mean()))
        spread, _ = ensemble_spread_skill(members, truth)
    return {
        "crps": round(float(crps_v.mean()), 4),
        "rmse_mean": round(rmse, 4),
        "spread": round(spread, 4),
        "spread_skill": round(spread / rmse, 3) if rmse > 0 else None,
    }


def spectrum_logmse(members: np.ndarray, truth: np.ndarray) -> float:
    """log-space MSE of the mean radial power spectrum, generated vs truth."""

    def mean_spec(fields):
        specs = [radial_average(compute_2d_power_spectrum(f)) for f in fields]
        n = min(len(s) for s in specs)
        return np.mean([s[:n] for s in specs], axis=0)

    gen = mean_spec([m for e in members for m in e[:2]])  # 2 members/date
    tru = mean_spec(list(truth))
    n = min(len(gen), len(tru))
    eps = 1e-12
    return float(np.mean((np.log(gen[:n] + eps) - np.log(tru[:n] + eps)) ** 2))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Full-domain ensemble quality (port)")
    ap.add_argument("--config", default="configs/full_scale_quality.yaml")
    ap.add_argument("--n_dates", type=int, default=8)
    ap.add_argument("--members", type=int, default=16)
    ap.add_argument("--member_chunk", type=int, default=4,
                    help="members per sampler call (608x800 activations)")
    ap.add_argument("--guidance", default="0,3")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None, cfg=None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    from sbgm_danra_tpu_torch.cli.entries import _load_pipeline_for_sampling

    if cfg is None:
        from sbgm_danra_tpu_torch.config import load_config

        cfg = load_config(args.config)
    device = require_device(args.device)
    route = use_graphs(None, device)
    load_cfg = copy.deepcopy(cfg)
    load_cfg.data_handling.device_dataset = False
    load_cfg.training.batch_size = 4
    pipeline, _ = _load_pipeline_for_sampling(load_cfg, device)
    domain = tuple(cfg.highres.full_domain_dims)
    score_fn = pipeline.score_fn(use_ema=cfg.training.load_ema, image_hw=domain)
    sde = pipeline.sde

    # ---- full-domain test conditions and truth (training-crop statistics)
    ds = make_dataset(load_cfg, "test", full_domain=True)
    n_dates = min(args.n_dates, len(ds))
    samples = [ds.__getitem__(i, rng=np.random.default_rng((99, i))) for i in range(n_dates)]
    batch = extract_batch(collate(samples), cfg.highres.variable)
    truth = np.asarray(batch["x"])[..., 0]
    dom_h, dom_w = truth.shape[1:]
    target = padded_dims(dom_h, dom_w)
    logger.info("%d test dates full-domain %dx%d (padded %dx%d), %d members",
                n_dates, dom_h, dom_w, *target, args.members)
    base_cond = {key: np.asarray(batch[key]) for key in COND_KEYS if key in batch}

    mc = args.member_chunk
    results = {"n_dates": n_dates, "members": args.members,
               "domain": [dom_h, dom_w], "padded": list(target),
               "sampler": f"edm_{cfg.sampler.n_timesteps}_churn0"}
    runs = {}
    crop = tuple(cfg.highres.cutout_domains)
    in_mask, out_mask = region_masks(dom_h, dom_w, crop)

    for w_str in args.guidance.split(","):
        w = float(w_str)
        scfg = SamplerConfig(num_steps=cfg.sampler.n_timesteps, snr=cfg.sampler.snr,
                             eps=cfg.sampler.t_eps, guidance_scale=w if w > 0 else None,
                             edm_rho=cfg.sampler.edm_rho, s_churn=0.0)
        score = CountedScore(score_fn)  # one graph per weight, kept while the weight runs
        meter = RunMeter(score, route)
        members = np.empty((n_dates, args.members, dom_h, dom_w), np.float32)
        t0 = time.time()
        for d in range(n_dates):
            cond_d = {k: torch.as_tensor(np.repeat(v[d:d + 1], mc, axis=0)).to(device)
                      for k, v in base_cond.items()}
            for c0 in range(0, args.members, mc):
                out = meter.call(lambda: sample_full_domain(
                    score, chunk_generator(device, 17, d * 1000 + c0), cond_d,
                    domain_hw=(dom_h, dom_w), batch=mc, sde=sde, config=scfg,
                    sampler="edm_sampler", compute_dtype=cfg.model.compute_dtype,
                    capture=route))
                members[d, c0:c0 + mc] = out[: args.members - c0]
        wall = time.time() - t0
        runs[f"w{w_str}"] = {**meter.finish().as_dict(), "wall_s": wall}
        del score, meter
        if not np.isfinite(members).all():
            raise FloatingPointError("non-finite full-domain members")

        block = {
            "overall": ens_metrics(members, truth),
            "in_crop": ens_metrics(members, truth, in_mask),
            "out_of_crop": ens_metrics(members, truth, out_mask),
            "spectrum_logmse": round(spectrum_logmse(members, truth), 4),
            "gen_wall_s": round(wall, 1),
            "s_per_member_field": round(wall / (n_dates * args.members), 3),
        }
        ic, oc = block["in_crop"]["crps"], block["out_of_crop"]["crps"]
        block["out_of_crop_crps_penalty_pct"] = round(100.0 * (oc - ic) / ic, 1)
        results[f"w{w_str}"] = block
        logger.info("w=%s: overall CRPS %.3f | in-crop %.3f | out-of-crop %.3f "
                    "(+%.1f%%) | spread/skill %s",
                    w_str, block["overall"]["crps"], ic, oc,
                    block["out_of_crop_crps_penalty_pct"], block["overall"]["spread_skill"])

    out = args.out or os.path.join(cfg.paths.sample_dir, "full_domain_quality.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))
    logger.info("wrote %s", out)
    return {"results": results, "runs": runs, "out": out}


if __name__ == "__main__":
    main()
