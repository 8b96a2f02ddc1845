"""Batch sample generation from a trained checkpoint (counterpart of
``sbgm_danra_tpu/evaluate/generation.py``), with the JAX package's npz
artifact layout, the same names and array shapes:

    {sample_dir}/generation/{model_string}/generated_samples/
        gen_samples_{suffix}.npz   eval_samples_{suffix}.npz
        lsm_samples_{suffix}.npz   seasons_{suffix}.npz
        cond_samples_{var}_{suffix}.npz
    suffix in {multi_n_{N}, single, repeated_{N}, full_domain}

Each mode runs the configured sampler as one call: on a CUDA device one
replay of its captured graph (``sampling/graphs.py``, K1 and K2 among its
nodes), on the CPU the eager loop. The generator holds its score function
for its lifetime, so a mode called again replays its graph (one per mode's
shape) and does not capture anew. A ``torch.Generator`` on the device,
seeded from ``evaluation.seed``, draws every call's noise in turn (ROADMAP
F4: the streams differ from JAX's key splits). ``generate_repeated`` is one
sampler call of ``n_repeats`` rows of one condition
(``parallel/ensemble.py``; with a ``mesh`` the members are sharded over its
ranks, and rank 0 writes the artifacts) with
``evaluation.spread_calibration`` applied in normalised space before the
back-transform; ``generate_full_domain`` runs
``evaluate/full_domain.py::sample_full_domain`` on a loader of whole-domain
samples. A float32 model's calls run with TF32 off (``precision.exact_fp32``).
With ``evaluation.save_figs`` each mode writes the conditions, truth and
generated grid to ``generated_figures/gen_samples_{suffix}.png`` (skipped
with a log line where matplotlib is missing; a failed figure never stops
generation).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from sbgm_danra_tpu_torch.capture import use_graphs
from sbgm_danra_tpu_torch.config import get_model_string
from sbgm_danra_tpu_torch.data.device_data import require_device
from sbgm_danra_tpu_torch.data.loader import extract_batch
from sbgm_danra_tpu_torch.evaluate.calibration import apply_spread_scale
from sbgm_danra_tpu_torch.evaluate.full_domain import sample_full_domain
from sbgm_danra_tpu_torch.parallel.ensemble import generate_ensemble
from sbgm_danra_tpu_torch.precision import exact_fp32
from sbgm_danra_tpu_torch.sampling import graphs
from sbgm_danra_tpu_torch.sampling.samplers import config_from_run
from sbgm_danra_tpu_torch.sde import VESDE
from sbgm_danra_tpu_torch.utils.plotting import plot_or_skip, plot_samples_and_generated

logger = logging.getLogger(__name__)

COND_KEYS = ("y", "cond_img", "lsm_cond", "topo_cond")


def condition_tensors(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The batch's conditioning keys as tensors on ``device``."""
    return {k: torch.as_tensor(batch[k]).to(device) for k in COND_KEYS
            if batch.get(k) is not None}


class SampleGenerator:
    """The four generation modes over one loader and one score function.

    ``score_fn`` is the model's sampling closure on ``device`` (e.g.
    ``TrainingPipeline.score_fn``); ``dataloader`` any iterable of collated
    batches (the gen loader of ``data/factory.py``).
    """

    def __init__(self, cfg, score_fn: Callable, dataloader, back_transforms: Optional[Dict] = None,
                 sde=None, mesh=None, device="cuda"):
        self.cfg = cfg
        self.score_fn = score_fn
        self.dataloader = dataloader
        self.back_transforms = back_transforms or {}
        self.sde = sde or VESDE()
        self.mesh = mesh
        self.device = require_device(device)
        self.capture = use_graphs(None, self.device)
        self.model_string = get_model_string(cfg)
        self.output_dir = os.path.join(cfg.paths.sample_dir, "generation", self.model_string)
        self.fig_path = os.path.join(self.output_dir, "generated_figures")
        self.sample_path = os.path.join(self.output_dir, "generated_samples")
        os.makedirs(self.fig_path, exist_ok=True)
        os.makedirs(self.sample_path, exist_ok=True)
        self.sampler_config = config_from_run(cfg, cfg.evaluation.n_steps)
        self.sampler_name = cfg.sampler.sampler_type
        self.rng = torch.Generator(self.device).manual_seed(cfg.evaluation.seed)

    # -- internals -------------------------------------------------------------

    def _next_batch(self) -> Dict[str, np.ndarray]:
        return extract_batch(next(iter(self.dataloader)), self.cfg.highres.variable)

    def _cond(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return condition_tensors(batch, self.device)

    def _sample_shape(self, n: int):
        s = self.cfg.highres.data_size
        rf = self.cfg.lowres.resize_factor
        return (n, s[0] // rf, s[1] // rf, 1)

    def _sampled(self, run: Callable[[], torch.Tensor]) -> np.ndarray:
        """``run()``'s (N, H, W, 1) field as (N, H, W) float32 on the host,
        under the model's precision rule."""
        with exact_fp32(self.cfg.model.compute_dtype), torch.no_grad():
            out = run()
        return out[..., 0].float().cpu().numpy() if isinstance(out, torch.Tensor) else out

    def _run_sampler(self, n: int, cond: Dict) -> np.ndarray:
        return self._sampled(lambda: graphs.call(
            self.sampler_name, self.score_fn, self.rng, self._sample_shape(n), self.sde,
            self.sampler_config, cond=cond, graph=self.capture))

    def _apply_backtransforms(self, x, generated, cond_img):
        """Inverse-transform the truth, the generated fields and the LR channels."""
        hr_key = f"{self.cfg.highres.variable}_hr"
        bt = self.back_transforms
        if hr_key in bt:
            x = np.asarray(bt[hr_key](x))
        if "generated" in bt:
            generated = np.asarray(bt["generated"](generated))
        if cond_img is not None:
            # cond_img's channels follow the sorted {var}_lr keys (extract_batch)
            sorted_keys = sorted(f"{v}_lr" for v in self.cfg.lowres.condition_variables or ())
            chans = []
            for i, key in enumerate(sorted_keys):
                c = cond_img[..., i]
                chans.append(np.asarray(bt[key](c)) if key in bt else c)
            cond_img = np.stack(chans, axis=-1)
        return x, generated, cond_img

    @property
    def is_main(self) -> bool:
        """Whether this process writes the artifacts: rank 0, or no mesh (every
        rank of a mesh computes the same fields)."""
        return self.mesh is None or self.mesh.rank == 0

    def _save_npz(self, data: Dict[str, Optional[np.ndarray]], suffix: str) -> None:
        if not self.is_main:
            return
        for key, value in data.items():
            if value is None:
                continue
            path = os.path.join(self.sample_path, f"{key}_{suffix}.npz")
            np.savez_compressed(path, np.asarray(value))
            logger.info("Saved %s_%s to %s", key, suffix, path)

    def _plot(self, batch, generated, suffix: str) -> None:
        if not self.cfg.evaluation.save_figs or not self.is_main:
            return
        try:
            plot_or_skip(f"gen_samples_{suffix}", plot_samples_and_generated, batch, generated,
                         self.cfg, path=os.path.join(self.fig_path, f"gen_samples_{suffix}.png"))
        except Exception as e:  # plotting must never kill generation
            logger.warning("Plotting failed for %s: %s", suffix, e)

    def _finalize(self, batch, generated, suffix):
        self._plot(batch, generated, suffix)
        x = batch["x"][..., 0]
        cond_img = batch.get("cond_img")
        x_bt, gen_bt, cond_bt = self._apply_backtransforms(x, generated, cond_img)
        self._save_npz({"gen_samples": gen_bt, "eval_samples": x_bt,
                        "lsm_samples": batch.get("lsm_cond"), "seasons": batch.get("y")}, suffix)
        if cond_bt is not None:
            sorted_keys = sorted(f"{v}_lr" for v in self.cfg.lowres.condition_variables or ())
            for i, key in enumerate(sorted_keys):
                self._save_npz({f"cond_samples_{key[:-len('_lr')]}": cond_bt[..., i]}, suffix)
        return gen_bt

    @staticmethod
    def _first(batch):
        return {k: (v[:1] if hasattr(v, "shape") and v.ndim > 0 else v) for k, v in batch.items()}

    # -- public modes ------------------------------------------------------------

    def generate_multiple(self) -> np.ndarray:
        """One batch of distinct conditions."""
        batch = self._next_batch()
        n = batch["x"].shape[0]
        generated = self._run_sampler(n, self._cond(batch))
        return self._finalize(batch, generated, f"multi_n_{n}")

    def generate_single(self) -> np.ndarray:
        batch = self._first(self._next_batch())
        generated = self._run_sampler(1, self._cond(batch))
        return self._finalize(batch, generated, "single")

    def generate_repeated(self, n_repeats: Optional[int] = None) -> np.ndarray:
        """Ensemble: ``n_repeats`` member draws of ONE condition, as one
        sampler call of ``n_repeats`` rows."""
        n_repeats = n_repeats or self.cfg.evaluation.n_repeats
        batch = self._first(self._next_batch())
        cond = self._cond(batch)
        generated = self._sampled(lambda: generate_ensemble(
            self.score_fn, self.rng, n_members=n_repeats, sample_shape=self._sample_shape(1)[1:],
            cond=cond, sampler=self.sampler_name, sde=self.sde, config=self.sampler_config,
            mesh=self.mesh, capture=self.capture))
        alpha = self.cfg.evaluation.spread_calibration
        if alpha is not None:
            # about the ensemble mean in normalised space, before the back-transform
            logger.info("Applying spread calibration alpha=%.4f to %d members", alpha, n_repeats)
            generated = apply_spread_scale(generated, alpha)
        rep_batch = {
            k: (np.repeat(v, n_repeats, axis=0) if hasattr(v, "shape") and v.ndim > 0 else v)
            for k, v in batch.items()
        }
        return self._finalize(rep_batch, generated, f"repeated_{n_repeats}")

    def generate_full_domain(self) -> np.ndarray:
        """Whole-domain fields: the full-field conditioning padded to the /32
        pyramid, one sampler call at the padded size, cropped back. Needs a
        loader of ``make_dataset(..., full_domain=True)`` and a score function
        built for the domain (``TrainingPipeline.score_fn(image_hw=...)``)."""
        batch = self._next_batch()
        cond = self._cond(batch)
        generated = self._sampled(lambda: sample_full_domain(
            self.score_fn, self.rng, cond, domain_hw=tuple(batch["x"].shape[1:3]),
            batch=batch["x"].shape[0], sde=self.sde, config=self.sampler_config,
            sampler=self.sampler_name, compute_dtype=self.cfg.model.compute_dtype,
            capture=self.capture))  # (N, H, W) on the host, cropped to the domain
        return self._finalize(batch, generated, "full_domain")
