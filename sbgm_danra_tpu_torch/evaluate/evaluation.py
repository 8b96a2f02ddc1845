"""Offline evaluation of saved generation artifacts (counterpart of
``sbgm_danra_tpu/evaluate/evaluation.py``): loads the npz artifacts that
``SampleGenerator`` wrote for one sample-type suffix and computes pixel and
spatial statistics, per-sample summaries, the ensemble CRPS of a repeated
artifact and the radially averaged power-spectrum comparison. All of it is
numpy on the host, as in JAX. The figures (pixel and error histograms, the
truth / generated examples) go to ``evaluation_figures/``; where matplotlib
is missing each is skipped with a log line.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np

from sbgm_danra_tpu_torch.config import get_model_string
from sbgm_danra_tpu_torch.evaluate.crps import crps_ensemble
from sbgm_danra_tpu_torch.pipelines.comparison import compare_power_spectra
from sbgm_danra_tpu_torch.utils.plotting import (plot_error_histograms, plot_or_skip,
                                                 plot_pixel_histograms, pyplot)
from sbgm_danra_tpu_torch.utils.units import VARIABLE_REGISTRY

logger = logging.getLogger(__name__)


class Evaluation:
    """Loads the gen/eval/cond/lsm npz of one sample-type suffix."""

    def __init__(self, cfg, generated_sample_type: str = "multiple", n_samples: int = 4):
        self.cfg = cfg
        self.sample_type = generated_sample_type
        self.model_string = get_model_string(cfg)
        self.output_dir = os.path.join(cfg.paths.sample_dir, "generation", self.model_string)
        self.sample_path = os.path.join(self.output_dir, "generated_samples")
        self.fig_path = os.path.join(self.output_dir, "evaluation_figures")
        os.makedirs(self.fig_path, exist_ok=True)
        # SampleGenerator's file suffixes
        if generated_sample_type == "repeated":
            self.suffix = f"_repeated_{n_samples}.npz"
        elif generated_sample_type == "single":
            self.suffix = "_single.npz"
        elif generated_sample_type == "full_domain":
            self.suffix = "_full_domain.npz"
        else:
            self.suffix = f"_multi_n_{n_samples}.npz"

        self.gen_imgs = self._load("gen_samples")
        self.eval_imgs = self._load("eval_samples")
        self.lsm_imgs = self._load("lsm_samples", required=False)
        self.seasons = self._load("seasons", required=False)
        self.cond_imgs = {}
        for var in cfg.lowres.condition_variables or ():
            arr = self._load(f"cond_samples_{var}", required=False)
            if arr is not None:
                self.cond_imgs[var] = arr

    def _load(self, key: str, required: bool = True) -> Optional[np.ndarray]:
        path = os.path.join(self.sample_path, key + self.suffix)
        if not os.path.exists(path):
            if required:
                raise FileNotFoundError(f"Missing generation artifact: {path}")
            return None
        return np.load(path)["arr_0"]

    def _paired(self):
        """Generated and truth fields, a single truth repeated over the members."""
        gen, ref = self.gen_imgs, self.eval_imgs
        if ref.shape[0] == 1 and gen.shape[0] > 1:
            ref = np.repeat(ref, gen.shape[0], axis=0)
        return gen, ref

    # -- metrics ---------------------------------------------------------------

    def full_pixel_statistics(self, save_stats: bool = True,
                              save_figs: bool = True) -> Dict[str, np.ndarray]:
        """Pooled value distributions, per-sample |bias| / RMSE / bias and the
        per-pixel error arrays."""
        gen, ref = self._paired()
        err = gen.reshape(gen.shape[0], -1) - ref.reshape(ref.shape[0], -1)
        stats = {
            "gen_values": gen.ravel(),
            "eval_values": ref.ravel(),
            "abs_error_per_sample": np.abs(err).mean(axis=1),
            "rmse_per_sample": np.sqrt((err**2).mean(axis=1)),
            "bias_per_sample": err.mean(axis=1),
            "mae_all": np.abs(err).ravel(),
            "rmse_all": np.abs(err).ravel(),  # sqrt(square(x)) == |x| pointwise
        }
        if save_stats:
            out = os.path.join(self.fig_path, f"pixel_stats_{self.sample_type}.npz")
            np.savez_compressed(out, **stats)
            logger.info("Saved pixel statistics to %s", out)
        if save_figs:
            unit = VARIABLE_REGISTRY.get(self.cfg.highres.variable, {}).get("unit", "")
            plot_or_skip(f"pixel_hist_{self.sample_type}", plot_pixel_histograms,
                         stats["gen_values"], stats["eval_values"], unit,
                         path=os.path.join(self.fig_path, f"pixel_hist_{self.sample_type}.png"))
            plot_or_skip(f"rmse_mae_hist_{self.sample_type}", plot_error_histograms,
                         stats["mae_all"], stats["rmse_all"],
                         path=os.path.join(self.fig_path,
                                           f"rmse_mae_hist_{self.sample_type}.png"))
        return stats

    def spatial_statistics(self, save_stats: bool = True) -> Dict[str, np.ndarray]:
        """Per-pixel RMSE / MAE / bias maps."""
        gen, ref = self._paired()
        err = gen - ref
        stats = {
            "rmse_map": np.sqrt((err**2).mean(axis=0)),
            "mae_map": np.abs(err).mean(axis=0),
            "bias_map": err.mean(axis=0),
        }
        if save_stats:
            out = os.path.join(self.fig_path, f"spatial_stats_{self.sample_type}.npz")
            np.savez_compressed(out, **stats)
        return stats

    def daily_statistics(self) -> Dict[str, np.ndarray]:
        """Per-sample mean and max of the generated and the truth fields."""
        axes = tuple(range(1, self.gen_imgs.ndim))
        return {
            "gen_mean": self.gen_imgs.mean(axis=axes),
            "gen_max": self.gen_imgs.max(axis=axes),
            "eval_mean": self.eval_imgs.mean(axis=axes),
            "eval_max": self.eval_imgs.max(axis=axes),
        }

    def ensemble_crps(self) -> Dict[str, float]:
        """Ensemble CRPS against the (single) truth: repeated artifacts only."""
        if self.sample_type != "repeated":
            raise ValueError("CRPS needs a repeated (ensemble) artifact")
        obs = self.eval_imgs[0] if self.eval_imgs.ndim == self.gen_imgs.ndim else self.eval_imgs
        crps_map = crps_ensemble(self.gen_imgs, obs)
        members_mean = self.gen_imgs.mean(axis=0)
        return {
            "crps": float(crps_map.mean()),
            "ensemble_mean_rmse": float(np.sqrt(((members_mean - obs) ** 2).mean())),
            "spread": float(self.gen_imgs.std(axis=0).mean()),
        }

    def power_spectrum_comparison(self, dx_km: float = 2.5) -> Dict[str, object]:
        """Radially averaged power spectra of the generated fields against the
        truth's (``pipelines/comparison.py``)."""
        gen, ref = self._paired()
        return compare_power_spectra(list(gen), list(ref), dx_km).as_dict()

    def plot_example_images(self, n_samples: int = 4, mask_ocean: bool = False
                            ) -> Optional[str]:
        """Truth and generated side by side, ``examples_{type}.png``; the
        path, or None where matplotlib is missing."""
        return plot_or_skip(f"examples_{self.sample_type}", self._plot_examples, n_samples,
                            mask_ocean)

    def _plot_examples(self, n_samples: int, mask_ocean: bool) -> str:
        plt = pyplot()
        n = min(n_samples, self.gen_imgs.shape[0])
        fig, axes = plt.subplots(2, n, figsize=(2.4 * n, 5), squeeze=False)
        for i in range(n):
            ref = self.eval_imgs[min(i, self.eval_imgs.shape[0] - 1)]
            gen = self.gen_imgs[i]
            if mask_ocean and self.lsm_imgs is not None:
                lsm = self.lsm_imgs[min(i, self.lsm_imgs.shape[0] - 1)]
                lsm = lsm[..., 0] if lsm.ndim == 3 else lsm
                ref = np.where(lsm > 0.5, ref, np.nan)
                gen = np.where(lsm > 0.5, gen, np.nan)
            axes[0][i].imshow(ref)
            axes[0][i].set_title("truth")
            axes[1][i].imshow(gen)
            axes[1][i].set_title("generated")
            for ax in (axes[0][i], axes[1][i]):
                ax.set_xticks([])
                ax.set_yticks([])
        path = os.path.join(self.fig_path, f"examples_{self.sample_type}.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        return path
