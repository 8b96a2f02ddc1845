"""VE and VP SDEs and the EDM sigma grid (counterpart of ``sbgm_danra_tpu/sde.py:33-149``).

Every method takes a tensor or a Python float and returns a float32 tensor on
the input's device; the arithmetic follows the JAX package's order of
operations so that float32 results agree to the last bits. ``dsm_loss`` and
``sdf_weights`` come with the training port.
"""

from __future__ import annotations

import dataclasses

import torch


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class VESDE:
    """Variance-Exploding SDE: dx = sigma^t dW, sigma(t)^2 = (sigma^(2t) - 1) / (2 ln sigma)."""

    sigma: float = 25.0
    std_eps: float = 1e-5

    def _log_sigma(self) -> torch.Tensor:
        return torch.log(_f32(self.sigma))

    def marginal_prob_std(self, t) -> torch.Tensor:
        t = _f32(t)
        log_sigma = self._log_sigma()
        sigma_t_sq = torch.exp(2.0 * t * log_sigma)
        std = torch.sqrt((sigma_t_sq - 1.0) / (2.0 * log_sigma))
        return torch.clamp(std, min=self.std_eps)

    def marginal_prob_mean_coeff(self, t) -> torch.Tensor:
        return torch.ones_like(_f32(t))

    def diffusion_coeff(self, t) -> torch.Tensor:
        return torch.pow(self.sigma, _f32(t))

    def drift(self, x: torch.Tensor, t) -> torch.Tensor:
        return torch.zeros_like(x)

    def prior_std(self) -> torch.Tensor:
        return self.marginal_prob_std(1.0)

    def inverse_std(self, std) -> torch.Tensor:
        """t = ln(1 + 2 ln(sigma) std^2) / (2 ln sigma), the exact inverse of the std."""
        std = _f32(std)
        log_sigma = self._log_sigma()
        return torch.log1p(2.0 * log_sigma * std**2) / (2.0 * log_sigma)

    def inverse_hat_std(self, hat_std) -> torch.Tensor:
        return self.inverse_std(hat_std)


@dataclasses.dataclass(frozen=True)
class VPSDE:
    """Variance-Preserving SDE with linear beta(t) = beta_min + t (beta_max - beta_min)."""

    beta_min: float = 0.1
    beta_max: float = 20.0
    std_eps: float = 1e-5

    def _log_mean_coeff(self, t) -> torch.Tensor:
        t = _f32(t)
        return -0.25 * t**2 * (self.beta_max - self.beta_min) - 0.5 * t * self.beta_min

    def marginal_prob_std(self, t) -> torch.Tensor:
        std = torch.sqrt(1.0 - torch.exp(2.0 * self._log_mean_coeff(t)))
        return torch.clamp(std, min=self.std_eps)

    def marginal_prob_mean_coeff(self, t) -> torch.Tensor:
        return torch.exp(self._log_mean_coeff(t))

    def _beta(self, t) -> torch.Tensor:
        return self.beta_min + _f32(t) * (self.beta_max - self.beta_min)

    def diffusion_coeff(self, t) -> torch.Tensor:
        return torch.sqrt(self._beta(t))

    def drift(self, x: torch.Tensor, t) -> torch.Tensor:
        beta_t = self._beta(t).to(x.device)
        return -0.5 * beta_t.reshape((-1,) + (1,) * (x.dim() - 1)) * x

    def prior_std(self) -> torch.Tensor:
        return _f32(1.0)

    def inverse_std(self, std) -> torch.Tensor:
        """Positive root of (bmax - bmin)/2 t^2 + bmin t + ln(1 - std^2) = 0."""
        std = _f32(std)
        a = 0.5 * (self.beta_max - self.beta_min)
        b = _f32(self.beta_min)
        c = torch.log1p(-torch.clamp(std**2, 0.0, 1.0 - 1e-7))
        return (-b + torch.sqrt(b**2 - 4.0 * a * c)) / (2.0 * a)

    def inverse_hat_std(self, hat_std) -> torch.Tensor:
        """Positive root of (bmax - bmin)/2 t^2 + bmin t - ln(1 + hat_std^2) = 0."""
        hat_std = _f32(hat_std)
        a = 0.5 * (self.beta_max - self.beta_min)
        b = _f32(self.beta_min)
        c = -torch.log1p(hat_std**2)
        return (-b + torch.sqrt(b**2 - 4.0 * a * c)) / (2.0 * a)


def edm_sigma_schedule(
    n_steps: int, sigma_min=0.002, sigma_max=80.0, rho: float = 7.0
) -> torch.Tensor:
    """Karras et al. rho-schedule, float32 on the CPU."""
    i = torch.linspace(0.0, 1.0, n_steps, dtype=torch.float32)
    inv_rho = 1.0 / rho
    smax, smin = _f32(sigma_max), _f32(sigma_min)
    return (smax**inv_rho + i * (smin**inv_rho - smax**inv_rho)) ** rho

