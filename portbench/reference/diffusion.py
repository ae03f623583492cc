"""The noise schedule, forward noising, the reverse updates and the uint8
conversion, as the reference model's DDPM process defines them.

Linear betas from ``beta_start`` to ``beta_end`` over ``noise_steps``
(float32 linspace), alphas and their cumulative product (float32 cumprod).
DDPM runs t = N−1 … 1 and draws no noise at t = 1:
``x ← (x − β_t/sqrt(1 − ᾱ_t)·ε)/sqrt(α_t) + sqrt(β_t)·z``. DDIM takes the
steps ``round(linspace(N−1, 1, k))``, unique and descending, with ᾱ_prev of
the next of them and 1 after the last:
``x0 = (x − sqrt(1 − ᾱ)·ε)/sqrt(ᾱ)``, ``x ← sqrt(ᾱ_prev)·x0 + sqrt(1 − ᾱ_prev − σ²)·ε + σ·z``
with ``σ = η·sqrt((1 − ᾱ_prev)/(1 − ᾱ)·(1 − ᾱ/ᾱ_prev))``.
Images: clamp to [−1, 1], ``(x + 1)/2·255``, truncated to uint8.
"""

from __future__ import annotations

import numpy as np
import torch


class Schedule:
    def __init__(self, cfg: dict):
        n = int(cfg["noise_steps"])
        self.noise_steps = n
        self.beta = torch.linspace(cfg["beta_start"], cfg["beta_end"], n, dtype=torch.float32)
        self.alpha = 1.0 - self.beta
        self.alpha_hat = torch.cumprod(self.alpha, dim=0)

    def noise_images(self, x, t, eps):
        ah = self.alpha_hat.to(x.device)[t]
        return (torch.sqrt(ah)[:, None, None, None] * x
                + torch.sqrt(1.0 - ah)[:, None, None, None] * eps)

    def ddpm_update(self, x, eps, t: torch.Tensor, z):
        """One reverse step at the timesteps ``t`` (B,), ``z`` None for no noise."""
        dev = x.device
        inv_sqrt_alpha = (1.0 / torch.sqrt(self.alpha)).to(dev)[t][:, None, None, None]
        eps_coef = ((1.0 - self.alpha) / torch.sqrt(1.0 - self.alpha_hat)).to(dev)[t]
        out = inv_sqrt_alpha * (x - eps_coef[:, None, None, None] * eps)
        if z is not None:
            out = out + torch.sqrt(self.beta).to(dev)[t][:, None, None, None] * z
        return out

    def ddim_taus(self, steps: int) -> np.ndarray:
        n = self.noise_steps
        return np.unique(np.round(np.linspace(n - 1, 1, steps)).astype(np.int64))[::-1].copy()

    def ddim_update(self, x, eps, j: torch.Tensor, taus: np.ndarray, eta: float, z):
        """DDIM step number ``j`` (B,) of the subsequence ``taus``."""
        ahat = self.alpha_hat.numpy().astype(np.float64)
        ac = torch.tensor(ahat[taus], dtype=torch.float32)
        ap = torch.tensor(np.concatenate([ahat[taus[1:]], [1.0]]), dtype=torch.float32)
        sigma = eta * torch.sqrt(torch.clamp((1.0 - ap) / (1.0 - ac), min=0.0)
                                 * torch.clamp(1.0 - ac / ap, min=0.0))
        dir_coef = torch.sqrt(torch.clamp(1.0 - ap - sigma**2, min=0.0))

        def at(v):
            return v.to(x.device)[j][:, None, None, None]

        x0 = (x - at(torch.sqrt(1.0 - ac)) * eps) / at(torch.sqrt(ac))
        out = at(torch.sqrt(ap)) * x0 + at(dir_coef) * eps
        if z is not None:
            out = out + at(sigma) * z
        return out


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    x = (torch.clamp(x, -1.0, 1.0) + 1.0) / 2.0
    return (x * 255.0).to(torch.uint8)
