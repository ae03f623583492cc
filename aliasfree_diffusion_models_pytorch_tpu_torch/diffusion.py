"""DDPM process: schedule, forward noising, and the samplers.

Port of ``aliasfree_diffusion_models_pytorch_tpu/diffusion.py``: linear beta
schedule, forward noising ``sqrt(ᾱ_t)x + sqrt(1-ᾱ_t)ε``, ancestral sampling
(``sample``, ``revert``, ``sample_shift``), DDIM (``sample_ddim``) and
classifier-free guidance as one batch-doubled forward. The JAX package's
``lax.scan`` is a Python loop here; images are NHWC as there.

Faithful quirks: the reverse loop runs ``noise_steps-1 … 1``; no noise at the
last step; with ``theta`` the per-step rotation is ``theta/noise_steps``, so
the total is ``theta·(N-1)/N`` (the dense operator up to 64 px, the gather
plan above: ``ops/rotation.py:build_rotation``); trajectory snapshots at every
``i % snapshot_every == 0`` plus the final state; ``to_uint8`` truncates.

Randomness: each sampler takes a ``torch.Generator`` (on the sampler's
device). ``noise_fn(shape, step)``, when given, supplies the noise instead:
``step`` 0 is the initial latent, step ``j ≥ 1`` the noise of the j-th
reverse step. Tests use it to hand in the exact noise of the JAX sampler.
A step whose noise is multiplied by zero draws none.

The model is any callable ``model(x_nhwc, t[, y, y_mask]) -> eps`` (f32),
such as :class:`~aliasfree_diffusion_models_pytorch_tpu_torch.models.unet.UNet`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.ops.rotation import (
    apply_pixel_operator,
    build_rotation,
    shift_nhwc,
)

NoiseFn = Callable[[tuple, int], torch.Tensor]


class Diffusion:
    """Linear-schedule DDPM process over NHWC images on ``device``."""

    def __init__(
        self,
        noise_steps: int = 1000,
        beta_start: float = 1e-4,
        beta_end: float = 0.02,
        img_size: int = 256,
        snapshot_every: int = 100,
        device="cuda",
    ):
        self.noise_steps = int(noise_steps)
        self.beta_start = float(beta_start)
        self.beta_end = float(beta_end)
        self.img_size = int(img_size)
        self.snapshot_every = int(snapshot_every)
        self.device = torch.device(device)
        # float32 linspace and cumprod — the reference's own schedule.
        self.beta = torch.linspace(beta_start, beta_end, noise_steps, dtype=torch.float32)
        self.alpha = 1.0 - self.beta
        self.alpha_hat = torch.cumprod(self.alpha, dim=0)
        self._alpha_hat_dev = self.alpha_hat  # copy on the device last noised on

    # ------------------------------------------------------------------
    # Forward process
    # ------------------------------------------------------------------

    def sample_timesteps(self, n: int, generator=None) -> torch.Tensor:
        """Uniform t in [1, noise_steps): t = 0 is never trained."""
        return torch.randint(1, self.noise_steps, (n,), generator=generator,
                             device=self.device)

    def noise_images(self, x: torch.Tensor, t: torch.Tensor, generator=None, noise=None):
        """q(x_t | x_0): returns (x_t, eps). x is NHWC in [-1, 1]. ``noise``,
        when given, is used as eps instead of a draw from ``generator``."""
        if self._alpha_hat_dev.device != x.device:
            self._alpha_hat_dev = self.alpha_hat.to(x.device)
        ah = self._alpha_hat_dev[t]
        eps = noise
        if eps is None:
            eps = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        return (torch.sqrt(ah)[:, None, None, None] * x
                + torch.sqrt(1.0 - ah)[:, None, None, None] * eps), eps

    # ------------------------------------------------------------------
    # Reverse process
    # ------------------------------------------------------------------

    def _noise(self, shape, step: int, generator, noise_fn: NoiseFn | None):
        if noise_fn is not None:
            return torch.as_tensor(noise_fn(tuple(shape), step), dtype=torch.float32,
                                   device=self.device)
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=self.device)

    def _eps_fn(self, model, n: int, labels, cfg_scale):
        """Noise prediction, optionally conditional or CFG-guided: with a
        ``cfg_scale``, the conditional and unconditional branches run as ONE
        batch-doubled forward (label mask 1, then 0) combined as
        ``eps_u + s·(eps_c − eps_u)``."""
        if labels is None:
            return lambda x, t: model(x, t)
        if cfg_scale is None:
            return lambda x, t: model(x, t, labels)
        yy = torch.cat([labels, labels])
        mm = torch.cat([torch.ones(n, device=self.device), torch.zeros(n, device=self.device)])

        def eps(x, t):
            e = model(torch.cat([x, x]), torch.cat([t, t]), yy, mm)
            e_c, e_u = e[:n], e[n:]
            return e_u + cfg_scale * (e_c - e_u)

        return eps

    def _labels(self, labels, n: int, cfg_scale):
        if labels is None:
            if cfg_scale is not None:
                raise ValueError("cfg_scale requires labels")
            return None
        labels = torch.as_tensor(labels, dtype=torch.long, device=self.device)
        if labels.dim() == 0:
            labels = labels.expand(n)
        if labels.shape != (n,):
            raise ValueError(f"labels must be scalar or shape ({n},), got {tuple(labels.shape)}")
        return labels

    def _run(self, model, n: int, channels: int, generator, noise_fn, *, rot=None,
             shift=None, collect=True, labels=None, cfg_scale=None):
        """The ancestral loop shared by sample/revert/sample_shift; returns
        the final state and the stacked snapshots (or None)."""
        shape = (n, self.img_size, self.img_size, channels)
        eps_fn = self._eps_fn(model, n, labels, cfg_scale)
        inv_sqrt_alpha = (1.0 / torch.sqrt(self.alpha)).tolist()
        eps_coef = ((1.0 - self.alpha) / torch.sqrt(1.0 - self.alpha_hat)).tolist()
        sqrt_beta = torch.sqrt(self.beta).tolist()
        shift_mask = None
        if shift:
            # Reference precomputation: indices where a 1-px shift fires,
            # first partition excluded.
            dur = abs(shift) / self.noise_steps
            idx = np.round(np.arange(0, self.noise_steps, dur)).astype(int)[1:]
            shift_mask = np.zeros(self.noise_steps, dtype=bool)
            shift_mask[idx[idx < self.noise_steps]] = True
            shift_sign = int(np.sign(shift))
        num_mid = (self.noise_steps - 1) // self.snapshot_every
        snaps = [None] * (num_mid + 1)

        x = self._noise(shape, 0, generator, noise_fn)
        for step, i in enumerate(range(self.noise_steps - 1, 0, -1), start=1):
            t = torch.full((n,), i, dtype=torch.long, device=self.device)
            eps = eps_fn(x, t)
            x = inv_sqrt_alpha[i] * (x - eps_coef[i] * eps)
            if i > 1:  # no noise at the last step
                x = x + sqrt_beta[i] * self._noise(shape, step, generator, noise_fn)
            if rot is not None:
                x = apply_pixel_operator(x, rot)
            if shift_mask is not None and shift_mask[i]:
                x = shift_nhwc(x, shift_sign, 0)
            if collect and i % self.snapshot_every == 0:
                snaps[num_mid - i // self.snapshot_every] = x
        snaps[num_mid] = x
        return x, (torch.stack(snaps) if collect else None)

    @staticmethod
    def to_uint8(x: torch.Tensor) -> torch.Tensor:
        """clamp[-1,1] → [0,255] uint8, truncating like torch's ``.type``."""
        x = (torch.clamp(x, -1.0, 1.0) + 1.0) / 2.0
        return (x * 255.0).to(torch.uint8)

    @torch.inference_mode()
    def sample(self, model, n: int, image_channels: int, generator=None,
               theta: float | None = None, rotation_order: int = 3, labels=None,
               cfg_scale: float | None = None, noise_fn: NoiseFn | None = None):
        """Ancestral sampling; returns ``(final_uint8, trajectory_uint8)``.

        ``trajectory`` stacks the snapshots (every ``snapshot_every`` steps)
        and the final state along the batch axis: ``((snaps)*n, H, W, C)``.
        ``theta`` adds the Config-E per-step rotation; ``labels`` (scalar or
        (n,)) and ``cfg_scale`` select conditional / guided sampling.
        """
        labels = self._labels(labels, n, cfg_scale)
        rot = None
        if theta is not None:
            rot = build_rotation(self.img_size, float(theta) / self.noise_steps,
                                 rotation_order, self.device)
        x, snaps = self._run(model, n, image_channels, generator, noise_fn, rot=rot,
                             labels=labels, cfg_scale=cfg_scale)
        traj = snaps.reshape((-1,) + snaps.shape[2:])
        return self.to_uint8(x), self.to_uint8(traj)

    @torch.inference_mode()
    def revert(self, model, n: int, image_channels: int, generator=None,
               noise_fn: NoiseFn | None = None):
        """Trajectory-only denoising demo."""
        _, snaps = self._run(model, n, image_channels, generator, noise_fn)
        return self.to_uint8(snaps.reshape((-1,) + snaps.shape[2:]))

    @torch.inference_mode()
    def sample_shift(self, model, n: int, image_channels: int, generator=None,
                     shift: int | None = None, noise_fn: NoiseFn | None = None):
        """Translation sampling: a ±``shift``-pixel horizontal roll spread
        over the steps (reference "under development")."""
        x, _ = self._run(model, n, image_channels, generator, noise_fn,
                         shift=shift or None, collect=False)
        return self.to_uint8(x)

    # ------------------------------------------------------------------
    # DDIM (Song et al. 2021)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def sample_ddim(self, model, n: int, image_channels: int, generator=None,
                    steps: int = 50, eta: float = 0.0, theta: float | None = None,
                    rotation_order: int = 3, labels=None, cfg_scale: float | None = None,
                    noise_fn: NoiseFn | None = None):
        """DDIM over a strided timestep subsequence; returns final uint8
        images ``(n, H, W, C)``. ``eta=0`` is the deterministic ODE, ``eta=1``
        DDPM-like noise. With ``theta`` the total rotation equals the DDPM
        sampler's ``theta·(N-1)/N``, spread over the steps."""
        labels = self._labels(labels, n, cfg_scale)
        steps = int(steps)
        if not 1 <= steps < self.noise_steps:
            raise ValueError(f"steps must be in [1, noise_steps), got {steps}")
        taus = np.unique(
            np.round(np.linspace(self.noise_steps - 1, 1, steps)).astype(np.int64)
        )[::-1]
        ahat = self.alpha_hat.numpy().astype(np.float64)
        ac = torch.tensor(ahat[taus], dtype=torch.float32)
        ap = torch.tensor(np.concatenate([ahat[taus[1:]], [1.0]]), dtype=torch.float32)
        sigma = eta * torch.sqrt(
            torch.clamp((1.0 - ap) / (1.0 - ac), min=0.0) * torch.clamp(1.0 - ac / ap, min=0.0))
        dir_coeff = torch.sqrt(torch.clamp(1.0 - ap - sigma**2, min=0.0)).tolist()
        sqrt_1m_ac = torch.sqrt(1.0 - ac).tolist()
        sqrt_ac = torch.sqrt(ac).tolist()
        sqrt_ap = torch.sqrt(ap).tolist()
        sigma = sigma.tolist()
        rot = None
        if theta is not None:
            total = float(theta) * (self.noise_steps - 1) / self.noise_steps
            rot = build_rotation(self.img_size, total / len(taus), rotation_order, self.device)

        shape = (n, self.img_size, self.img_size, image_channels)
        eps_fn = self._eps_fn(model, n, labels, cfg_scale)
        x = self._noise(shape, 0, generator, noise_fn)
        for j, t in enumerate(taus.tolist()):
            eps = eps_fn(x, torch.full((n,), t, dtype=torch.long, device=self.device))
            x0 = (x - sqrt_1m_ac[j] * eps) / sqrt_ac[j]
            x = sqrt_ap[j] * x0 + dir_coeff[j] * eps
            if sigma[j] != 0.0:
                x = x + sigma[j] * self._noise(shape, j + 1, generator, noise_fn)
            if rot is not None:
                x = apply_pixel_operator(x, rot)
        return self.to_uint8(x)
