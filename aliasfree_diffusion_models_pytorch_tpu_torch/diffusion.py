"""DDPM process: schedule, forward noising, and the samplers.

Port of ``aliasfree_diffusion_models_pytorch_tpu/diffusion.py``: linear beta
schedule, forward noising ``sqrt(ᾱ_t)x + sqrt(1-ᾱ_t)ε``, ancestral sampling
(``sample``, ``revert``, ``sample_shift``), DDIM (``sample_ddim``) and
classifier-free guidance as one batch-doubled forward; images are NHWC as
there.

The JAX package's ``lax.scan`` compiles each static sampler configuration
into one program (``_jitted_run``, ``_jitted_ddim``). Here a configuration is
a :class:`_Sampler`: static buffers (the state x, the step index, the
schedule tables, the labels, the rotation operator, the handed-in noise) and
one reverse step that reads everything, t and its coefficients included, from
them on the device and moves the index on itself. On the card the step runs
as a CUDA graph (``utils/graphs.py``): eagerly on its first call, then
captured and replayed; ``Diffusion(graphs=False)`` runs the same step
eagerly. A configuration is kept per model, keyed as ``_jitted_run`` is keyed
(n, channels, the model's dtype, labels and the CFG scale, rotation on or off
and its operand's shape, handed-in noise or not), so a new θ, new labels or
new weights loaded in place reuse its graphs. Snapshots and the shift steps
stay decisions of the host between two steps.

Faithful quirks: the reverse loop runs ``noise_steps-1 … 1``; no noise at the
last step; with ``theta`` the per-step rotation is ``theta/noise_steps``, so
the total is ``theta·(N-1)/N`` (the dense operator up to 64 px, the gather
plan above: ``ops/rotation.py:build_rotation``); trajectory snapshots at every
``i % snapshot_every == 0`` plus the final state; ``to_uint8`` truncates.

Randomness: each sampler takes a ``torch.Generator`` (on the sampler's
device). ``noise_fn(shape, step)``, when given, supplies the noise instead:
``step`` 0 is the initial latent, step ``j ≥ 1`` the noise of the j-th
reverse step. Tests use it to hand in the exact noise of the JAX sampler.
A step whose noise is multiplied by zero draws none: it is a variant of its
own, a graph of its own where a loop takes it more than once (DDIM at η = 0)
and an eager step where it comes once (the last step of DDPM, of DDIM at
η > 0). The steps draw from the sampler's own generator, which
takes the caller's generator state for the loop and gives it back after, so
the caller's stream moves as if the loop had drawn from it.

The model is any callable ``model(x_nhwc, t[, y, y_mask]) -> eps`` (f32),
such as :class:`~aliasfree_diffusion_models_pytorch_tpu_torch.models.unet.UNet`.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Callable

import numpy as np
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.ops.resample import capture_key
from aliasfree_diffusion_models_pytorch_tpu_torch.ops.rotation import (
    GatherRotation,
    apply_pixel_operator,
    build_rotation,
    shift_nhwc,
)
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.graphs import GraphedStep

NoiseFn = Callable[[tuple, int], torch.Tensor]

# model -> {configuration key: _Sampler}. The samplers hold no reference to
# their model, so a configuration goes when its model does.
_SAMPLERS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _fields(rot):
    """The tensors of a rotation operand (dense matrix or gather plan)."""
    return (rot,) if isinstance(rot, torch.Tensor) else tuple(rot)


class _Sampler(GraphedStep):
    """One static sampler configuration: its buffers and its reverse step
    (``"ddpm"`` or ``"ddim"``), run eagerly or as CUDA graphs. The step's
    variant says whether it adds noise."""

    def __init__(self, kind: str, shape: tuple, device: torch.device, tables: dict,
                 labels: bool, cfg_scale, rot, noise_in: bool, graphs: bool):
        super().__init__(device, graphs)
        self.kind = kind
        self.shape = shape
        self.x = torch.empty(shape, dtype=torch.float32, device=device)
        self.index = torch.zeros(1, dtype=torch.long, device=device)  # the step, on the device
        self.tables = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                       for k, v in tables.items()}
        self.noise = torch.empty(shape, dtype=torch.float32, device=device) if noise_in else None
        n = shape[0]
        self.labels = torch.empty(n, dtype=torch.long, device=device) if labels else None
        self.cfg_scale = cfg_scale
        self.label_mask = None
        if cfg_scale is not None:
            # CFG: the conditional half keeps the label embedding, the other drops it.
            self.label_mask = torch.cat([torch.ones(n, device=device),
                                         torch.zeros(n, device=device)])
        self.rot = None
        if rot is not None:
            fields = [None if f is None else torch.empty_like(f) for f in _fields(rot)]
            self.rot = fields[0] if isinstance(rot, torch.Tensor) else GatherRotation(*fields)
        self.model = None  # bound for the length of a call (see bound)

    @contextlib.contextmanager
    def bound(self, model, tables: dict, labels, rot):
        """Copy this call's inputs into the static buffers and bind the model
        for the call."""
        for name, value in tables.items():
            self.tables[name].copy_(value)
        if labels is not None:
            self.labels.copy_(labels)
        if rot is not None:
            for dst, src in zip(_fields(self.rot), _fields(rot)):
                if dst is not None:
                    dst.copy_(src)
        self.model = model
        try:
            yield self
        finally:
            self.model = None

    def _eps(self, t):
        """Noise prediction, optionally conditional or CFG-guided: with a
        ``cfg_scale``, the conditional and unconditional branches run as ONE
        batch-doubled forward (label mask 1, then 0) combined as
        ``eps_u + s·(eps_c − eps_u)``."""
        x = self.x
        if self.labels is None:
            return self.model(x, t)
        if self.cfg_scale is None:
            return self.model(x, t, self.labels)
        n = x.shape[0]
        e = self.model(torch.cat([x, x]), torch.cat([t, t]),
                       torch.cat([self.labels, self.labels]), self.label_mask)
        e_c, e_u = e[:n], e[n:]
        return e_u + self.cfg_scale * (e_c - e_u)

    def _draw(self) -> torch.Tensor:
        if self.noise is not None:
            return self.noise
        return torch.randn(self.shape, generator=self.generator, dtype=torch.float32,
                           device=self.x.device)

    def _coef(self, name: str) -> torch.Tensor:
        """Entry ``index`` of a schedule table, as a (1,) tensor on the device."""
        return self.tables[name].index_select(0, self.index)

    def _finish(self, x: torch.Tensor) -> None:
        if self.rot is not None:
            x = apply_pixel_operator(x, self.rot)
        self.x.copy_(x)

    def step(self, noisy: bool) -> None:
        if self.kind == "ddpm":
            self._ddpm_step(noisy)
        else:
            self._ddim_step(noisy)

    def _ddpm_step(self, noisy: bool) -> None:
        """Reverse step ``i`` = index, then index ← i − 1."""
        eps = self._eps(self.index.expand(self.shape[0]))
        x = self._coef("inv_sqrt_alpha") * (self.x - self._coef("eps_coef") * eps)
        if noisy:
            x = x + self._coef("sqrt_beta") * self._draw()
        self._finish(x)
        self.index.sub_(1)

    def _ddim_step(self, noisy: bool) -> None:
        """DDIM step ``j`` = index (timestep ``taus[j]``), then index ← j + 1."""
        eps = self._eps(self._coef("taus").expand(self.shape[0]))
        x0 = (self.x - self._coef("sqrt_1m_ac") * eps) / self._coef("sqrt_ac")
        x = self._coef("sqrt_ap") * x0 + self._coef("dir_coeff") * eps
        if noisy:
            x = x + self._coef("sigma") * self._draw()
        self._finish(x)
        self.index.add_(1)


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
        graphs: bool = True,
    ):
        self.noise_steps = int(noise_steps)
        self.beta_start = float(beta_start)
        self.beta_end = float(beta_end)
        self.img_size = int(img_size)
        self.snapshot_every = int(snapshot_every)
        self.device = torch.device(device)
        # On the card the reverse steps run as CUDA graphs; False runs the
        # same steps eagerly (a yardstick for the graphed path, not a fallback).
        self.graphs = bool(graphs)
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

    def _sampler(self, model, kind: str, n: int, channels: int, tables: dict, labels,
                 cfg_scale, rot, noise_fn) -> _Sampler:
        """The configuration's :class:`_Sampler`, made at its first use."""
        param = next(model.parameters(), None) if isinstance(model, torch.nn.Module) else None
        key = (kind, n, channels, self.img_size, self.device,
               tuple((k, tuple(v.shape)) for k, v in tables.items()),
               None if param is None else param.dtype, labels is not None, cfg_scale,
               None if rot is None else tuple(None if f is None else (tuple(f.shape), f.dtype)
                                               for f in _fields(rot)),
               noise_fn is not None, capture_key(), self.graphs)
        per_model = _SAMPLERS.setdefault(model, {})
        sampler = per_model.get(key)
        if sampler is None:
            shape = (n, self.img_size, self.img_size, channels)
            sampler = per_model[key] = _Sampler(
                kind, shape, self.device, tables, labels is not None, cfg_scale, rot,
                noise_fn is not None, self.graphs)
        return sampler

    def _run(self, model, n: int, channels: int, generator, noise_fn, *, rot=None,
             shift=None, collect=True, labels=None, cfg_scale=None):
        """The ancestral loop shared by sample/revert/sample_shift; returns
        the final state and the stacked snapshots (or None)."""
        shape = (n, self.img_size, self.img_size, channels)
        tables = {"inv_sqrt_alpha": 1.0 / torch.sqrt(self.alpha),
                  "eps_coef": (1.0 - self.alpha) / torch.sqrt(1.0 - self.alpha_hat),
                  "sqrt_beta": torch.sqrt(self.beta)}
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

        s = self._sampler(model, "ddpm", n, channels, tables, labels, cfg_scale, rot, noise_fn)
        x = self._noise(shape, 0, generator, noise_fn)
        with s.bound(model, tables, labels, rot), s.drawing_from(generator):
            s.x.copy_(x)
            s.index.fill_(self.noise_steps - 1)
            for step, i in enumerate(range(self.noise_steps - 1, 0, -1), start=1):
                if i > 1:
                    if noise_fn is not None:
                        s.noise.copy_(self._noise(shape, step, generator, noise_fn))
                    s(True)
                else:
                    s.step(False)  # the last step draws no noise and comes once: eager
                if shift_mask is not None and shift_mask[i]:
                    s.x.copy_(shift_nhwc(s.x, shift_sign, 0))
                if collect and i % self.snapshot_every == 0:
                    snaps[num_mid - i // self.snapshot_every] = s.x.clone()
            x = s.x.clone()
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
        tables = {"taus": torch.from_numpy(np.ascontiguousarray(taus)),
                  "sqrt_1m_ac": torch.sqrt(1.0 - ac), "sqrt_ac": torch.sqrt(ac),
                  "sqrt_ap": torch.sqrt(ap),
                  "dir_coeff": torch.sqrt(torch.clamp(1.0 - ap - sigma**2, min=0.0)),
                  "sigma": sigma}
        rot = None
        if theta is not None:
            total = float(theta) * (self.noise_steps - 1) / self.noise_steps
            rot = build_rotation(self.img_size, total / len(taus), rotation_order, self.device)

        shape = (n, self.img_size, self.img_size, image_channels)
        s = self._sampler(model, "ddim", n, image_channels, tables, labels, cfg_scale, rot,
                          noise_fn)
        x = self._noise(shape, 0, generator, noise_fn)
        with s.bound(model, tables, labels, rot), s.drawing_from(generator):
            s.x.copy_(x)
            s.index.zero_()
            noisy = (sigma != 0.0).tolist()
            once = {draws for draws in (True, False) if noisy.count(draws) == 1}
            for j, draws in enumerate(noisy):
                if draws and noise_fn is not None:
                    s.noise.copy_(self._noise(shape, j + 1, generator, noise_fn))
                if draws in once:
                    s.step(draws)  # a variant that comes once a call: eager
                else:
                    s(draws)
            x = s.x.clone()
        return self.to_uint8(x)
