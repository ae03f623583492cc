"""The reference train step: MSE on the noise, AdamW, EMA.

Per step: ``x_t = sqrt(ᾱ_t)·x + sqrt(1 − ᾱ_t)·ε``; the loss is the batch mean
of each image's mean squared error between ε and the model's prediction;
the gradient is that of the whole batch (taken in blocks of rows, which
changes nothing: every image's loss depends on its own row alone); an
optional clip to a global norm; AdamW with decoupled weight decay
(``p ← p·(1 − lr·wd)``, then ``p ← p − lr/(1 − β1ᵗ)·m/(sqrt(v/(1 − β2ᵗ)) + eps)``);
the EMA copies the parameters while the run's step count is under
``ema_start_steps`` and blends ``ema·β + p·(1 − β)`` after. All in float32.
"""

from __future__ import annotations

import torch

from portbench.reference import unet as ref_unet
from portbench.reference.diffusion import Schedule
from portbench.reference.precision import F32


class AdamW:
    def __init__(self, params: dict, cfg: dict):
        opt = cfg["adamw"]
        self.lr, self.eps, self.wd = cfg["lr"], opt["eps"], opt["weight_decay"]
        self.b1, self.b2 = opt["betas"]
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for n, p in params.items():
            g = grads[n]
            p.mul_(1.0 - self.lr * self.wd)
            self.m[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[n] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-self.lr / c1)


def loss_and_grads(params: dict, model: ref_unet.Model, schedule: Schedule, x, t, eps,
                   prec=F32, block: int = 64) -> tuple[float, dict]:
    """The batch's loss and the gradient of every parameter."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    total, n = 0.0, x.shape[0]
    for lo in range(0, n, block):
        sl = slice(lo, lo + block)
        x_t = schedule.noise_images(x[sl], t[sl], eps[sl])
        pred = ref_unet.forward(leaves, model, x_t, t[sl], prec)
        loss = ((eps[sl] - pred) ** 2).mean(dim=(1, 2, 3)).sum() / n
        got = torch.autograd.grad(loss, list(leaves.values()))
        for name, g in zip(leaves, got):
            grads[name] += g
        total += float(loss.detach())
    return total, grads


def clipped(grads: dict, cfg: dict) -> dict:
    """The gradients as the optimizer gets them: clipped to the global norm
    ``grad_clip``, where the configuration sets one."""
    if cfg.get("grad_clip") is None:
        return grads
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
    scale = cfg["grad_clip"] / torch.clamp(norm, min=cfg["grad_clip"])
    return {n: g * scale for n, g in grads.items()}


def grads_at(params: dict, model: ref_unet.Model, cfg: dict, x, draw, prec=F32) -> dict:
    """One step's gradients as the optimizer gets them, at ``params``."""
    t, eps = draw
    return clipped(loss_and_grads(params, model, Schedule(cfg), x, t, eps, prec)[1], cfg)


def predict(params: dict, model: ref_unet.Model, x_t, t, prec=F32, block: int = 64):
    """The model's prediction at ``params`` for every row, in blocks of rows."""
    with torch.no_grad():
        return torch.cat([ref_unet.forward(params, model, x_t[i:i + block], t[i:i + block], prec)
                          for i in range(0, len(x_t), block)])


def run(params0: dict, model: ref_unet.Model, cfg: dict, batches: list, draws: list,
        prec=F32, alter=None, start_step: int = 0) -> dict:
    """Follow ``len(batches)`` steps from ``params0`` and an EMA equal to it,
    the run's step count starting at ``start_step``; ``draws`` gives each
    step's (t, ε). Returns the losses, every step's x_t (``x_t``) and
    gradients as the optimizer got them (``grads``), the parameters before
    every step (``before``), and the parameters and EMA after the last
    step.
    ``alter(step, grads)``, when given, changes the gradients where they are
    made (a planted fault)."""
    schedule = Schedule(cfg)
    params = {n: p.detach().clone() for n, p in params0.items()}
    ema = {n: p.clone() for n, p in params.items()}
    opt = AdamW(params, cfg)
    losses, all_grads, before, x_ts = [], [], [], []
    for step, (x, (t, eps)) in enumerate(zip(batches, draws)):
        before.append({n: p.clone() for n, p in params.items()})
        x_ts.append(schedule.noise_images(x, t, eps))
        loss, grads = loss_and_grads(params, model, schedule, x, t, eps, prec)
        if alter is not None:
            grads = alter(step, grads)
        grads = clipped(grads, cfg)
        all_grads.append(grads)
        with torch.no_grad():
            opt.step(params, grads)
            if cfg["use_ema"]:
                for n, p in params.items():
                    if start_step + step < cfg["ema_start_steps"]:
                        ema[n].copy_(p)
                    else:
                        ema[n].mul_(cfg["ema_beta"]).add_(p, alpha=1.0 - cfg["ema_beta"])
        losses.append(loss)
    return {"losses": losses, "x_t": x_ts, "grads": all_grads, "before": before,
            "params": params, "ema": ema}
