"""Training loop: AdamW + MSE-on-ε.

Counterpart of ``aliasfree_diffusion_models_pytorch_tpu/train.py``. Per step:
draw ``t ∈ [1, noise_steps)``, forward-noise the batch, predict the noise
with the UNet, MSE on the f32 prediction, backward, AdamW update, EMA. Per
epoch: the mean loss is recorded, ``image_gen_n`` samples are saved as a
grid, and the checkpoint is written.

The step. The JAX package jits its step into one donated program. Here the
step reads its inputs from static buffers (batch, labels, ``n_real``, and
``t``, noise and the CFG keep-mask where they are handed in), one set for
each batch shape and set of inputs, and on the card runs as a CUDA graph
(``utils/graphs.py``): forward, backward, the f32 gradient cast, clip, AdamW
and EMA in one replay. The host chooses the branch (the accumulation
window's position, which decides between accumulating and updating, and
whether the EMA copies or blends) and fills the learning rate into the
optimizer's device tensor before the step; each branch is a graph of its
own. ``make_train_step(graphs=False)`` runs the same step eagerly. A graphed
step is bound to the :class:`TrainState` of its first call and to the tensors
that state holds then: load weights and optimizer state into it before the
first step, in place (``TrainState.load``, ``utils/checkpoint.load_opt_state``).

Precision. The master parameters, AdamW's moments and the EMA are f32. The
UNet computes in ``compute_dtype``: before each forward the compute model's
parameters are refreshed from the masters (a cast to bf16, or a plain copy in
f32), and after the backward their gradients are cast back to f32 for the
optimizer. That is what the JAX package does by casting each f32 parameter
where it is used. ``torch.autocast`` is not used: its rules for norms and
softmax differ.

Optimizer. ``torch.optim.AdamW`` with betas 0.9/0.999, eps 1e-8, weight decay
1e-2 and a constant lr by default; on the card it is ``capturable`` (its step
count and its lr are device tensors, which a replayed update reads), on the
CPU the plain one with a float lr (PyTorch refuses ``capturable`` there).
Opt-in through ``TrainConfig``:
``lr_schedule="warmup_cosine"`` (linear 0 → lr over ``warmup_steps`` updates,
cosine down to ``lr·lr_min_ratio`` at ``lr_total_steps``), ``grad_clip``
(global-norm clip, scale ``clip / max(norm, clip)``, applied to the averaged
gradient) and ``grad_accum=k`` (the gradients of k micro-batches are averaged
and the update happens on every k-th).

Randomness. One ``torch.Generator`` on the training device, re-seeded for
every step from ``(seed + 1, global step)``: a resumed run draws what an
unbroken one would. The step function also takes ``t``, ``noise`` and ``keep``
directly, which the tests use to hand in another framework's draws.

Resume. ``train(resume=True)`` restores the parameters, the EMA and the step
count, and with ``config.checkpoint_opt_state`` AdamW's moments, the update
count and the open accumulation window (``utils/checkpoint.py``); it adopts
the stored cosine horizon (:func:`recover_stored_config`), and its epochs are
numbered on from the epoch the checkpoint stopped in, where the dataloader
goes on too. So N epochs and N = k + (N − k) with a resume between take the
same steps on the same data at the same learning rates, and the resumed run's
sample grids do not write over the first run's.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from typing import Callable

import numpy as np
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.config import TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.data import Dataloader, PrefetchLoader
from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import UNet, build_model, param_count
from aliasfree_diffusion_models_pytorch_tpu_torch.ops.resample import fg_impl_override
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.graphs import GraphedStep

logger = logging.getLogger(__name__)

STEP_START_EMA = 2000  # micro-batches during which the EMA copies the parameters
LOG_EVERY = 50  # steps between two loss records in metrics.jsonl
PROFILE_STEPS = (10, 20)  # the steps of a call that ``profile_dir`` traces


def lr_at(config: TrainConfig, update: int) -> float:
    """Learning rate of optimizer update number ``update`` (0-based)."""
    if config.lr_schedule == "constant":
        return config.lr
    if config.lr_total_steps is None:
        raise ValueError(
            "lr_schedule='warmup_cosine' needs a decay horizon: set "
            "TrainConfig.lr_total_steps (in optimizer updates) or use "
            "train(), which derives it from the dataloader"
        )
    warmup, total = config.warmup_steps, int(config.lr_total_steps)
    if update < warmup:
        return config.lr * update / warmup
    decay_steps = total - warmup
    if decay_steps <= 0:
        raise ValueError(
            f"lr_total_steps ({total}) must exceed warmup_steps ({warmup})")
    count = min(update - warmup, decay_steps)
    cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
    return config.lr * ((1.0 - config.lr_min_ratio) * cosine + config.lr_min_ratio)


def make_optimizer(config: TrainConfig, params, capturable: bool | None = None
                   ) -> torch.optim.AdamW:
    """AdamW over ``params`` (f32 tensors that carry ``.grad``) with the
    reference's hyperparameters; the step sets each update's lr (:func:`lr_at`).
    ``capturable`` (default: the params lie on the card) keeps the step count
    on the device and takes the lr as a device tensor, so that a CUDA graph
    can replay the update."""
    params = list(params)
    if capturable is None:
        capturable = params[0].device.type == "cuda"
    lr = (torch.tensor(config.lr, dtype=torch.float32, device=params[0].device)
          if capturable else config.lr)
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2,
                             capturable=capturable)


def _set_lr(optimizer: torch.optim.Optimizer, value: float) -> None:
    """The next update's lr: filled into a device lr, set as a float lr."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(value)
        else:
            group["lr"] = value


def recover_stored_config(config: TrainConfig, root: str = ".") -> TrainConfig:
    """Adopt the ``base_width`` and ``lr_total_steps`` stored beside an
    existing checkpoint (the JAX package's ``recover_base_width`` adopts the
    width alone).

    ``train()`` writes the full config to ``models/<run>/config.json``. The
    checkpoint's weights fix the width, and the run that wrote it fixed the
    cosine horizon (derived from that run's own ``epochs`` unless given), so
    on restore the stored values win over the ones passed in: a resumed run
    goes on along the schedule it started on. The JAX package re-derives the
    horizon from the resumed call's ``epochs`` (JAX ``train.py:388-398``); the
    port keeps the stored one.
    """
    cfg_path = os.path.join(config.model_dir(root), "config.json")
    if not os.path.exists(cfg_path):
        return config
    try:
        with open(cfg_path) as f:
            stored = json.load(f)
    except (OSError, ValueError):
        return config
    for field in ("base_width", "lr_total_steps"):
        if field not in stored or (field == "lr_total_steps" and stored[field] is None):
            continue
        value = None if stored[field] is None else int(stored[field])
        if value != getattr(config, field):
            logger.info("restoring with %s=%s from %s (overrides %s)",
                        field, value, cfg_path, getattr(config, field))
            config = dataclasses.replace(config, **{field: value})
    return config


class EMA:
    """Reference-API EMA helper on ``state_dict``-like dicts of tensors:
    ``step_ema`` copies the parameters for the first ``step_start_ema`` calls,
    then blends ``old·beta + new·(1 − beta)``. The training loop uses the
    in-step version (:func:`make_train_step`); this class is for code that
    drives the EMA by hand."""

    def __init__(self, beta: float):
        self.beta = beta
        self.step = 0

    def update_model_average(self, ema_params, params):
        return {k: ema_params[k] * self.beta + (1.0 - self.beta) * params[k] for k in params}

    def step_ema(self, ema_params, params, step_start_ema: int = STEP_START_EMA):
        self.step += 1
        if self.step <= step_start_ema:
            return {k: v.clone() for k, v in params.items()}
        return self.update_model_average(ema_params, params)


@dataclasses.dataclass
class TrainState:
    """What a step updates, in place: the f32 master parameters and EMA (by
    ``state_dict`` name), the optimizer, the gradient accumulator and the
    counters. ``step`` counts micro-batches."""

    params: dict[str, torch.Tensor]
    ema_params: dict[str, torch.Tensor]
    optimizer: torch.optim.AdamW
    grad_acc: list[torch.Tensor] | None  # running mean over the window; None if grad_accum == 1
    step: int = 0
    mini_step: int = 0  # micro-batches in the open accumulation window
    updates: int = 0    # optimizer updates so far

    def load(self, params, ema_params, step: int) -> None:
        """Overwrite parameters, EMA and step count (checkpoint restore)."""
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(params[name])
                self.ema_params[name].copy_(ema_params[name])
        self.step = int(step)


def create_train_state(config: TrainConfig, device="cuda",
                       state_dict=None) -> tuple[UNet, TrainState]:
    """The compute model (in ``compute_dtype`` on ``device``) and a fresh
    :class:`TrainState`. Weights come from ``state_dict`` or, without one,
    from ``utils.weights.init_params(config, config.seed)``."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import init_params

    if state_dict is None:
        state_dict = init_params(config, config.seed)
    model = build_model(config, device=device, state_dict=state_dict)
    names = [name for name, _ in model.named_parameters()]
    params = {n: state_dict[n].detach().to(device=device, dtype=torch.float32).clone()
              for n in names}
    ema = {n: p.clone() for n, p in params.items()}
    grad_acc = None
    if config.grad_accum > 1:
        grad_acc = [torch.zeros_like(p) for p in params.values()]
    return model, TrainState(params=params, ema_params=ema,
                             optimizer=make_optimizer(config, params.values()),
                             grad_acc=grad_acc)


class _StepInputs(GraphedStep):
    """The static buffers of one train-step signature (batch shape and which
    inputs are given), whose branches ``run(inputs, variant)`` runs eagerly
    or as CUDA graphs."""

    def __init__(self, batch, labels, n_real, t, noise, keep, device, run, graphs: bool):
        super().__init__(device, graphs)

        def like(value, dtype):
            if value is None:
                return None
            return torch.empty(tuple(torch.as_tensor(value).shape), dtype=dtype, device=device)

        self.batch = like(batch, batch.dtype)
        self.labels = like(labels, torch.long)
        self.n_real = like(n_real, torch.long)
        self.t = like(t, torch.long)
        self.noise = like(noise, torch.float32)
        self.keep = like(keep, torch.float32)
        self.loss = torch.zeros((), dtype=torch.float32, device=device)
        self._run = run

    def step(self, variant) -> None:
        self._run(self, variant)

    def fill(self, batch, labels, n_real, t, noise, keep) -> None:
        for buf, value in ((self.batch, batch), (self.labels, labels), (self.n_real, n_real),
                           (self.t, t), (self.noise, noise), (self.keep, keep)):
            if buf is not None:
                # A pinned host batch is copied without waiting for the device.
                buf.copy_(torch.as_tensor(value), non_blocking=True)


def make_train_step(model: UNet, config: TrainConfig, diffusion: Diffusion, *,
                    graphs: bool = True) -> Callable:
    """Build the train step ``(state, batch, generator=None, labels=None,
    n_real=None, *, t=None, noise=None, keep=None) -> (state, loss)``.

    ``batch`` is NHWC f32 on the model's device, or a pinned host tensor;
    ``labels`` (B,) integers for a conditional model; ``n_real`` masks padded
    duplicates at the end of the batch out of the loss. ``t``, ``noise`` and
    ``keep`` (the CFG label mask) are drawn from ``generator`` in that order
    unless given. Every input is copied into the static buffers of its
    signature. The state is updated in place and returned; ``loss`` is a 0-dim
    f32 tensor on the device (no host synchronisation happens in the step).
    On the card the step runs as CUDA graphs, one for each branch (see the
    module docstring); ``graphs=False`` runs it eagerly.
    """
    model_params = [p for _, p in model.named_parameters()]
    device = model_params[0].device
    grad_accum, clip = config.grad_accum, config.grad_clip
    use_ema, ema_beta = config.use_ema, config.ema_beta
    label_dropout = config.label_dropout
    signatures: dict[tuple, _StepInputs] = {}
    bound_state: TrainState | None = None  # the state the step reads

    def loss_fn(inp: _StepInputs, generator):
        batch = inp.batch
        n = batch.shape[0]
        t = inp.t if inp.t is not None else diffusion.sample_timesteps(n, generator)
        x_t, noise = diffusion.noise_images(batch, t, generator, noise=inp.noise)
        if inp.labels is None:
            pred = model(x_t, t)
        elif label_dropout > 0.0:
            # CFG training: drop the conditioning on a per-sample coin flip.
            keep = inp.keep
            if keep is None:
                keep = (torch.rand((n,), generator=generator, device=batch.device)
                        >= label_dropout).float()
            pred = model(x_t, t, inp.labels, keep)
        else:
            pred = model(x_t, t, inp.labels)
        per_sample = ((noise - pred.float()) ** 2).mean(dim=(1, 2, 3))
        if inp.n_real is None:
            return per_sample.mean()
        # Padded duplicates at the end of the batch are masked out, so every
        # real sample is weighted once.
        mask = (torch.arange(n, device=batch.device) < inp.n_real).float()
        return (per_sample * mask).sum() / inp.n_real

    def run(inp: _StepInputs, variant) -> None:
        """One micro-batch at ``position`` of the accumulation window; the
        last position updates, with the EMA copying or blending."""
        position, ema_copy = variant
        state = bound_state
        masters = list(state.params.values())
        with torch.no_grad():
            torch._foreach_copy_(model_params, masters)  # f32 masters → compute dtype
        for p in model_params:
            p.grad = None
        loss = loss_fn(inp, inp.generator)
        loss.backward()
        with torch.no_grad():
            # A parameter the graph never reaches (the label embedding in a step
            # without labels) gets a zero gradient, so that weight decay still
            # acts on it, as it does under optax.
            grads = [torch.zeros_like(m) if p.grad is None else p.grad.float()
                     for p, m in zip(model_params, masters)]
            if grad_accum > 1:
                # Running mean over the window: acc += (g − acc) / (position + 1).
                torch._foreach_sub_(grads, state.grad_acc)
                torch._foreach_div_(grads, float(position + 1))
                torch._foreach_add_(state.grad_acc, grads)
                grads = state.grad_acc
            if position == grad_accum - 1:
                if clip is not None:
                    norm = torch.linalg.vector_norm(
                        torch.stack(torch._foreach_norm(grads)))
                    torch._foreach_mul_(grads, clip / torch.clamp(norm, min=clip))
                for m, g in zip(masters, grads):
                    m.grad = g
                state.optimizer.step()
                for m in masters:
                    m.grad = None
                if grad_accum > 1:
                    torch._foreach_zero_(state.grad_acc)
                if use_ema:
                    ema = list(state.ema_params.values())
                    if ema_copy:
                        torch._foreach_copy_(ema, masters)
                    else:
                        torch._foreach_mul_(ema, ema_beta)
                        torch._foreach_add_(ema, masters, alpha=1.0 - ema_beta)
            inp.loss.copy_(loss.detach())

    def step_fn(state: TrainState, batch, generator=None, labels=None, n_real=None, *,
                t=None, noise=None, keep=None):
        nonlocal bound_state
        if state is not bound_state:
            if any(inp.captured for inp in signatures.values()):
                raise ValueError("this train step runs as CUDA graphs bound to the TrainState "
                                 "of its first calls: make a new step for another state")
            bound_state = state
        key = (tuple(batch.shape), labels is None, n_real is None, t is None, noise is None,
               keep is None, fg_impl_override())
        inp = signatures.get(key)
        if inp is None:
            inp = signatures[key] = _StepInputs(batch, labels, n_real, t, noise, keep, device,
                                                run, graphs)
        inp.fill(batch, labels, n_real, t, noise, keep)
        position = state.mini_step if grad_accum > 1 else 0
        emit = position == grad_accum - 1
        if emit:
            _set_lr(state.optimizer, lr_at(config, state.updates))
        with inp.drawing_from(generator):
            inp((position, use_ema and emit and state.step < STEP_START_EMA))
        if grad_accum > 1:
            state.mini_step = 0 if emit else position + 1
        if emit:
            state.updates += 1
        state.step += 1
        return state, inp.loss.clone()

    return step_fn


def step_generator(generator: torch.Generator, seed: int, index: int) -> torch.Generator:
    """Re-seed ``generator`` for draw number ``index`` of a run: the stream
    depends on ``(seed, index)`` alone, not on what was drawn before."""
    return generator.manual_seed(((int(seed) + 1) << 32) + int(index))


def _staged(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A batch as the step takes it: in pinned host memory for the card (the
    step copies it into its static buffer without waiting), else on the CPU."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    return tensor.pin_memory() if device.type == "cuda" else tensor


def train(
    config: TrainConfig,
    dataloader: Dataloader,
    *,
    root: str = ".",
    device="cuda",
    resume: bool = False,
    profile_dir: str | None = None,
) -> list[float]:
    """Full training run on ``device``; returns the per-epoch mean losses.

    Artifacts under ``root``: ``results/<run>/<epoch>.jpg`` sample grids,
    ``models/<run>/ckpt_*.npz`` (overwritten each epoch) with ``config.json``
    beside it, ``runs/<run>/metrics.jsonl``. ``profile_dir`` captures a
    ``torch.profiler`` trace (host and device) of this call's steps
    ``PROFILE_STEPS`` as ``<profile_dir>/trace_<run>.json``, a Chrome trace.
    """
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils import checkpoint as ckpt_lib
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils.io import save_image_grid
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils.native import native_status

    device = torch.device(device)
    if resume:
        config = recover_stored_config(config, root)
    if config.lr_schedule != "constant" and config.lr_total_steps is None:
        # Cosine horizon in optimizer updates: every epoch walks the whole
        # dataloader, and one update happens per grad_accum batches.
        steps_per_epoch = max(1, len(dataloader))
        config = dataclasses.replace(
            config,
            lr_total_steps=max(1, config.epochs * steps_per_epoch // config.grad_accum),
        )
        logger.info("lr_total_steps derived: %d updates", config.lr_total_steps)
    model, state = create_train_state(config, device=device)
    ckpt_path = config.checkpoint_path(root)
    first_epoch = 0
    if resume and os.path.exists(ckpt_path + ".npz"):
        restored = ckpt_lib.restore_checkpoint(ckpt_path)
        state.load(restored["params"], restored["ema_params"], restored["step"])
        if config.checkpoint_opt_state:
            if "opt_state" not in restored:
                raise KeyError(f"checkpoint {ckpt_path}.npz holds no optimizer state "
                               "(was it saved without checkpoint_opt_state?)")
            ckpt_lib.load_opt_state(config, state, restored["opt_state"])
        # Epochs are numbered on from the epoch the checkpoint stopped in: the
        # data order, the logged epoch, the sample grid's file name and its
        # noise index (the JAX trainer starts again at 0 and writes over the
        # first run's grids).
        first_epoch = state.step // max(1, len(dataloader))
        if isinstance(dataloader, Dataloader):
            dataloader.epoch = first_epoch
        logger.info("resumed from %s at step %d (epoch %d)", ckpt_path, state.step,
                    first_epoch)
    logger.info("model variant=%d params=%s", config.variant, f"{param_count(model):,}")
    diffusion = Diffusion(
        noise_steps=config.noise_steps,
        beta_start=config.beta_start,
        beta_end=config.beta_end,
        img_size=config.image_size,
        device=device,
    )
    step_fn = make_train_step(model, config, diffusion)

    os.makedirs(config.results_dir(root), exist_ok=True)
    os.makedirs(config.model_dir(root), exist_ok=True)
    os.makedirs(config.runs_dir(root), exist_ok=True)
    # The full config beside the checkpoint: restore-time model construction
    # recovers shape knobs like base_width from it.
    with open(os.path.join(config.model_dir(root), "config.json"), "w") as f:
        f.write(config.to_json())
    metrics_path = os.path.join(config.runs_dir(root), "metrics.jsonl")

    # The host-side gather of the next batch overlaps the device step.
    dataloader = PrefetchLoader(dataloader)

    generator = torch.Generator(device=device)
    loss_all: list[float] = []
    # A resumed run goes on counting where the checkpoint stopped, so its
    # per-step streams continue those of the run that wrote it.
    global_step = state.step
    run_step = 0  # steps of this call: the profiler's window counts these
    profiler = None
    with open(metrics_path, "a") as metrics_f:
        metrics_f.write(json.dumps({
            "run_header": config.run_name,
            "variant": config.variant,
            "epochs": config.epochs,
            "resumed_step": state.step,
            "first_epoch": first_epoch,
            "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else str(device)),
            # host-side CSV parsing and batch gather: the C++ binding or numpy
            "native_loader": native_status(),
        }) + "\n")
        for epoch in range(first_epoch, first_epoch + config.epochs):
            logger.info("Starting epoch %d:", epoch)
            # Losses stay on the device until the epoch ends: a per-step
            # .item() would make the host wait for every step.
            epoch_losses: list[torch.Tensor] = []
            t_start, imgs = time.perf_counter(), 0
            for images, lbls in dataloader:
                batch = _staged(images, device)
                labels = None
                if config.num_classes:
                    labels = _staged(np.asarray(lbls, dtype=np.int64), device)
                if profile_dir is not None and run_step == PROFILE_STEPS[0]:
                    profiler = _start_profiler()
                state, loss = step_fn(
                    state, batch, step_generator(generator, config.seed, global_step), labels)
                epoch_losses.append(loss)
                imgs += images.shape[0]
                global_step += 1
                run_step += 1
                if profiler is not None and run_step == PROFILE_STEPS[1]:
                    _stop_profiler(profiler, profile_dir, config.run_name, device)
                    profiler = None
                if global_step % LOG_EVERY == 0:
                    loss_value = float(loss)  # waits for the device, once per log point
                    dt = time.perf_counter() - t_start
                    rate = imgs / max(dt, 1e-9)
                    logger.info("epoch %d step %d loss %.4f (%.1f imgs/s)",
                                epoch, global_step, loss_value, rate)
                    metrics_f.write(json.dumps({
                        "epoch": epoch, "step": global_step, "loss": loss_value,
                        "imgs_per_sec": round(rate, 1), "wall_s": round(dt, 2),
                    }) + "\n")
                    metrics_f.flush()
            loss_all.append(float(torch.stack(epoch_losses).mean()) if epoch_losses else 0.0)

            if config.image_gen_n > 0:
                weights = state.ema_params if config.use_ema else state.params
                with torch.no_grad():
                    torch._foreach_copy_([p for _, p in model.named_parameters()],
                                         list(weights.values()))
                # Epoch sampling draws from its own index range, above every
                # per-step index.
                final, _ = diffusion.sample(
                    model, n=config.image_gen_n, image_channels=config.image_channels,
                    generator=step_generator(generator, config.seed, 2**31 + epoch))
                save_image_grid(final.cpu().numpy(),
                                os.path.join(config.results_dir(root), f"{epoch}.jpg"))
            opt_state = (ckpt_lib.opt_state_arrays(config, state)
                         if config.checkpoint_opt_state else None)
            ckpt_lib.save_checkpoint(ckpt_path, state.params, state.ema_params, state.step,
                                     opt_state)
    if profiler is not None:  # the run ended inside the window
        _stop_profiler(profiler, profile_dir, config.run_name, device)
    return loss_all


def _start_profiler():
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: str, run_name: str, device: torch.device) -> str:
    """Close the trace once the device has finished the window's steps and
    write it as ``<profile_dir>/trace_<run_name>.json``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_{run_name}.json")
    profiler.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
    return path
