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

Data parallelism and FSDP (``parallel/``). Under a :class:`~parallel.mesh.Mesh`
of ranks (one process a GPU, torch.distributed), ``make_train_step(mesh=)``
steps one rank's rows of the global batch: the rows split over every rank of
the mesh, in grid order (``parallel.put_global_batch``). Every rank draws the
global batch's ``t``, noise and label mask from the same generator and takes
its rows' part, and its loss is its rows' share of the global mean (the
masked sum over ``n_real``, the padded duplicates masked by their global
row), so the gradients summed over the ranks are the single-device step's,
up to the order of that sum: an all-reduce on a ``data`` mesh. With an
``fsdp`` axis larger than 1 (:func:`state_sharding_tree`) each rank keeps only
its shard of the f32 masters, AdamW's moments, the EMA and the accumulator:
the step all-gathers the masters into the compute model before the forward,
reduce-scatters the gradients onto the shards (and all-reduces those over
the ``data`` axis), and updates the shards. The loss the step returns is the
global mean on every rank. ``train()`` builds a data mesh when
torch.distributed runs more than one rank (``config.mesh_shape`` and
``mesh_axes`` where they cover the ranks); rank 0 alone writes the run's
artifacts (the profiler's trace too), the checkpoint whole, in the
single-device layout. One process is the same step with one part: its rows
are the whole batch.
"""

from __future__ import annotations

import contextlib
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
from aliasfree_diffusion_models_pytorch_tpu_torch.ops.resample import fg_impl_override, gelu_mode
from aliasfree_diffusion_models_pytorch_tpu_torch.parallel import (
    Mesh,
    Sharding,
    batch_sharding,
    make_mesh,
    param_sharding,
    world,
)
from aliasfree_diffusion_models_pytorch_tpu_torch.parallel.multihost import put_global_batch
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import spans
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.graphs import GraphedStep

logger = logging.getLogger(__name__)

# train()'s spans (utils/spans.py): recorded only while a profiler session records
_BATCH = spans.Span("train.batch")
_STEP = spans.Span("train.step")
_LOG = spans.Span("train.log")
_EPOCH_END = spans.Span("train.epoch_end")

STEP_START_EMA = 2000  # micro-batches during which the EMA copies the parameters


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


def _all_gather(sharding: Sharding, shard: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which every rank of the sharding's axis holds a
    piece (a collective over that axis)."""
    import torch.distributed as dist

    d = sharding.dim
    moved = shard.movedim(d, 0).contiguous()
    out = moved.new_empty((sharding.parts() * moved.shape[0],) + tuple(moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=sharding.mesh.group(sharding.spec[d]))
    return out.movedim(0, d)


def _reduce_scatter(sharding: Sharding, whole: torch.Tensor) -> torch.Tensor:
    """This rank's piece of the sum over the sharding's axis of ``whole``."""
    import torch.distributed as dist

    d = sharding.dim
    moved = whole.movedim(d, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // sharding.parts(),) + tuple(moved.shape[1:]))
    dist.reduce_scatter_tensor(out, moved, group=sharding.mesh.group(sharding.spec[d]))
    return out.movedim(0, d).contiguous()


@dataclasses.dataclass
class TrainState:
    """What a step updates, in place: the f32 master parameters and EMA (by
    ``state_dict`` name), the optimizer, the gradient accumulator and the
    counters. ``step`` counts micro-batches. Under FSDP (``shardings``) each
    of those tensors is this rank's shard of the parameter's."""

    params: dict[str, torch.Tensor]
    ema_params: dict[str, torch.Tensor]
    optimizer: torch.optim.AdamW
    grad_acc: list[torch.Tensor] | None  # running mean over the window; None if grad_accum == 1
    step: int = 0
    mini_step: int = 0  # micro-batches in the open accumulation window
    updates: int = 0    # optimizer updates so far
    shardings: dict[str, Sharding] | None = None  # the FSDP layout; None: whole tensors

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole tensor of parameter ``name``."""
        return whole if self.shardings is None else self.shardings[name].shard(whole)

    def gather(self, tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The whole tensors of a ``{name: this rank's part}`` dict. Under
        FSDP a collective: every rank of the mesh calls it."""
        if self.shardings is None:
            return tree
        return {n: v if self.shardings[n].dim is None else _all_gather(self.shardings[n], v)
                for n, v in tree.items()}

    def load(self, params, ema_params, step: int) -> None:
        """Overwrite parameters, EMA and step count (checkpoint restore) from
        whole tensors."""
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(self.local(name, params[name]))
                self.ema_params[name].copy_(self.local(name, ema_params[name]))
        self.step = int(step)


def state_sharding_tree(mesh: Mesh | None, params: dict[str, torch.Tensor]
                        ) -> dict[str, Sharding] | None:
    """The FSDP layout of the state (JAX ``train.py:state_sharding_tree``):
    with an ``fsdp`` axis larger than 1, :func:`~parallel.param_sharding` of
    the parameters, which AdamW's moments, the EMA and the accumulator follow;
    otherwise None, every tensor whole and only the batch split."""
    if mesh is not None and mesh.shape.get("fsdp", 1) > 1:
        return param_sharding(mesh, params, axis="fsdp")
    return None


def create_train_state(config: TrainConfig, device="cuda", state_dict=None,
                       mesh: Mesh | None = None) -> tuple[UNet, TrainState]:
    """The compute model (in ``compute_dtype`` on ``device``) and a fresh
    :class:`TrainState`. Weights come from ``state_dict`` or, without one,
    from ``utils.weights.init_params(config, config.seed)``. Under a mesh
    with an ``fsdp`` axis the state holds this rank's shards."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import init_params

    if state_dict is None:
        state_dict = init_params(config, config.seed)
    model = build_model(config, device=device, state_dict=state_dict)
    names = [name for name, _ in model.named_parameters()]
    whole = {n: state_dict[n].detach().to(device=device, dtype=torch.float32) for n in names}
    shardings = state_sharding_tree(mesh, whole)
    params = {n: (v if shardings is None else shardings[n].shard(v)).clone()
              for n, v in whole.items()}
    ema = {n: p.clone() for n, p in params.items()}
    grad_acc = None
    if config.grad_accum > 1:
        grad_acc = [torch.zeros_like(p) for p in params.values()]
    return model, TrainState(params=params, ema_params=ema,
                             optimizer=make_optimizer(config, params.values()),
                             grad_acc=grad_acc, shardings=shardings)


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
                    mesh: Mesh | None = None, graphs: bool = True) -> Callable:
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

    Under a ``mesh`` (see the module docstring) ``batch`` and ``labels`` are
    this rank's rows, ``n_real`` counts the global batch's real rows, and
    ``t``, ``noise`` and ``keep``, when given, are the global batch's; the
    state is the one ``create_train_state(mesh=mesh)`` made.
    """
    model_params = [p for _, p in model.named_parameters()]
    device = model_params[0].device
    grad_accum, clip = config.grad_accum, config.grad_clip
    use_ema, ema_beta = config.use_ema, config.ema_beta
    label_dropout = config.label_dropout
    signatures: dict[tuple, _StepInputs] = {}
    bound_state: TrainState | None = None  # the state the step reads
    if mesh is not None:
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or mesh.size != world()[1]:
            raise ValueError(f"a step on a mesh of {mesh.size} ranks needs torch.distributed "
                             f"running with as many (it runs {world()[1]})")
        if mesh.group(None) is None:
            mesh.build_groups()  # every rank makes its step, so every rank gets here
    # This rank's rows of the global batch: part `position` of `parts` (one
    # process: the whole batch).
    parts, position = 1, 0
    if mesh is not None:
        rows = batch_sharding(mesh, 1, axis=mesh.axis_names)
        parts, position = rows.parts(), rows.index()

    def loss_fn(inp: _StepInputs, generator):
        batch = inp.batch
        n = batch.shape[0]
        # The global batch's draws, in the single-device order; this rank's rows.
        mine = slice(position * n, (position + 1) * n)
        t = inp.t if inp.t is not None else diffusion.sample_timesteps(n * parts, generator)
        noise = inp.noise
        if noise is None:
            noise = torch.randn((n * parts,) + tuple(batch.shape[1:]), generator=generator,
                                dtype=batch.dtype, device=batch.device)
        t = t[mine]
        x_t, noise = diffusion.noise_images(batch, t, generator, noise=noise[mine])
        if inp.labels is None:
            pred = model(x_t, t)
        elif label_dropout > 0.0:
            # CFG training: drop the conditioning on a per-sample coin flip.
            keep = inp.keep
            if keep is None:
                keep = (torch.rand((n * parts,), generator=generator, device=batch.device)
                        >= label_dropout).float()
            pred = model(x_t, t, inp.labels, keep[mine])
        else:
            pred = model(x_t, t, inp.labels)
        per_sample = ((noise - pred.float()) ** 2).mean(dim=(1, 2, 3))
        if inp.n_real is None:
            return per_sample.mean() / parts  # this rank's share of the global mean
        # Padded duplicates at the end of the batch are masked out by their
        # global row, so every real sample is weighted once.
        first = position * n
        mask = (torch.arange(first, first + n, device=batch.device) < inp.n_real).float()
        return (per_sample * mask).sum() / inp.n_real

    def reduce(state: TrainState, grads: list, loss: torch.Tensor):
        """Sum the ranks' gradients and loss shares: whole gradients and the
        loss in one all-reduce over the mesh; under FSDP each sharded
        gradient reduce-scattered over ``fsdp``, then all-reduced over
        ``data``. Returns this rank's gradients (shards under FSDP) and the
        global loss."""
        import torch.distributed as dist

        names = list(state.params)
        sharded = [i for i, n in enumerate(names)
                   if state.shardings is not None and state.shardings[n].dim is not None]
        whole = [i for i in range(len(names)) if i not in set(sharded)]
        out = list(grads)
        flat = torch.empty(sum(grads[i].numel() for i in whole) + 1, dtype=torch.float32,
                           device=loss.device)
        views = [v.view(grads[i].shape) for i, v in zip(
            whole, flat[:-1].split([grads[i].numel() for i in whole]))]
        torch._foreach_copy_(views, [grads[i] for i in whole])
        flat[-1:].copy_(loss.detach().reshape(1))
        dist.all_reduce(flat, group=mesh.group(None))
        for i, v in zip(whole, views):
            out[i] = v
        if sharded:
            for i in sharded:
                out[i] = _reduce_scatter(state.shardings[names[i]], grads[i])
            if mesh.shape.get("data", 1) > 1:
                buf = torch.cat([out[i].reshape(-1) for i in sharded])
                dist.all_reduce(buf, group=mesh.group("data"))
                for i, v in zip(sharded, buf.split([out[i].numel() for i in sharded])):
                    out[i] = v.view(out[i].shape)
        return out, flat[-1], sharded

    def global_norm(grads: list, sharded: list) -> torch.Tensor:
        """The global norm of the gradients; under FSDP the shards' squares
        are summed over ``fsdp``."""
        if not sharded:
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        import torch.distributed as dist

        def squares(tensors):
            return torch.stack(torch._foreach_norm(tensors)).square().sum()

        part = squares([grads[i] for i in sharded]).reshape(1)
        dist.all_reduce(part, group=mesh.group("fsdp"))
        whole = [g for i, g in enumerate(grads) if i not in set(sharded)]
        return torch.sqrt(squares(whole) + part[0])

    def run(inp: _StepInputs, variant) -> None:
        """One micro-batch at place ``window`` of the accumulation window;
        the last place updates, with the EMA copying or blending."""
        window, ema_copy = variant
        state = bound_state
        masters = list(state.params.values())
        with torch.no_grad():
            # f32 masters (gathered whole under FSDP) → compute dtype
            torch._foreach_copy_(model_params, list(state.gather(state.params).values()))
        for p in model_params:
            p.grad = None
        loss = loss_fn(inp, inp.generator)
        loss.backward()
        with torch.no_grad():
            # A parameter the graph never reaches (the label embedding in a step
            # without labels) gets a zero gradient, so that weight decay still
            # acts on it, as it does under optax.
            grads = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad.float()
                     for p in model_params]
            sharded = []
            if mesh is not None:
                grads, loss, sharded = reduce(state, grads, loss)
            if grad_accum > 1:
                # Running mean over the window: acc += (g − acc) / (window + 1).
                torch._foreach_sub_(grads, state.grad_acc)
                torch._foreach_div_(grads, float(window + 1))
                torch._foreach_add_(state.grad_acc, grads)
                grads = state.grad_acc
            if window == grad_accum - 1:
                if clip is not None:
                    norm = global_norm(grads, sharded)
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
               keep is None, fg_impl_override(), gelu_mode())
        inp = signatures.get(key)
        if inp is None:
            inp = signatures[key] = _StepInputs(batch, labels, n_real, t, noise, keep, device,
                                                run, graphs)
        inp.fill(batch, labels, n_real, t, noise, keep)
        window = state.mini_step if grad_accum > 1 else 0
        emit = window == grad_accum - 1
        if emit:
            _set_lr(state.optimizer, lr_at(config, state.updates))
        with inp.drawing_from(generator):
            inp((window, use_ema and emit and state.step < STEP_START_EMA))
        if grad_accum > 1:
            state.mini_step = 0 if emit else window + 1
        if emit:
            state.updates += 1
        state.step += 1
        return state, inp.loss.clone()

    step_fn.signatures = signatures  # signature -> its static buffers and graphs
    return step_fn


def step_generator(generator: torch.Generator, seed: int, index: int) -> torch.Generator:
    """Re-seed ``generator`` for draw number ``index`` of a run: the stream
    depends on ``(seed, index)`` alone, not on what was drawn before."""
    return generator.manual_seed(((int(seed) + 1) << 32) + int(index))


def train_mesh(config: TrainConfig) -> Mesh | None:
    """The mesh :func:`train` builds on its own: None for one process; when
    torch.distributed runs more ranks, ``config.mesh_shape`` over
    ``config.mesh_axes`` where it covers them, else every rank on ``data``
    (the JAX package's default), for a batch that divides the ranks."""
    size = world()[1]
    if size == 1:
        return None
    if math.prod(config.mesh_shape) == size:
        return make_mesh(tuple(config.mesh_shape), tuple(config.mesh_axes))
    if config.batch_size % size != 0:
        raise ValueError(f"batch_size={config.batch_size} does not divide the {size} ranks: "
                         "pick a divisible batch size, or a config.mesh_shape over them")
    return make_mesh()


def train(
    config: TrainConfig,
    dataloader: Dataloader,
    *,
    root: str = ".",
    device="cuda",
    mesh: Mesh | None = None,
    sample_each_epoch: bool = True,
    checkpoint_each_epoch: bool = True,
    resume: bool = False,
    prefetch: bool = True,
    log_every: int = 50,
    profile_dir: str | None = None,
    profile_steps: tuple[int, int] = (10, 20),
) -> list[float]:
    """Full training run on ``device``; returns the per-epoch mean losses.

    The keywords are the JAX ``train()``'s, with its defaults, and
    ``device``. Artifacts under ``root``: ``results/<run>/<epoch>.jpg``
    sample grids (with ``sample_each_epoch`` and ``config.image_gen_n > 0``),
    ``models/<run>/ckpt_*.npz`` (with ``checkpoint_each_epoch``, overwritten
    each epoch) with ``config.json`` beside it, ``runs/<run>/metrics.jsonl``
    (a loss record every ``log_every`` steps, with ``device_ms_per_step``:
    the card's milliseconds a step since the previous record, null at the
    first and off the card). ``prefetch`` gathers the next batch on a host
    thread while the device steps. ``profile_dir`` captures a
    ``torch.profiler`` trace (host and device) as
    ``<profile_dir>/trace_<run>.json``, a Chrome trace, of this call's steps
    from ``profile_steps[0]`` up to, not including, ``profile_steps[1]``,
    counted from 0 in every call (the JAX trainer's window counts its global
    step and takes its last step too). The trace, like any profiler session
    open around this call, carries the program's spans (``utils/spans.py``):
    ``train.batch`` (the wait on the loader for a batch), ``train.step``
    (the batch's copy and the step's launch), ``train.log`` (a log point's
    loss fetch and record), ``train.epoch_end`` (the epoch's loss mean,
    sample grid and checkpoint), and the graph runner's ``graph.warmup`` and
    ``graph.capture``.

    Under torch.distributed with more than one rank the run steps on a mesh
    (``mesh``, or :func:`train_mesh`'s): every rank walks the same global
    batches and steps its rows; a trailing batch that does not divide the
    mesh is padded by repeating its leading samples, masked out of the loss.
    Rank 0 alone writes the artifacts and traces its steps; the checkpoint
    holds the whole state (gathered under FSDP), so a single-device run
    resumes it.
    """
    from aliasfree_diffusion_models_pytorch_tpu_torch.impl_flags import impl_report
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils import checkpoint as ckpt_lib
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils.io import save_image_grid

    device = torch.device(device)
    if mesh is None:
        mesh = train_mesh(config)
    writer = world()[0] == 0
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
    model, state = create_train_state(config, device=device, mesh=mesh)
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
    step_fn = make_train_step(model, config, diffusion, mesh=mesh)

    if writer:
        os.makedirs(config.results_dir(root), exist_ok=True)
        os.makedirs(config.model_dir(root), exist_ok=True)
        os.makedirs(config.runs_dir(root), exist_ok=True)
        # The full config beside the checkpoint: restore-time model
        # construction recovers shape knobs like base_width from it.
        with open(os.path.join(config.model_dir(root), "config.json"), "w") as f:
            f.write(config.to_json())
    metrics_path = os.path.join(config.runs_dir(root), "metrics.jsonl")

    if prefetch:
        # The host-side gather of the next batch overlaps the device step.
        dataloader = PrefetchLoader(dataloader)

    generator = torch.Generator(device=device)
    loss_all: list[float] = []
    # A resumed run goes on counting where the checkpoint stopped, so its
    # per-step streams continue those of the run that wrote it.
    global_step = state.step
    run_step = 0  # steps of this call: the profiler's window counts these
    profiler = None
    last_mark = None  # (CUDA event, global step) of the last log point
    header = {
        "run_header": config.run_name,
        "variant": config.variant,
        "epochs": config.epochs,
        "resumed_step": state.step,
        "first_epoch": first_epoch,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device)),
        # the implementation choices in effect (the JAX package's header
        # carries its own); native_loader among them: the C++ binding or numpy
        "impl": impl_report(mesh, graphs=device.type == "cuda"),
    }
    with (open(metrics_path, "a") if writer else contextlib.nullcontext()) as metrics_f:
        if writer:
            metrics_f.write(json.dumps(header) + "\n")
        for epoch in range(first_epoch, first_epoch + config.epochs):
            logger.info("Starting epoch %d:", epoch)
            # Losses stay on the device until the epoch ends: a per-step
            # .item() would make the host wait for every step.
            epoch_losses: list[torch.Tensor] = []
            t_start, imgs = time.perf_counter(), 0
            batches = iter(dataloader)
            while True:
                with _BATCH:
                    item = next(batches, None)
                if item is None:
                    break
                images, lbls = item
                lbls = np.asarray(lbls, dtype=np.int64) if config.num_classes else None
                n_real = None
                if mesh is not None and images.shape[0] % mesh.size:
                    # Pad the trailing partial batch up to a size the mesh
                    # divides by repeating its leading samples; n_real masks
                    # the duplicates out of the loss.
                    n_real = images.shape[0]
                    pad = mesh.size - n_real % mesh.size
                    images = np.concatenate([images, images[:pad]], axis=0)
                    if lbls is not None:
                        lbls = np.concatenate([lbls, lbls[:pad]], axis=0)
                if profile_dir is not None and writer and run_step == profile_steps[0]:
                    profiler = _start_profiler()
                with _STEP:
                    batch = put_global_batch(mesh, images, device=device)
                    labels = None if lbls is None else put_global_batch(mesh, lbls, device=device)
                    state, loss = step_fn(
                        state, batch, step_generator(generator, config.seed, global_step),
                        labels, n_real)
                epoch_losses.append(loss)
                imgs += n_real or images.shape[0]
                global_step += 1
                run_step += 1
                if profiler is not None and run_step == profile_steps[1]:
                    _stop_profiler(profiler, profile_dir, config.run_name, device)
                    profiler = None
                if global_step % log_every == 0:
                    with _LOG:
                        # The card's ms a step since the last log point (None at the
                        # first and off the card; an epoch end in between counts in
                        # it), from an event that float(loss) waits past.
                        mark = None
                        if device.type == "cuda":
                            mark = torch.cuda.Event(enable_timing=True)
                            mark.record()
                        loss_value = float(loss)  # waits for the device, once per log point
                        dt = time.perf_counter() - t_start
                        rate = imgs / max(dt, 1e-9)
                        device_ms = None
                        if mark is not None and last_mark is not None:
                            device_ms = (last_mark[0].elapsed_time(mark)
                                         / (global_step - last_mark[1]))
                        last_mark = None if mark is None else (mark, global_step)
                        logger.info("epoch %d step %d loss %.4f (%.1f imgs/s)",
                                    epoch, global_step, loss_value, rate)
                        if writer:
                            metrics_f.write(json.dumps({
                                "epoch": epoch, "step": global_step, "loss": loss_value,
                                "imgs_per_sec": round(rate, 1), "wall_s": round(dt, 2),
                                "device_ms_per_step": device_ms,
                            }) + "\n")
                            metrics_f.flush()
            with _EPOCH_END:
                loss_all.append(float(torch.stack(epoch_losses).mean()) if epoch_losses else 0.0)

                # Under FSDP every rank takes part in the gathers, so every rank
                # takes the same branches; rank 0 writes.
                if sample_each_epoch and config.image_gen_n > 0:
                    weights = state.gather(state.ema_params if config.use_ema else state.params)
                    if writer:
                        with torch.no_grad():
                            torch._foreach_copy_([p for _, p in model.named_parameters()],
                                                 list(weights.values()))
                        # Epoch sampling draws from its own index range, above
                        # every per-step index.
                        final, _ = diffusion.sample(
                            model, n=config.image_gen_n, image_channels=config.image_channels,
                            generator=step_generator(generator, config.seed, 2**31 + epoch))
                        save_image_grid(final.cpu().numpy(),
                                        os.path.join(config.results_dir(root), f"{epoch}.jpg"))
                if checkpoint_each_epoch:
                    params, ema = state.gather(state.params), state.gather(state.ema_params)
                    opt_state = (ckpt_lib.opt_state_arrays(config, state)
                                 if config.checkpoint_opt_state else None)
                    if writer:
                        ckpt_lib.save_checkpoint(ckpt_path, params, ema, state.step, opt_state)
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
