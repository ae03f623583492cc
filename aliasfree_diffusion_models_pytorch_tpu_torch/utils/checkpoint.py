"""Checkpoint save and restore in the JAX package's ``.npz`` layout.

One file per run, overwritten each epoch:
``models/<run_name>/ckpt_<dataset>_<variant>.npz`` with the keys
``params/params/<jax path>``, ``ema_params/params/<jax path>`` and ``step``,
leaves in the JAX layouts (``utils/weights.py``). So the port's ``sample``
reads its own checkpoints through ``load_jax_npz``, and the JAX package's
``restore_checkpoint`` reads them too, and the reverse.

With ``TrainConfig.checkpoint_opt_state`` the optimizer goes in too, under
the keys that the JAX package's ``utils/checkpoint.py:_flatten`` gives the
optax state of its ``train.py:make_optimizer``:

============================  ==============================================
optimizer                     keys under ``opt_state/``
============================  ==============================================
AdamW                         ``0/.count``, ``0/.mu/params/…``, ``0/.nu/params/…``
+ warmup-cosine schedule      ``2/.count`` (updates so far)
+ ``grad_clip``               the above under ``1/`` (``0`` is the clip's empty state)
+ ``grad_accum`` > 1          the above under ``.inner_opt_state/``, and
                              ``.mini_step``, ``.gradient_step``,
                              ``.acc_grads/params/…``
============================  ==============================================

``mu``/``nu`` are torch AdamW's ``exp_avg``/``exp_avg_sq`` (the same update
rule), ``count`` its step, ``acc_grads`` the running mean of the open
accumulation window; arrays in the JAX layouts, counters int32. Orbax
directories are not read.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import (
    _flatten,
    load_jax_npz,
    params_to_jax,
    state_from_flat,
)


def _adamw_prefix(config) -> str:
    """Where the config's optimizer keeps AdamW's chain under ``opt_state/``."""
    outer = ".inner_opt_state/" if config.grad_accum > 1 else ""
    return outer + ("1/" if config.grad_clip is not None else "")


def opt_state_arrays(config, state) -> dict[str, np.ndarray]:
    """The optimizer of a ``train.TrainState`` as flat optax keys (without
    the ``opt_state/`` prefix), for ``config``'s optimizer form; whole
    tensors, gathered from the ranks' shards under FSDP."""
    chain = _adamw_prefix(config)
    names = list(state.params)
    per_param = [state.optimizer.state.get(state.params[n], {}) for n in names]

    def tree(key: str) -> dict:
        # whole tensors: under FSDP a gather, which every rank calls
        return params_to_jax(state.gather(
            {n: (s[key] if key in s else torch.zeros_like(state.params[n]))
             for n, s in zip(names, per_param)}))

    count = np.asarray(state.updates, np.int32)
    flat = {f"{chain}0/.count": count,
            **_flatten({f"{chain}0/.mu": {"params": tree("exp_avg")},
                        f"{chain}0/.nu": {"params": tree("exp_avg_sq")}})}
    if config.lr_schedule != "constant":
        flat[f"{chain}2/.count"] = count
    if config.grad_accum > 1:
        flat[".mini_step"] = np.asarray(state.mini_step, np.int32)
        flat[".gradient_step"] = count
        flat.update(_flatten({".acc_grads": {"params": params_to_jax(
            state.gather(dict(zip(names, state.grad_acc))))}}))
    return flat


def load_opt_state(config, state, flat: Mapping[str, np.ndarray]) -> None:
    """Set a ``train.TrainState``'s AdamW moments and step, its update count
    and (with ``grad_accum``) its open accumulation window from flat optax
    keys (without the ``opt_state/`` prefix), written by either package;
    under FSDP each rank takes its shards."""
    chain = _adamw_prefix(config)
    key = f"{chain}0/.count"
    if key not in flat:
        raise KeyError(f"checkpoint optimizer state has no '{key}': it was written for "
                       "another optimizer form (grad_clip / grad_accum differ)")
    count = int(flat[key])
    mu = state_from_flat(flat, f"{chain}0/.mu/")
    nu = state_from_flat(flat, f"{chain}0/.nu/")
    names = list(state.params)
    sd = state.optimizer.state_dict()
    sd["state"] = {i: {"step": torch.tensor(float(count)), "exp_avg": state.local(n, mu[n]).clone(),
                       "exp_avg_sq": state.local(n, nu[n]).clone()} for i, n in enumerate(names)}
    state.optimizer.load_state_dict(sd)
    state.updates = count
    if config.grad_accum > 1:
        acc = state_from_flat(flat, ".acc_grads/")
        with torch.no_grad():
            for buf, n in zip(state.grad_acc, names):
                buf.copy_(state.local(n, acc[n]))
        state.mini_step = int(flat[".mini_step"])


def save_checkpoint(path: str, params: Mapping[str, torch.Tensor],
                    ema_params: Mapping[str, torch.Tensor], step: int,
                    opt_state: Mapping[str, np.ndarray] | None = None) -> str:
    """Write ``path + ".npz"`` from the two ``state_dict``s, the step count
    and optionally the flat optimizer arrays of :func:`opt_state_arrays`;
    returns the path written. The file is replaced atomically."""
    payload = {
        "params": {"params": params_to_jax(params)},
        "ema_params": {"params": params_to_jax(ema_params)},
        "step": np.asarray(int(step), np.int32),
    }
    flat = _flatten(payload)
    if opt_state is not None:
        flat.update({f"opt_state/{k}": v for k, v in opt_state.items()})
    npz_path = path if path.endswith(".npz") else path + ".npz"
    os.makedirs(os.path.dirname(npz_path) or ".", exist_ok=True)
    tmp = f"{npz_path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, npz_path)
    return npz_path


def restore_checkpoint(path: str) -> dict:
    """``{"params": state_dict, "ema_params": state_dict, "step": int}`` from
    an ``.npz`` checkpoint written by either package, with ``"opt_state"``
    (flat arrays for :func:`load_opt_state`) where the file holds one."""
    params = load_jax_npz(path, ema=False)
    ema_params = load_jax_npz(path, ema=True)
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        step = int(z["step"]) if "step" in z.files else 0
        opt = {k[len("opt_state/"):]: z[k] for k in z.files if k.startswith("opt_state/")}
    restored = {"params": params, "ema_params": ema_params, "step": step}
    if opt:
        restored["opt_state"] = opt
    return restored
