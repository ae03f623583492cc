"""Checkpoint save and restore in the JAX package's ``.npz`` layout.

One file per run, overwritten each epoch:
``models/<run_name>/ckpt_<dataset>_<variant>.npz`` with the keys
``params/params/<jax path>``, ``ema_params/params/<jax path>`` and ``step``,
leaves in the JAX layouts (``utils/weights.py``). So the port's ``sample``
reads its own checkpoints through ``load_jax_npz``, and the JAX package's
``restore_checkpoint`` reads them too, and the reverse.

Optimizer state is not checkpointed yet: a resumed run restarts AdamW's
moments. Orbax directories and the reference ``.pt`` files are not read.
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
)


def save_checkpoint(path: str, params: Mapping[str, torch.Tensor],
                    ema_params: Mapping[str, torch.Tensor], step: int) -> str:
    """Write ``path + ".npz"`` from the two ``state_dict``s and the step
    count; returns the path written. The file is replaced atomically."""
    payload = {
        "params": {"params": params_to_jax(params)},
        "ema_params": {"params": params_to_jax(ema_params)},
        "step": np.asarray(int(step), np.int32),
    }
    npz_path = path if path.endswith(".npz") else path + ".npz"
    os.makedirs(os.path.dirname(npz_path) or ".", exist_ok=True)
    tmp = f"{npz_path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **_flatten(payload))
    os.replace(tmp, npz_path)
    return npz_path


def restore_checkpoint(path: str) -> dict:
    """``{"params": state_dict, "ema_params": state_dict, "step": int}`` from
    an ``.npz`` checkpoint written by either package."""
    params = load_jax_npz(path, ema=False)
    ema_params = load_jax_npz(path, ema=True)
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        step = int(z["step"]) if "step" in z.files else 0
    return {"params": params, "ema_params": ema_params, "step": step}
