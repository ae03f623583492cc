"""Weights: JAX parameter trees and npz checkpoints into the port and back,
and a seeded torch-default initialisation.

The port's module attributes carry the JAX parameter tree's names, so a
leaf ``a/b/kernel`` becomes ``a.b.weight`` with a layout transpose:

=========================  ===========================  ==================
JAX leaf                   port ``state_dict`` entry     layout
=========================  ===========================  ==================
conv ``kernel``            ``weight``                    (kh,kw,I,O) → (O,I,kh,kw)
dense ``kernel``           ``weight``                    (I,O) → (O,I)
norm ``scale``             ``weight``                    as is
``bias``                   ``bias``                      as is
embed ``embedding``        ``weight``                    as is
=========================  ===========================  ==================

The checkpoint reader needs only numpy: it reads the ``.npz`` fallback that
the JAX package's ``save_checkpoint`` writes (keys ``params/<path>``,
``ema_params/<path>``, ``step``). Orbax checkpoint directories need the JAX
package's tooling and are refused with a clear error.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Mapping

import numpy as np
import torch
from torch import nn

from aliasfree_diffusion_models_pytorch_tpu_torch.config import TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.models.blocks import SelfAttention
from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import build_model


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _leaf_to_torch(name: str, value: np.ndarray) -> tuple[str, torch.Tensor]:
    if name == "kernel":
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 2:
            value = value.T
        else:
            raise ValueError(f"unexpected kernel rank {value.ndim}")
        name = "weight"
    elif name in ("scale", "embedding"):
        name = "weight"
    elif name != "bias":
        raise ValueError(f"unknown parameter leaf {name!r}")
    return name, torch.tensor(value, dtype=torch.float32)


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """A JAX UNet parameter tree (numpy leaves; with or without the outer
    ``"params"`` level) as the port's ``state_dict``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state = {}
    for path, value in _flatten(tree).items():
        *modules, leaf = path.split("/")
        name, tensor = _leaf_to_torch(leaf, value)
        state[".".join([*modules, name])] = tensor
    return state


def params_to_jax(state: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`params_from_jax`: a ``state_dict`` of the port's
    UNet as the JAX parameter tree (nested dicts of numpy f32 leaves, without
    the outer ``"params"`` level).

    A 4-D ``weight`` is a conv kernel, a 1-D one a norm scale, a 2-D one a
    dense kernel, or, with no ``bias`` beside it, an embedding table (every
    Linear of the UNet has a bias).
    """
    tree: dict = {}
    for key, tensor in state.items():
        *modules, leaf = key.split(".")
        value = tensor.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            if value.ndim == 4:
                leaf, value = "kernel", value.transpose(2, 3, 1, 0)
            elif value.ndim == 2 and ".".join([*modules, "bias"]) in state:
                leaf, value = "kernel", value.T
            elif value.ndim == 2:
                leaf = "embedding"
            elif value.ndim == 1:
                leaf = "scale"
            else:
                raise ValueError(f"unexpected weight rank {value.ndim} at {key}")
        elif leaf != "bias":
            raise ValueError(f"unknown state_dict entry {key!r}")
        node = tree
        for part in modules:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(value)
    return tree


def load_jax_npz(path: str, ema: bool = False) -> dict[str, torch.Tensor]:
    """Read the JAX package's ``.npz`` checkpoint (``path`` with or without
    the suffix) as a ``state_dict``; ``ema`` selects the EMA weights."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is an Orbax checkpoint directory, which the PyTorch port "
            "cannot read; re-save it with save_checkpoint(..., backend='npz')")
    p = path if path.endswith(".npz") else path + ".npz"
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    prefix = "ema_params/" if ema else "params/"
    with np.load(p) as z:
        flat = {k: z[k] for k in z.files if k.startswith(prefix)}
    if not flat:
        raise KeyError(f"{p} holds no '{prefix}' entries")
    return state_from_flat(flat, prefix)


def state_from_flat(flat: Mapping[str, np.ndarray], prefix: str) -> dict[str, torch.Tensor]:
    """The entries of a flat ``a/b/c``-keyed archive under ``prefix`` (a JAX
    parameter tree, or a tree of the same shape such as AdamW's moments) as
    a ``state_dict``."""
    tree: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *parents, leaf = key[len(prefix):].split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    if not tree:
        raise KeyError(f"no entries under '{prefix}'")
    return params_from_jax(tree)


def _fan_in(weight: torch.Tensor) -> int:
    return weight[0].numel()  # in_features, or in_channels·kh·kw


def init_params(config: TrainConfig, seed: int) -> dict[str, torch.Tensor]:
    """A ``state_dict`` with torch-default initialisation drawn from ``seed``.

    Conv2d/Linear weights: kaiming-uniform (a=√5); biases U(±1/√fan_in);
    attention qkv: xavier-uniform with zero bias; attention out-projection
    bias zero; Embedding N(0, 1); norms ones/zeros — the distributions the
    JAX package's ``models/init.py`` reproduces.
    """
    model = build_model(dataclasses.replace(config, compute_dtype="float32"), device="cpu")
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_uniform_(module.weight, a=math.sqrt(5), generator=g)
                if module.bias is not None:
                    bound = 1.0 / math.sqrt(_fan_in(module.weight))
                    nn.init.uniform_(module.bias, -bound, bound, generator=g)
            elif isinstance(module, nn.Embedding):
                nn.init.normal_(module.weight, generator=g)
        for module in model.modules():
            if isinstance(module, SelfAttention):
                nn.init.xavier_uniform_(module.qkv.weight, generator=g)
                nn.init.zeros_(module.qkv.bias)
                nn.init.zeros_(module.out.bias)
    return model.state_dict()
