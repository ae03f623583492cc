"""The reference repository's ``.pt`` checkpoints: name and layout maps.

Port of ``aliasfree_diffusion_models_pytorch_tpu/utils/torch_compat.py``
(:63-261) as numpy-level maps, so that a state_dict saved by the reference
(``torch.save(model.state_dict(), ...)``) runs in the port:

    .pt → :func:`torch_to_flax` (the JAX parameter tree) →
    ``utils.weights.params_from_jax`` (the port's state_dict) → ``build_model``

which :func:`load_reference_state_dict` does in one call.

Name translation (reference module tree → JAX parameter tree):

====================================  =============================
reference                              JAX tree
====================================  =============================
``X.double_conv.{0,1,3,4}``            ``X/{conv1,norm1,conv2,norm2}``
``X.{conv1,norm1,conv2,norm2}``        same names (filtered DoubleConvs)
``downN.maxpool_conv.{1,2}``           ``downN/{conv_res,conv_out}``
``{downN,upN}.conv.{0,1}``             ``.../{conv_res,conv_out}``
``X.emb_layer.1``                      ``X/emb/proj``
``saN.ln``                             ``saN/ln``
``saN.mha.in_proj_*``                  ``saN/qkv`` (transposed)
``saN.mha.out_proj``                   ``saN/out``
``saN.ff_self.{0,1,3}``                ``saN/{ff_ln,ff1,ff2}``
``outc``                               ``outc``
``label_emb``                          ``label_emb/embed``
``{downN,upN}.norm1`` (variant 4)      dead in the reference (defined,
                                       never applied): dropped
====================================  =============================

Layouts: conv ``(O,I,kh,kw) → (kh,kw,I,O)``; linear ``(O,I) → (I,O)``;
packed qkv ``(3C,C) → (C,3C)``; norm ``weight → scale``.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.config import TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import VARIANT_SPEC, UNet, build_model
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import params_from_jax


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    # Copy: torch's .numpy() view shares the tensor's storage, so an in-place
    # update of the tensor would change the converted array.
    return np.array(v)


def _set(tree: dict, path: list[str], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


_SEQ_DC = {"0": "conv1", "1": "norm1", "3": "conv2", "4": "norm2"}
_FF_SELF = {"0": "ff_ln", "1": "ff1", "3": "ff2"}


def torch_to_flax(state_dict: Mapping[str, "np.ndarray"]) -> dict:
    """Translate a reference UNet state_dict into the JAX parameter tree.

    Accepts torch tensors or numpy arrays. Returns ``{"params": {...}}``, the
    JAX package's parameter tree with numpy leaves. Unknown keys raise;
    variant 4's dead stage-level ``norm1`` parameters are dropped.
    """
    params: dict = {}
    for key, raw in state_dict.items():
        v = _to_numpy(raw)
        parts = key.split(".")
        top = parts[0]

        # variant 4's dead stage-level norms: down1.norm1.weight (depth 3)
        if (
            re.fullmatch(r"(down|up)\d", top)
            and len(parts) == 3
            and parts[1] == "norm1"
        ):
            continue

        if top == "outc":
            w = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v
            _set(params, ["outc", {"weight": "kernel", "bias": "bias"}[parts[1]]], w)
            continue

        if top == "label_emb":
            _set(params, ["label_emb", "embed", "embedding"], v)
            continue

        if re.fullmatch(r"sa\d", top):
            _convert_attention(params, top, parts[1:], v)
            continue

        if re.fullmatch(r"(down|up)\d", top):
            sub = parts[1]
            if sub == "emb_layer":
                # emb_layer.1 is the Linear (0 is SiLU)
                _set(
                    params,
                    [top, "emb", "proj",
                     {"weight": "kernel", "bias": "bias"}[parts[3]]],
                    v.T if parts[3] == "weight" else v,
                )
            elif sub in ("maxpool_conv", "conv"):
                # maxpool_conv: index 0 is the pool; 1,2 are the DoubleConvs.
                idx = parts[2]
                slot = {"1": "conv_res", "2": "conv_out"} if sub == "maxpool_conv" \
                    else {"0": "conv_res", "1": "conv_out"}
                _convert_doubleconv(params, [top, slot[idx]], parts[3:], v)
            else:
                raise KeyError(f"unrecognized reference parameter: {key}")
            continue

        if top in ("inc", "bot1", "bot2", "bot3"):
            _convert_doubleconv(params, [top], parts[1:], v)
            continue

        raise KeyError(f"unrecognized reference parameter: {key}")

    return {"params": params}


def _convert_doubleconv(params: dict, prefix: list[str], parts: list[str], v) -> None:
    if parts[0] == "double_conv":  # plain DoubleConv Sequential
        slot, leaf = _SEQ_DC[parts[1]], parts[2]
    else:  # DoubleConv_F / _F4: explicit names
        slot, leaf = parts[0], parts[1]
    if slot.startswith("conv"):
        _set(params, prefix + [slot, "conv",
                               {"weight": "kernel", "bias": "bias"}[leaf]],
             v.transpose(2, 3, 1, 0) if v.ndim == 4 else v)
    else:  # norm
        _set(params, prefix + [slot, "gn",
                               {"weight": "scale", "bias": "bias"}[leaf]], v)


def _convert_attention(params: dict, sa: str, parts: list[str], v) -> None:
    sub = parts[0]
    if sub == "ln":
        _set(params, [sa, "ln", {"weight": "scale", "bias": "bias"}[parts[1]]], v)
    elif sub == "mha":
        if parts[1] == "in_proj_weight":
            _set(params, [sa, "qkv", "kernel"], v.T)
        elif parts[1] == "in_proj_bias":
            _set(params, [sa, "qkv", "bias"], v)
        elif parts[1] == "out_proj":
            _set(params, [sa, "out", {"weight": "kernel", "bias": "bias"}[parts[2]]],
                 v.T if parts[2] == "weight" else v)
        else:
            raise KeyError(f"unrecognized attention parameter: {sa}.{'.'.join(parts)}")
    elif sub == "ff_self":
        slot, leaf = _FF_SELF[parts[1]], parts[2]
        if slot == "ff_ln":
            _set(params, [sa, slot, {"weight": "scale", "bias": "bias"}[leaf]], v)
        else:
            _set(params, [sa, slot, {"weight": "kernel", "bias": "bias"}[leaf]],
                 v.T if leaf == "weight" else v)
    else:
        raise KeyError(f"unrecognized attention parameter: {sa}.{'.'.join(parts)}")


_DC_SEQ_INV = {"conv1": "0", "norm1": "1", "conv2": "3", "norm2": "4"}
_FF_SELF_INV = {"ff_ln": "0", "ff1": "1", "ff2": "3"}


def flax_to_torch(params: Mapping, variant: int) -> dict[str, np.ndarray]:
    """Inverse of :func:`torch_to_flax`: export a params tree as a reference
    state_dict (numpy values; wrap with ``torch.from_numpy`` to save).

    ``variant`` determines the reference's naming scheme: plain DoubleConvs
    serialize as ``double_conv.{0,1,3,4}`` Sequentials (variants 0-1 trunk /
    0-1 stages), filtered ones by explicit member names; maxpool Down stages
    (variants 0, 2) use ``maxpool_conv.{1,2}``, alias-free ones ``conv.{0,1}``.
    Variant 4's dead stage-level ``norm1`` GroupNorms (in reference
    checkpoints but never applied) are written as identity, so the reference
    model's ``load_state_dict(strict=True)`` takes the result.
    """
    down_rs, up_rs, stage_conv, trunk_conv = VARIANT_SPEC[variant]
    tree = params.get("params", params)
    out: dict[str, np.ndarray] = {}

    def put_conv(prefix, node):
        out[f"{prefix}.weight"] = np.asarray(node["conv"]["kernel"]).transpose(3, 2, 0, 1)
        if "bias" in node["conv"]:
            out[f"{prefix}.bias"] = np.asarray(node["conv"]["bias"])

    def put_norm(prefix, node):
        out[f"{prefix}.weight"] = np.asarray(node["gn"]["scale"])
        out[f"{prefix}.bias"] = np.asarray(node["gn"]["bias"])

    def put_doubleconv(prefix, node, conv_mode):
        plain = conv_mode == "plain"
        for slot in ("conv1", "norm1", "conv2", "norm2"):
            name = f"{prefix}.double_conv.{_DC_SEQ_INV[slot]}" if plain \
                else f"{prefix}.{slot}"
            (put_conv if slot.startswith("conv") else put_norm)(name, node[slot])

    def put_stage(prefix, node, is_down):
        if is_down and down_rs == "maxpool":
            slots = {"conv_res": "maxpool_conv.1", "conv_out": "maxpool_conv.2"}
        else:
            slots = {"conv_res": "conv.0", "conv_out": "conv.1"}
        for ours, theirs in slots.items():
            put_doubleconv(f"{prefix}.{theirs}", node[ours], stage_conv)
        out[f"{prefix}.emb_layer.1.weight"] = np.asarray(
            node["emb"]["proj"]["kernel"]).T
        out[f"{prefix}.emb_layer.1.bias"] = np.asarray(node["emb"]["proj"]["bias"])
        if variant == 4:
            # Dead reference parameters: identity GroupNorm.
            c = out[f"{prefix}.emb_layer.1.bias"].shape[0]
            in_ch = node["conv_res"]["conv1"]["conv"]["kernel"].shape[2]
            dead_c = in_ch if is_down else in_ch // 2
            out[f"{prefix}.norm1.weight"] = np.ones(dead_c, np.float32)
            out[f"{prefix}.norm1.bias"] = np.zeros(dead_c, np.float32)

    def put_attention(prefix, node):
        out[f"{prefix}.ln.weight"] = np.asarray(node["ln"]["scale"])
        out[f"{prefix}.ln.bias"] = np.asarray(node["ln"]["bias"])
        out[f"{prefix}.mha.in_proj_weight"] = np.asarray(node["qkv"]["kernel"]).T
        out[f"{prefix}.mha.in_proj_bias"] = np.asarray(node["qkv"]["bias"])
        out[f"{prefix}.mha.out_proj.weight"] = np.asarray(node["out"]["kernel"]).T
        out[f"{prefix}.mha.out_proj.bias"] = np.asarray(node["out"]["bias"])
        for ours, idx in _FF_SELF_INV.items():
            n = node[ours]
            if ours == "ff_ln":
                out[f"{prefix}.ff_self.{idx}.weight"] = np.asarray(n["scale"])
                out[f"{prefix}.ff_self.{idx}.bias"] = np.asarray(n["bias"])
            else:
                out[f"{prefix}.ff_self.{idx}.weight"] = np.asarray(n["kernel"]).T
                out[f"{prefix}.ff_self.{idx}.bias"] = np.asarray(n["bias"])

    put_doubleconv("inc", tree["inc"], trunk_conv)
    for i in (1, 2, 3):
        put_stage(f"down{i}", tree[f"down{i}"], is_down=True)
        put_stage(f"up{i}", tree[f"up{i}"], is_down=False)
    for i in (1, 2, 3):
        put_doubleconv(f"bot{i}", tree[f"bot{i}"], trunk_conv)
    for i in range(1, 7):
        put_attention(f"sa{i}", tree[f"sa{i}"])
    out["outc.weight"] = np.asarray(tree["outc"]["kernel"]).transpose(3, 2, 0, 1)
    out["outc.bias"] = np.asarray(tree["outc"]["bias"])
    if "label_emb" in tree:
        out["label_emb.weight"] = np.asarray(tree["label_emb"]["embed"]["embedding"])
    return out


def load_torch_checkpoint(path: str) -> dict:
    """A reference ``.pt`` checkpoint (a bare ``state_dict``) as the JAX
    parameter tree; read with ``weights_only=True``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return torch_to_flax(sd)


def load_reference_state_dict(path: str, config: TrainConfig, device="cuda") -> UNet:
    """The port's UNet for ``config`` on ``device`` with the weights of a
    reference ``.pt`` checkpoint, loaded with ``strict=True``."""
    return build_model(config, device=device,
                       state_dict=params_from_jax(load_torch_checkpoint(path)))
