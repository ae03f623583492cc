"""InceptionV3 feature extractor for published-comparable FID/IS/KID.

Counterpart of ``aliasfree_diffusion_models_pytorch_tpu/eval_inception.py``:
the "FID Inception" network (the TF-Slim InceptionV3 that the original FID
implementation used), structurally torchvision's ``inception_v3`` with three
quirks:

* every in-block average pool uses ``count_include_pad=False``;
* the last Inception-E block (``Mixed_7c``) pools with MAX instead of AVG;
* the classifier has 1008 outputs (TF legacy classes).

The forward is a set of functions over a parameter dict ``{module: {leaf:
tensor}}`` on NCHW tensors, with the torchvision layer names and PyTorch's
own layouts (conv ``OIHW``), BatchNorm folded into a scale and a shift at eps
1e-3. The convolutions and the ``fc`` product are plain ``F.conv2d`` /
``matmul`` (library calls on the JAX side too, outside any hand-written
kernel). Weights load from a LOCAL file only: a ``pt_inception-2015-12-05`` /
torchvision state dict (``.pt``, read with ``weights_only=True``) or the
``.npz`` of :meth:`InceptionV3Torch.save_npz`, whose layout (``module|leaf``
keys, conv kernels ``HWIO``) is the JAX package's, so either package reads
the other's file. Output: 2048-d pool features (FID/KID) and the softmax over
the classifier's outputs (IS).

Inputs follow the pytorch-fid protocol: uint8 [0, 255] → /255 → bilinear
resize to 299x299 (align_corners=False) → scale to [-1, 1].
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

Params = dict[str, dict[str, torch.Tensor]]


def _conv_bn(params: Params, name: str, x, stride=1, padding=0):
    """BasicConv2d: conv(bias=False) → BN(eps=1e-3, inference) → relu.
    ``padding`` is an int or ((h_lo, h_hi), (w_lo, w_hi)), symmetric per axis."""
    p = params[name]
    if not isinstance(padding, int):
        (hlo, hhi), (wlo, whi) = padding
        if hlo != hhi or wlo != whi:
            raise ValueError(f"asymmetric padding {padding}")
        padding = (hlo, wlo)
    x = F.conv2d(x, p["conv.weight"], stride=stride, padding=padding)
    scale = p["bn.weight"] / torch.sqrt(p["bn.running_var"] + 1e-3)
    shift = p["bn.bias"] - p["bn.running_mean"] * scale
    return F.relu(x * scale[None, :, None, None] + shift[None, :, None, None])


def _avg_pool_3x3_no_pad_count(x):
    """3x3/s1/p1 average pool with count_include_pad=False (FID quirk)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool(x, k, s, pad=0):
    return F.max_pool2d(x, k, stride=s, padding=pad)


def _inception_a(params, prefix, x):
    b1 = _conv_bn(params, f"{prefix}.branch1x1", x)
    b5 = _conv_bn(params, f"{prefix}.branch5x5_1", x)
    b5 = _conv_bn(params, f"{prefix}.branch5x5_2", b5, padding=2)
    b3 = _conv_bn(params, f"{prefix}.branch3x3dbl_1", x)
    b3 = _conv_bn(params, f"{prefix}.branch3x3dbl_2", b3, padding=1)
    b3 = _conv_bn(params, f"{prefix}.branch3x3dbl_3", b3, padding=1)
    bp = _avg_pool_3x3_no_pad_count(x)
    bp = _conv_bn(params, f"{prefix}.branch_pool", bp)
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(params, prefix, x):
    b3 = _conv_bn(params, f"{prefix}.branch3x3", x, stride=2)
    bd = _conv_bn(params, f"{prefix}.branch3x3dbl_1", x)
    bd = _conv_bn(params, f"{prefix}.branch3x3dbl_2", bd, padding=1)
    bd = _conv_bn(params, f"{prefix}.branch3x3dbl_3", bd, stride=2)
    bp = _max_pool(x, 3, 2)
    return torch.cat([b3, bd, bp], dim=1)


_PAD_W3 = ((0, 0), (3, 3))  # a 1x7 kernel
_PAD_H3 = ((3, 3), (0, 0))  # a 7x1 kernel


def _inception_c(params, prefix, x):
    b1 = _conv_bn(params, f"{prefix}.branch1x1", x)
    b7 = _conv_bn(params, f"{prefix}.branch7x7_1", x)
    b7 = _conv_bn(params, f"{prefix}.branch7x7_2", b7, padding=_PAD_W3)
    b7 = _conv_bn(params, f"{prefix}.branch7x7_3", b7, padding=_PAD_H3)
    bd = _conv_bn(params, f"{prefix}.branch7x7dbl_1", x)
    bd = _conv_bn(params, f"{prefix}.branch7x7dbl_2", bd, padding=_PAD_H3)
    bd = _conv_bn(params, f"{prefix}.branch7x7dbl_3", bd, padding=_PAD_W3)
    bd = _conv_bn(params, f"{prefix}.branch7x7dbl_4", bd, padding=_PAD_H3)
    bd = _conv_bn(params, f"{prefix}.branch7x7dbl_5", bd, padding=_PAD_W3)
    bp = _avg_pool_3x3_no_pad_count(x)
    bp = _conv_bn(params, f"{prefix}.branch_pool", bp)
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(params, prefix, x):
    b3 = _conv_bn(params, f"{prefix}.branch3x3_1", x)
    b3 = _conv_bn(params, f"{prefix}.branch3x3_2", b3, stride=2)
    b7 = _conv_bn(params, f"{prefix}.branch7x7x3_1", x)
    b7 = _conv_bn(params, f"{prefix}.branch7x7x3_2", b7, padding=_PAD_W3)
    b7 = _conv_bn(params, f"{prefix}.branch7x7x3_3", b7, padding=_PAD_H3)
    b7 = _conv_bn(params, f"{prefix}.branch7x7x3_4", b7, stride=2)
    bp = _max_pool(x, 3, 2)
    return torch.cat([b3, b7, bp], dim=1)


def _inception_e(params, prefix, x, pool: str):
    b1 = _conv_bn(params, f"{prefix}.branch1x1", x)
    b3 = _conv_bn(params, f"{prefix}.branch3x3_1", x)
    b3 = torch.cat(
        [
            _conv_bn(params, f"{prefix}.branch3x3_2a", b3, padding=((0, 0), (1, 1))),
            _conv_bn(params, f"{prefix}.branch3x3_2b", b3, padding=((1, 1), (0, 0))),
        ],
        dim=1,
    )
    bd = _conv_bn(params, f"{prefix}.branch3x3dbl_1", x)
    bd = _conv_bn(params, f"{prefix}.branch3x3dbl_2", bd, padding=1)
    bd = torch.cat(
        [
            _conv_bn(params, f"{prefix}.branch3x3dbl_3a", bd, padding=((0, 0), (1, 1))),
            _conv_bn(params, f"{prefix}.branch3x3dbl_3b", bd, padding=((1, 1), (0, 0))),
        ],
        dim=1,
    )
    if pool == "max":  # FID-Inception quirk in the final block
        bp = _max_pool(x, 3, 1, pad=1)
    else:
        bp = _avg_pool_3x3_no_pad_count(x)
    bp = _conv_bn(params, f"{prefix}.branch_pool", bp)
    return torch.cat([b1, b3, bd, bp], dim=1)


def inception_forward(params: Params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (N, 3, 299, 299) in [-1, 1] → (features (N, 2048), logits (N, C))."""
    x = _conv_bn(params, "Conv2d_1a_3x3", x, stride=2)
    x = _conv_bn(params, "Conv2d_2a_3x3", x)
    x = _conv_bn(params, "Conv2d_2b_3x3", x, padding=1)
    x = _max_pool(x, 3, 2)
    x = _conv_bn(params, "Conv2d_3b_1x1", x)
    x = _conv_bn(params, "Conv2d_4a_3x3", x)
    x = _max_pool(x, 3, 2)
    x = _inception_a(params, "Mixed_5b", x)
    x = _inception_a(params, "Mixed_5c", x)
    x = _inception_a(params, "Mixed_5d", x)
    x = _inception_b(params, "Mixed_6a", x)
    x = _inception_c(params, "Mixed_6b", x)
    x = _inception_c(params, "Mixed_6c", x)
    x = _inception_c(params, "Mixed_6d", x)
    x = _inception_c(params, "Mixed_6e", x)
    x = _inception_d(params, "Mixed_7a", x)
    x = _inception_e(params, "Mixed_7b", x, pool="avg")
    x = _inception_e(params, "Mixed_7c", x, pool="max")
    feats = x.mean(dim=(2, 3))  # global average pool → (N, 2048)
    logits = feats @ params["fc"]["weight"].T + params["fc"]["bias"]
    return feats, logits


def conv_shapes() -> dict[str, tuple[int, int, int, int]]:
    """The architecture table: every BasicConv2d's name → its weight shape
    (c_out, c_in, kh, kw), in forward order."""
    table: dict[str, tuple[int, int, int, int]] = {}

    def add(name, cin, cout, kh=1, kw=1):
        table[name] = (cout, cin, kh, kw)

    add("Conv2d_1a_3x3", 3, 32, 3, 3)
    add("Conv2d_2a_3x3", 32, 32, 3, 3)
    add("Conv2d_2b_3x3", 32, 64, 3, 3)
    add("Conv2d_3b_1x1", 64, 80)
    add("Conv2d_4a_3x3", 80, 192, 3, 3)
    c = 192
    for p, pool in (("Mixed_5b", 32), ("Mixed_5c", 64), ("Mixed_5d", 64)):
        add(f"{p}.branch1x1", c, 64)
        add(f"{p}.branch5x5_1", c, 48)
        add(f"{p}.branch5x5_2", 48, 64, 5, 5)
        add(f"{p}.branch3x3dbl_1", c, 64)
        add(f"{p}.branch3x3dbl_2", 64, 96, 3, 3)
        add(f"{p}.branch3x3dbl_3", 96, 96, 3, 3)
        add(f"{p}.branch_pool", c, pool)
        c = 64 + 64 + 96 + pool
    p = "Mixed_6a"
    add(f"{p}.branch3x3", c, 384, 3, 3)
    add(f"{p}.branch3x3dbl_1", c, 64)
    add(f"{p}.branch3x3dbl_2", 64, 96, 3, 3)
    add(f"{p}.branch3x3dbl_3", 96, 96, 3, 3)
    c = 384 + 96 + c
    for p, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160), ("Mixed_6e", 192)):
        add(f"{p}.branch1x1", c, 192)
        add(f"{p}.branch7x7_1", c, c7)
        add(f"{p}.branch7x7_2", c7, c7, 1, 7)
        add(f"{p}.branch7x7_3", c7, 192, 7, 1)
        add(f"{p}.branch7x7dbl_1", c, c7)
        add(f"{p}.branch7x7dbl_2", c7, c7, 7, 1)
        add(f"{p}.branch7x7dbl_3", c7, c7, 1, 7)
        add(f"{p}.branch7x7dbl_4", c7, c7, 7, 1)
        add(f"{p}.branch7x7dbl_5", c7, 192, 1, 7)
        add(f"{p}.branch_pool", c, 192)
    p = "Mixed_7a"
    add(f"{p}.branch3x3_1", c, 192)
    add(f"{p}.branch3x3_2", 192, 320, 3, 3)
    add(f"{p}.branch7x7x3_1", c, 192)
    add(f"{p}.branch7x7x3_2", 192, 192, 1, 7)
    add(f"{p}.branch7x7x3_3", 192, 192, 7, 1)
    add(f"{p}.branch7x7x3_4", 192, 192, 3, 3)
    c = 320 + 192 + c
    for p in ("Mixed_7b", "Mixed_7c"):
        add(f"{p}.branch1x1", c, 320)
        add(f"{p}.branch3x3_1", c, 384)
        add(f"{p}.branch3x3_2a", 384, 384, 1, 3)
        add(f"{p}.branch3x3_2b", 384, 384, 3, 1)
        add(f"{p}.branch3x3dbl_1", c, 448)
        add(f"{p}.branch3x3dbl_2", 448, 384, 3, 3)
        add(f"{p}.branch3x3dbl_3a", 384, 384, 1, 3)
        add(f"{p}.branch3x3dbl_3b", 384, 384, 3, 1)
        add(f"{p}.branch_pool", c, 192)
        c = 2048
    return table


def random_state_dict(seed: int = 0, num_classes: int = 1008) -> dict[str, np.ndarray]:
    """A seeded random state dict in the torchvision layout (numpy float32),
    for checks that need the network's shapes but not its trained weights:
    conv weights N(0, 0.05²), BatchNorm weight N(1, 0.2²), bias N(0, 0.2²),
    running mean N(0, 0.5²), running variance U(0.5, 2), fc N(0, 0.02²)."""
    rng = np.random.default_rng(seed)

    def normal(shape, mean, std):
        return (mean + std * rng.standard_normal(shape)).astype(np.float32)

    sd: dict[str, np.ndarray] = {}
    for name, shape in conv_shapes().items():
        cout = shape[0]
        sd[f"{name}.conv.weight"] = normal(shape, 0.0, 0.05)
        sd[f"{name}.bn.weight"] = normal((cout,), 1.0, 0.2)
        sd[f"{name}.bn.bias"] = normal((cout,), 0.0, 0.2)
        sd[f"{name}.bn.running_mean"] = normal((cout,), 0.0, 0.5)
        sd[f"{name}.bn.running_var"] = rng.uniform(0.5, 2.0, (cout,)).astype(np.float32)
        sd[f"{name}.bn.num_batches_tracked"] = np.zeros((), np.int64)
    sd["fc.weight"] = normal((num_classes, 2048), 0.0, 0.02)
    sd["fc.bias"] = normal((num_classes,), 0.0, 0.02)
    return sd


def _split_key(key: str) -> tuple[str, str] | None:
    """``Mixed_5b.branch1x1.conv.weight`` → (``Mixed_5b.branch1x1``,
    ``conv.weight``); None for entries the forward does not use."""
    if key.startswith("AuxLogits"):
        return None
    if key.startswith("fc."):
        return "fc", key[3:]
    parts = key.split(".")
    mod, leaf = ".".join(parts[:-2]), ".".join(parts[-2:])
    if leaf.startswith("bn.num_batches"):
        return None
    return mod, leaf


def params_from_state_dict(sd: Mapping) -> Params:
    """torchvision / pt_inception state dict → the nested parameter dict
    (float32 tensors on the CPU, PyTorch's layouts as they are). Aux
    classifier tensors (``AuxLogits.*``) are dropped."""
    out: Params = {}
    for key, raw in sd.items():
        split = _split_key(key)
        if split is None:
            continue
        mod, leaf = split
        out.setdefault(mod, {})[leaf] = torch.as_tensor(np.asarray(
            raw.detach().cpu().numpy() if hasattr(raw, "detach") else raw)).float()
    return out


def params_from_jax_inception(tree: Mapping[str, Mapping[str, np.ndarray]]) -> Params:
    """The JAX package's nested Inception dict (numpy leaves, conv kernels
    ``HWIO``) → the port's (conv kernels ``OIHW``)."""
    out: Params = {}
    for mod, leaves in tree.items():
        for leaf, value in leaves.items():
            value = np.asarray(value, np.float32)
            if leaf == "conv.weight":
                value = value.transpose(3, 2, 0, 1)
            out.setdefault(mod, {})[leaf] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def params_to_jax_inception(params: Params) -> dict[str, dict[str, np.ndarray]]:
    """The inverse of :func:`params_from_jax_inception`."""
    out: dict[str, dict[str, np.ndarray]] = {}
    for mod, leaves in params.items():
        for leaf, tensor in leaves.items():
            value = tensor.detach().to("cpu", torch.float32).numpy()
            if leaf == "conv.weight":
                value = value.transpose(2, 3, 1, 0)
            out.setdefault(mod, {})[leaf] = np.ascontiguousarray(value)
    return out


@dataclasses.dataclass
class InceptionV3Torch:
    """FeatureExtractor-protocol implementation backed by local weights.

    ``weights_path`` is a torch ``.pt``/``.pth`` state dict or an ``.npz``
    written by :meth:`save_npz` (or by the JAX package's ``save_npz``).
    """

    weights_path: str
    batch_size: int = 64
    device: str = "cuda"
    name: str = "inception-v3-fid"

    def __post_init__(self):
        if not os.path.exists(self.weights_path):
            raise FileNotFoundError(
                f"InceptionV3 weights not found at {self.weights_path!r}; "
                "cache torchvision inception_v3 / pt_inception weights locally "
                "(no network egress in this environment)."
            )
        if self.weights_path.endswith(".npz"):
            tree: dict = {}
            with np.load(self.weights_path) as z:
                for k in z.files:
                    mod, leaf = k.split("|")
                    tree.setdefault(mod, {})[leaf] = z[k]
            params = params_from_jax_inception(tree)
        else:
            sd = torch.load(self.weights_path, map_location="cpu", weights_only=True)
            if hasattr(sd, "state_dict"):
                sd = sd.state_dict()
            params = params_from_state_dict(sd)
        device = torch.device(self.device)
        self.params = {mod: {leaf: t.to(device) for leaf, t in leaves.items()}
                       for mod, leaves in params.items()}

    def save_npz(self, path: str) -> None:
        """Write the weights as ``module|leaf`` arrays, conv kernels ``HWIO``:
        the layout of the JAX package's ``InceptionV3Flax.save_npz``."""
        flat = {
            f"{mod}|{leaf}": v
            for mod, leaves in params_to_jax_inception(self.params).items()
            for leaf, v in leaves.items()
        }
        np.savez(path, **flat)

    def _preprocess(self, images_u8: np.ndarray) -> np.ndarray:
        from aliasfree_diffusion_models_pytorch_tpu_torch.data import resize_bilinear_np

        x = images_u8.astype(np.float32) / 255.0
        if x.shape[-1] == 1:
            x = np.repeat(x, 3, axis=-1)
        x = resize_bilinear_np(x, 299)
        return (x - 0.5) * 2.0

    @torch.inference_mode()
    def _run(self, images_u8: np.ndarray):
        from aliasfree_diffusion_models_pytorch_tpu_torch.eval import full_float32

        device = torch.device(self.device)
        feats, probs = [], []
        with full_float32():
            for i in range(0, len(images_u8), self.batch_size):
                x = torch.from_numpy(np.ascontiguousarray(
                    self._preprocess(images_u8[i : i + self.batch_size])))
                f, logits = inception_forward(self.params, x.to(device).permute(0, 3, 1, 2))
                feats.append(f.cpu().numpy())
                probs.append(torch.softmax(logits, dim=-1).cpu().numpy())
        return np.concatenate(feats), np.concatenate(probs)

    def features(self, images_u8: np.ndarray) -> np.ndarray:
        return self._run(images_u8)[0]

    def logits(self, images_u8: np.ndarray) -> np.ndarray:
        return self._run(images_u8)[1]
