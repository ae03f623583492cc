"""UNet building blocks (``nn.Module``, NCHW inside).

Port of ``aliasfree_diffusion_models_pytorch_tpu/models/blocks.py``. Module
and attribute names follow the JAX parameter tree (``conv1/conv/kernel`` is
``conv1.conv.weight`` here), so converting weights is a per-leaf transpose
(``utils/weights.py``). ``Down``/``Up`` are parameterised by resample mode
and conv mode as in the JAX package:

=============  ==========================  ============================
reference      resample                    conv
=============  ==========================  ============================
``Down``       ``maxpool``                 ``plain``       (variant 0)
``Down_F``     ``maxpool``                 ``filtered``    (variant 2)
``Down_FF``    ``aliasfree``               ``plain``       (variant 1)
``Down_FFF``   ``aliasfree``               ``filtered``    (variant 3)
``Down_F4``    ``aliasfree``               ``filtered4``   (variant 4)
``Up``         ``bilinear``                ``plain``
``Up_FFF``     ``aliasfree``               ``filtered``    (and so on)
=============  ==========================  ============================

Numerics: exact (erf) GELU on f32 and the JAX package's polynomial on bf16,
GroupNorm(1 group) with eps 1e-5, LayerNorm eps 1e-5, align_corners=True
bilinear upsampling. Filter taps are non-persistent buffers: they follow the
module's device and dtype and stay out of the ``state_dict``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings
from aliasfree_diffusion_models_pytorch_tpu_torch.ops.filters import circular_lowpass_kernel
from aliasfree_diffusion_models_pytorch_tpu_torch.ops.flash_attention import flash_mha
from aliasfree_diffusion_models_pytorch_tpu_torch.ops.layer_norm import TokenLayerNorm
from aliasfree_diffusion_models_pytorch_tpu_torch.ops.resample import (
    downsample2x,
    filtered_gelu,
    gelu_exact,
    maxpool2x,
    upsample2x,
    upsample_bilinear_align_corners,
)


def design_taps(f: FilterSettings) -> tuple[np.ndarray, np.ndarray]:
    """(up_taps, down_taps) from the filter settings: one circularly-symmetric
    design, differing only in cutoff."""
    down = circular_lowpass_kernel(
        f.omega_c_down, f.kernel_size, f.kaiser_beta, normalize=f.normalize
    )
    up = circular_lowpass_kernel(
        f.omega_c_up, f.kernel_size, f.kaiser_beta, normalize=f.normalize
    )
    return up, down


def _register_taps(module: nn.Module, filters: FilterSettings | None) -> None:
    if filters is None:
        raise ValueError("f_settings is empty")  # reference error string
    up, down = design_taps(filters)
    module.register_buffer("up_taps", torch.from_numpy(up), persistent=False)
    module.register_buffer("down_taps", torch.from_numpy(down), persistent=False)


class Conv3x3(nn.Module):
    """3x3 SAME conv, no bias — the DoubleConv workhorse."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)

    def forward(self, x):
        return self.conv(x)


class GroupNorm1(nn.Module):
    """``nn.GroupNorm(1, C)`` (eps 1e-5): LayerNorm over (C, H, W) with a
    per-channel affine."""

    def __init__(self, channels: int):
        super().__init__()
        self.gn = nn.GroupNorm(1, channels, eps=1e-5)

    def forward(self, x):
        return self.gn(x)


class FilteredGELU(nn.Module):
    """2x alias-free upsample → GELU → 2x alias-free downsample: the conv form
    in f32, the polyphase form in bf16 (the kernel pair on the card), as
    :func:`~aliasfree_diffusion_models_pytorch_tpu_torch.ops.resample.fg_impl`
    picks."""

    def __init__(self, filters: FilterSettings):
        super().__init__()
        _register_taps(self, filters)

    def forward(self, x):
        return filtered_gelu(x, self.up_taps, self.down_taps)


class DoubleConv(nn.Module):
    """conv3x3 → GN → GELU → conv3x3 → GN, optional residual.

    ``conv_mode``: ``"plain"`` (reference ``DoubleConv``), ``"filtered"``
    (``DoubleConv_F``: filtered GELU, and a second one after the residual
    add), ``"filtered4"`` (``DoubleConv_F4``: GroupNorm in the upsampled
    domain; the residual tail applies ``norm2`` a second time).
    """

    def __init__(self, in_channels: int, out_channels: int, mid_channels: int | None = None,
                 residual: bool = False, conv_mode: str = "plain",
                 filters: FilterSettings | None = None):
        super().__init__()
        if conv_mode not in ("plain", "filtered", "filtered4"):
            raise ValueError(f"unknown conv_mode {conv_mode!r}")
        mid = mid_channels or out_channels
        self.residual = residual
        self.conv_mode = conv_mode
        self.conv1 = Conv3x3(in_channels, mid)
        self.norm1 = GroupNorm1(mid)
        self.conv2 = Conv3x3(mid, out_channels)
        self.norm2 = GroupNorm1(out_channels)
        if conv_mode == "filtered":
            self.fgelu = FilteredGELU(filters)
        elif conv_mode == "filtered4":
            _register_taps(self, filters)

    def forward(self, x):
        if self.conv_mode == "plain":
            h = self.norm2(self.conv2(gelu_exact(self.norm1(self.conv1(x)))))
            return gelu_exact(x + h) if self.residual else h

        if self.conv_mode == "filtered":
            h = self.norm2(self.conv2(self.fgelu(self.norm1(self.conv1(x)))))
            return self.fgelu(h + x) if self.residual else h

        # filtered4: norm in the upsampled (high-res) domain.
        h = upsample2x(self.conv1(x), self.up_taps)
        h = gelu_exact(self.norm1(h))
        h = self.norm2(self.conv2(downsample2x(h, self.down_taps)))
        if not self.residual:
            return h
        h = upsample2x(h + x, self.up_taps)
        h = gelu_exact(self.norm2(h))  # same parameters a second time — reference quirk
        return downsample2x(h, self.down_taps)


class TimeEmbedAdd(nn.Module):
    """SiLU → Linear(emb_dim → C), broadcast-added over the spatial map."""

    def __init__(self, emb_dim: int, channels: int):
        super().__init__()
        self.proj = nn.Linear(emb_dim, channels)

    def forward(self, x, t_emb):
        return x + self.proj(F.silu(t_emb))[:, :, None, None]


class Down(nn.Module):
    """Encoder stage: 2x downsample → DoubleConv(residual) → DoubleConv → +t-emb."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int,
                 resample: str = "maxpool", conv_mode: str = "plain",
                 filters: FilterSettings | None = None):
        super().__init__()
        if resample not in ("maxpool", "aliasfree"):
            raise ValueError(f"unknown resample {resample!r}")
        self.resample = resample
        if resample == "aliasfree":
            _register_taps(self, filters)
        kw = dict(conv_mode=conv_mode, filters=filters)
        self.conv_res = DoubleConv(in_channels, in_channels, residual=True, **kw)
        self.conv_out = DoubleConv(in_channels, out_channels, **kw)
        self.emb = TimeEmbedAdd(emb_dim, out_channels)

    def forward(self, x, t_emb):
        x = maxpool2x(x) if self.resample == "maxpool" else downsample2x(x, self.down_taps)
        return self.emb(self.conv_out(self.conv_res(x)), t_emb)


class Up(nn.Module):
    """Decoder stage: 2x upsample → concat(skip, x) → convs → +t-emb.
    The skip tensor comes first in the concat."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int, emb_dim: int,
                 resample: str = "bilinear", conv_mode: str = "plain",
                 filters: FilterSettings | None = None):
        super().__init__()
        if resample not in ("bilinear", "aliasfree"):
            raise ValueError(f"unknown resample {resample!r}")
        self.resample = resample
        if resample == "aliasfree":
            _register_taps(self, filters)
        cat = in_channels + skip_channels
        kw = dict(conv_mode=conv_mode, filters=filters)
        self.conv_res = DoubleConv(cat, cat, residual=True, **kw)
        self.conv_out = DoubleConv(cat, out_channels, mid_channels=cat // 2, **kw)
        self.emb = TimeEmbedAdd(emb_dim, out_channels)

    def forward(self, x, skip, t_emb):
        if self.resample == "bilinear":
            x = upsample_bilinear_align_corners(x, 2)
        else:
            x = upsample2x(x, self.up_taps)
        x = torch.cat([skip, x], dim=1)
        return self.emb(self.conv_out(self.conv_res(x)), t_emb)


class SelfAttention(nn.Module):
    """Pre-LN transformer block on the flattened spatial tokens.

    LN → 4-head self-attention (residual) → [LN → Linear → GELU → Linear]
    (residual). One ``Linear(c, 3c)`` projects q, k and v (torch
    ``nn.MultiheadAttention``'s packed layout, xavier init, zero bias); the
    out-projection bias is zero at init. Every call goes through
    :func:`flash_mha`: the CUDA kernels on the card (forward, and backward
    under autograd), their plain versions on the CPU. Both LayerNorms are
    :class:`TokenLayerNorm`: ``ln`` reads the NCHW map in place through the
    tokens view, ``ff_ln`` the residual sum in row order.
    """

    def __init__(self, channels: int, num_heads: int = 4):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels do not split into {num_heads} heads")
        self.num_heads = num_heads
        self.ln = TokenLayerNorm(channels, eps=1e-5)
        self.qkv = nn.Linear(channels, 3 * channels)
        self.out = nn.Linear(channels, channels)
        self.ff_ln = TokenLayerNorm(channels, eps=1e-5)
        self.ff1 = nn.Linear(channels, channels)
        self.ff2 = nn.Linear(channels, channels)

    def forward(self, x):
        n, c, h, w = x.shape
        s, heads = h * w, self.num_heads
        head_dim = c // heads
        tokens = x.flatten(2).transpose(1, 2)  # (n, S, C)
        qkv = self.qkv(self.ln(tokens))
        # (n, S, 3, heads, D) → (3, n, heads, S, D): q, k, v each contiguous.
        q, k, v = qkv.reshape(n, s, 3, heads, head_dim).permute(2, 0, 3, 1, 4).contiguous()
        attn = flash_mha(q, k, v, 1.0 / math.sqrt(head_dim))
        attn = attn.transpose(1, 2).reshape(n, s, c)
        tokens = self.out(attn) + tokens
        ff = self.ff2(gelu_exact(self.ff1(self.ff_ln(tokens))))
        tokens = ff + tokens
        return tokens.transpose(1, 2).reshape(n, c, h, w)


class LabelEmbedding(nn.Module):
    """Class-conditional embedding added to the time embedding."""

    def __init__(self, num_classes: int, time_dim: int):
        super().__init__()
        self.embed = nn.Embedding(num_classes, time_dim)

    def forward(self, y):
        return self.embed(y)
