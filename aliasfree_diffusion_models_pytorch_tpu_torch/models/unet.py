"""Versioned UNet denoiser (``nn.Module``; NHWC in and out, NCHW inside).

Port of ``aliasfree_diffusion_models_pytorch_tpu/models/unet.py``: one
skeleton for variants 0-4 plus the variant → (resample, conv) table.
Widths follow ``base_width`` (default: ``image_size``, the reference quirk):

    inc:   DoubleConv(c_in → S)
    down1: S → 2S   @ S/2      sa1(2S)
    down2: 2S → 4S  @ S/4      sa2(4S)
    down3: 4S → 4S  @ S/8      sa3(4S)
    bot:   4S → 8S → 8S → 4S
    up1:   (4S + skip 4S) → 2S @ S/4   sa4(2S)
    up2:   (2S + skip 2S) → S  @ S/2   sa5(S)
    up3:   (S + skip S)   → S  @ S     sa6(S)
    outc:  Conv1x1(S → c_out)

The input is cast to the module's dtype (bf16 after ``.to(torch.bfloat16)``)
and the output is returned in f32, as the JAX model's ``dtype`` option does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.models.blocks import (
    DoubleConv,
    Down,
    LabelEmbedding,
    SelfAttention,
    Up,
)

# variant → (down resample, up resample, stage conv, trunk conv (inc + bottleneck))
VARIANT_SPEC: dict[int, tuple[str, str, str, str]] = {
    0: ("maxpool", "bilinear", "plain", "plain"),
    1: ("aliasfree", "aliasfree", "plain", "plain"),
    2: ("maxpool", "bilinear", "filtered", "filtered"),
    3: ("aliasfree", "aliasfree", "filtered", "filtered"),
    4: ("aliasfree", "aliasfree", "filtered4", "filtered4"),
}

VARIANT_NAMES = {
    0: "Config A — baseline UNet",
    1: "Config B — alias-free up/downsampling",
    2: "Config C — filtered nonlinearities",
    3: "Config D — alias-free resampling + filtered nonlinearities",
    4: "variant 4 (unpublished) — D with post-upsample GroupNorm",
}


@functools.lru_cache(maxsize=8)
def _time_embedding_table(table_size: int, channels: int) -> np.ndarray:
    """Exact sinusoidal table for integer timesteps [0, table_size):
    ``concat[sin(t*inv_freq), cos(t*inv_freq)]`` with inv_freq correctly
    rounded to f32 and sin/cos evaluated in float64. The cached array is
    shared: do not write to it."""
    t = np.arange(table_size, dtype=np.float64)[:, None]
    inv_freq = (
        1.0 / (10000.0 ** (np.arange(0, channels, 2, dtype=np.float64) / channels))
    ).astype(np.float32).astype(np.float64)
    ang = t * inv_freq[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


class UNet(nn.Module):
    """Denoiser ``eps_theta(x_t, t[, y, y_mask])`` with 5 selectable topologies.

    ``x`` is NHWC; ``t`` integer timesteps (B,), looked up in the exact table
    with out-of-range values clipped to its ends; ``y`` class labels (B,) for
    a conditional model; ``y_mask`` (B,) gates the label embedding per sample
    (1 keeps it, 0 gives the unconditional model — the CFG batch).
    """

    def __init__(self, c_in: int = 3, c_out: int = 3, image_size: int = 64,
                 base_width: int | None = None, time_dim: int = 256,
                 filters: FilterSettings | None = None, num_classes: int | None = None,
                 variant: int = 0, time_table_size: int = 1024):
        super().__init__()
        if variant not in VARIANT_SPEC:
            raise ValueError("variant value must be between 0 and 4")
        if variant != 0 and filters is None:
            raise ValueError("f_settings is empty")  # reference error string
        s = int(base_width) if base_width is not None else int(image_size)
        if s < 4 or s % 4 != 0:
            raise ValueError(
                f"base width {s} must be a positive multiple of 4 (4-head attention)")
        self.c_in, self.c_out, self.image_size = c_in, c_out, image_size
        self.base_width, self.time_dim, self.variant = base_width, time_dim, variant
        self.num_classes = num_classes
        down_rs, up_rs, stage, trunk = VARIANT_SPEC[variant]
        st = dict(conv_mode=stage, filters=filters)
        tr = dict(conv_mode=trunk, filters=filters)

        self.register_buffer(
            "time_table",
            torch.from_numpy(_time_embedding_table(time_table_size, time_dim).copy()),
            persistent=False,
        )
        self.inc = DoubleConv(c_in, s, **tr)
        self.down1 = Down(s, 2 * s, time_dim, resample=down_rs, **st)
        self.sa1 = SelfAttention(2 * s)
        self.down2 = Down(2 * s, 4 * s, time_dim, resample=down_rs, **st)
        self.sa2 = SelfAttention(4 * s)
        self.down3 = Down(4 * s, 4 * s, time_dim, resample=down_rs, **st)
        self.sa3 = SelfAttention(4 * s)
        self.bot1 = DoubleConv(4 * s, 8 * s, **tr)
        self.bot2 = DoubleConv(8 * s, 8 * s, **tr)
        self.bot3 = DoubleConv(8 * s, 4 * s, **tr)
        self.up1 = Up(4 * s, 4 * s, 2 * s, time_dim, resample=up_rs, **st)
        self.sa4 = SelfAttention(2 * s)
        self.up2 = Up(2 * s, 2 * s, s, time_dim, resample=up_rs, **st)
        self.sa5 = SelfAttention(s)
        self.up3 = Up(s, s, s, time_dim, resample=up_rs, **st)
        self.sa6 = SelfAttention(s)
        self.outc = nn.Conv2d(s, c_out, 1)
        if num_classes is not None:
            self.label_emb = LabelEmbedding(num_classes, time_dim)

    def forward(self, x, t, y=None, y_mask=None):
        dtype = self.outc.weight.dtype
        idx = t.to(torch.long).clamp(0, self.time_table.shape[0] - 1)
        t_emb = self.time_table[idx].to(dtype)
        if y is not None:
            if self.num_classes is None:
                raise ValueError("num_classes must be set for conditional mode")
            label_emb = self.label_emb(y)
            if y_mask is not None:
                label_emb = label_emb * y_mask.to(label_emb.dtype)[:, None]
            t_emb = t_emb + label_emb

        x1 = self.inc(x.to(dtype).permute(0, 3, 1, 2))
        x2 = self.sa1(self.down1(x1, t_emb))
        x3 = self.sa2(self.down2(x2, t_emb))
        x4 = self.sa3(self.down3(x3, t_emb))
        x4 = self.bot3(self.bot2(self.bot1(x4)))
        h = self.sa4(self.up1(x4, x3, t_emb))
        h = self.sa5(self.up2(h, x2, t_emb))
        h = self.sa6(self.up3(h, x1, t_emb))
        return self.outc(h).permute(0, 2, 3, 1).float()


def build_model(config: TrainConfig, device="cuda", state_dict=None) -> UNet:
    """The configured UNet on ``device``, in the config's compute dtype.

    ``state_dict`` (e.g. from ``utils.weights``) is loaded with
    ``strict=True``; without one the model keeps its construction-time
    initialisation (use ``utils.weights.init_params`` for a seeded one).
    """
    model = UNet(
        c_in=config.image_channels,
        c_out=config.image_channels,
        image_size=config.image_size,
        base_width=config.base_width,
        time_dim=config.time_dim,
        filters=config.filters,
        variant=config.variant,
        num_classes=config.num_classes,
        # The exact-embedding table covers every timestep t < noise_steps.
        time_table_size=max(1024, config.noise_steps),
    )
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
    return model.to(device=device, dtype=dtype).eval()


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


# Module order + activation resolution divisor of the shared skeleton.
_SKELETON = [
    ("inc", 1), ("down1", 2), ("sa1", 2), ("down2", 4), ("sa2", 4),
    ("down3", 8), ("sa3", 8), ("bot1", 8), ("bot2", 8), ("bot3", 8),
    ("up1", 4), ("sa4", 4), ("up2", 2), ("sa5", 2), ("up3", 1), ("sa6", 1),
    ("outc", 1), ("label_emb", None),
]


def model_summary(model: UNet) -> str:
    """One row per top-level module: parameter count, output resolution and
    the parameter shapes (PyTorch layout)."""
    s = int(model.image_size)
    lines = [
        f"UNet variant {model.variant}: {VARIANT_NAMES[model.variant]}",
        f"  in {model.c_in}ch -> out {model.c_out}ch @ {s}x{s}, "
        f"time_dim={model.time_dim}"
        + (f", base_width={model.base_width}" if model.base_width else "")
        + (f", num_classes={model.num_classes}" if model.num_classes else ""),
        "",
        f"{'module':<10} {'params':>10}  {'out res':>7}  leaf shapes",
    ]
    total = 0
    for name, r in _SKELETON:
        child = getattr(model, name, None)
        if child is None:
            continue
        params = list(child.parameters())
        n = sum(p.numel() for p in params)
        total += n
        res_str = f"{s // r}x{s // r}" if r else "-"
        shapes = ", ".join("x".join(map(str, p.shape)) for p in params)
        lines.append(f"{name:<10} {n:>10,}  {res_str:>7}  {shapes}")
    lines.append(f"{'total':<10} {total:>10,}")
    return "\n".join(lines)
