"""The UNet denoiser, plain PyTorch, as a function of a parameter dict.

A frozen copy of the port's plain path (``models/unet.py``,
``models/blocks.py``, the conv form of ``ops/resample.py``), NHWC in and
out, NCHW inside, every layer written out with ``torch.nn.functional``:

    inc:   DoubleConv(c → S)
    down1: S → 2S @ /2, sa1;  down2: 2S → 4S @ /4, sa2;  down3: 4S → 4S @ /8, sa3
    bot1..bot3: 4S → 8S → 8S → 4S
    up1: (4S + 4S) → 2S @ /4, sa4;  up2: (2S + 2S) → S @ /2, sa5;  up3: (S + S) → S, sa6
    outc: 1×1 conv S → c

The variant picks the resampling (max pool and align-corners bilinear, or the
alias-free FIR pair) and the nonlinearity of the stage and trunk convs (exact
GELU, or the filtered GELU: 2× zero-stuffed up FIR → GELU → 2× down FIR).
GroupNorm with one group and LayerNorm take eps 1e-5; the filtered GELU of a
residual DoubleConv is applied again after the residual add, as the
reference model does. The weights are the caller's, named as the port's
``state_dict`` names them (:func:`param_shapes`), and the filter taps and the
time-embedding table are worked out here.

``prec`` rounds every activation and the operands of the convolutions,
linear layers and attention products (:mod:`portbench.reference.precision`):
nothing for the reference proper, fp8 for its control. ``count_attention=True``
runs the attention cores through a function whose backward recomputes the
scores, five products as PyTorch's SDPA formula counts them: the FLOP count
of :mod:`portbench.lib.cost` uses it; the numbers of the reference use plain
autograd.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import filters as filt
from portbench.reference.precision import F32

# variant -> (down resample, up resample, stage conv, trunk conv)
VARIANTS = {
    0: ("maxpool", "bilinear", "plain", "plain"),
    1: ("aliasfree", "aliasfree", "plain", "plain"),
    2: ("maxpool", "bilinear", "filtered", "filtered"),
    3: ("aliasfree", "aliasfree", "filtered", "filtered"),
}
HEADS = 4
EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class Model:
    """The sizes of one configuration file's model."""

    variant: int
    image_size: int
    channels: int
    width: int
    time_dim: int
    table_size: int
    filters: tuple | None  # sorted (key, value) pairs of the file's "filters"

    @classmethod
    def from_config(cls, cfg: dict) -> "Model":
        if cfg["variant"] not in VARIANTS:
            raise ValueError(f"the reference has variants {sorted(VARIANTS)}, not {cfg['variant']}")
        f = cfg.get("filters")
        return cls(variant=cfg["variant"], image_size=cfg["image_size"],
                   channels=cfg["image_channels"], width=cfg["base_width"] or cfg["image_size"],
                   time_dim=cfg["time_dim"], table_size=max(1024, cfg["noise_steps"]),
                   filters=None if f is None else tuple(sorted(f.items())))

    def taps(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        up, down = filt.design(dict(self.filters))
        return (torch.from_numpy(up).to(device), torch.from_numpy(down).to(device))


def _double_conv_shapes(prefix: str, cin: int, cout: int, mid: int | None = None) -> dict:
    mid = mid or cout
    return {f"{prefix}.conv1.conv.weight": (mid, cin, 3, 3),
            f"{prefix}.norm1.gn.weight": (mid,), f"{prefix}.norm1.gn.bias": (mid,),
            f"{prefix}.conv2.conv.weight": (cout, mid, 3, 3),
            f"{prefix}.norm2.gn.weight": (cout,), f"{prefix}.norm2.gn.bias": (cout,)}


def _attention_shapes(prefix: str, c: int) -> dict:
    return {f"{prefix}.ln.weight": (c,), f"{prefix}.ln.bias": (c,),
            f"{prefix}.qkv.weight": (3 * c, c), f"{prefix}.qkv.bias": (3 * c,),
            f"{prefix}.out.weight": (c, c), f"{prefix}.out.bias": (c,),
            f"{prefix}.ff_ln.weight": (c,), f"{prefix}.ff_ln.bias": (c,),
            f"{prefix}.ff1.weight": (c, c), f"{prefix}.ff1.bias": (c,),
            f"{prefix}.ff2.weight": (c, c), f"{prefix}.ff2.bias": (c,)}


def param_shapes(m: Model) -> dict[str, tuple]:
    """Every parameter's name and shape, in the port's ``state_dict`` order."""
    s, c, e = m.width, m.channels, m.time_dim
    shapes = _double_conv_shapes("inc", c, s)
    for name, cin, cout, sa in (("down1", s, 2 * s, "sa1"), ("down2", 2 * s, 4 * s, "sa2"),
                                ("down3", 4 * s, 4 * s, "sa3")):
        shapes.update(_double_conv_shapes(f"{name}.conv_res", cin, cin))
        shapes.update(_double_conv_shapes(f"{name}.conv_out", cin, cout))
        shapes.update({f"{name}.emb.proj.weight": (cout, e), f"{name}.emb.proj.bias": (cout,)})
        shapes.update(_attention_shapes(sa, cout))
    shapes.update(_double_conv_shapes("bot1", 4 * s, 8 * s))
    shapes.update(_double_conv_shapes("bot2", 8 * s, 8 * s))
    shapes.update(_double_conv_shapes("bot3", 8 * s, 4 * s))
    for name, cin, skip, cout, sa in (("up1", 4 * s, 4 * s, 2 * s, "sa4"),
                                      ("up2", 2 * s, 2 * s, s, "sa5"),
                                      ("up3", s, s, s, "sa6")):
        cat = cin + skip
        shapes.update(_double_conv_shapes(f"{name}.conv_res", cat, cat))
        shapes.update(_double_conv_shapes(f"{name}.conv_out", cat, cout, cat // 2))
        shapes.update({f"{name}.emb.proj.weight": (cout, e), f"{name}.emb.proj.bias": (cout,)})
        shapes.update(_attention_shapes(sa, cout))
    shapes.update({"outc.weight": (c, s, 1, 1), "outc.bias": (c,)})
    return shapes


@functools.lru_cache(maxsize=4)
def _time_table_np(size: int, dim: int) -> np.ndarray:
    """concat[sin(t·f), cos(t·f)] for t < size, f = 10000^(-2i/dim) rounded to
    float32, the angles in float64."""
    t = np.arange(size, dtype=np.float64)[:, None]
    freq = (1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))).astype(np.float32)
    ang = t * freq.astype(np.float64)[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


class _Ops:
    """The layers, rounding their operands by ``prec``."""

    def __init__(self, p: dict, m: Model, prec, device, count_attention: bool):
        self.p, self.m, self.prec = p, m, prec
        self.count_attention = count_attention
        self.up_taps = self.down_taps = None
        if m.filters is not None:
            self.up_taps, self.down_taps = m.taps(device)

    def conv(self, x, w, *, padding=0, stride=1, groups=1, bias=None):
        q = self.prec.operand
        return q(F.conv2d(q(x), q(w), bias, stride=stride, padding=padding, groups=groups))

    def linear(self, x, prefix):
        q = self.prec.operand
        return q(F.linear(q(x), q(self.p[f"{prefix}.weight"]), self.p[f"{prefix}.bias"]))

    def group_norm(self, x, prefix):
        return self.prec.operand(
            F.group_norm(x, 1, self.p[f"{prefix}.gn.weight"], self.p[f"{prefix}.gn.bias"], EPS))

    def layer_norm(self, x, prefix):
        c = x.shape[-1]
        return self.prec.operand(
            F.layer_norm(x, (c,), self.p[f"{prefix}.weight"], self.p[f"{prefix}.bias"], EPS))

    def gelu(self, x):
        return self.prec.operand(F.gelu(x))

    def fir(self, x, taps, stride):
        """SAME depthwise cross-correlation with one shared k×k filter."""
        k = taps.shape[0]
        lo, hi = (k - 1) // 2, k // 2
        c = x.shape[1]
        w = taps[None, None].expand(c, 1, k, k).to(x.dtype)
        return self.conv(F.pad(x, (lo, hi, lo, hi)), w, stride=stride, groups=c)

    def up_fir(self, x):
        """Zero-stuffing by 2, then the SAME up FIR (no gain)."""
        n, c, h, w = x.shape
        k = self.up_taps.shape[0]
        lo, hi = (k - 1) // 2, k // 2
        stuffed = x.new_zeros(n, c, lo + 2 * h + hi, lo + 2 * w + hi)
        stuffed[:, :, lo:lo + 2 * h:2, lo:lo + 2 * w:2] = x
        wt = self.up_taps[None, None].expand(c, 1, k, k).to(x.dtype)
        return self.conv(stuffed, wt, groups=c)

    def filtered_gelu(self, x):
        return self.fir(self.gelu(self.up_fir(x)), self.down_taps, 2)

    def bilinear_up(self, x):
        """×2, align_corners=True, as two separable matrix products."""
        _, _, h, w = x.shape

        def matrix(n_in, n_out):
            src = torch.arange(n_out, dtype=torch.float64) * (n_in - 1) / (n_out - 1)
            lo = src.floor().long().clamp(max=n_in - 1)
            hi = (lo + 1).clamp(max=n_in - 1)
            frac = src - lo
            mat = torch.zeros(n_out, n_in, dtype=torch.float64)
            mat[torch.arange(n_out), lo] += 1.0 - frac
            mat[torch.arange(n_out), hi] += frac
            return mat.to(dtype=x.dtype, device=x.device)

        q = self.prec.operand
        x = q(torch.einsum("oh,nchw->ncow", q(matrix(h, 2 * h)), q(x)))
        return q(torch.einsum("pw,ncow->ncop", q(matrix(w, 2 * w)), x))

    def double_conv(self, x, prefix, mode, residual=False):
        gelu = self.filtered_gelu if mode == "filtered" else self.gelu
        h = self.group_norm(self.conv(x, self.p[f"{prefix}.conv1.conv.weight"], padding=1),
                            f"{prefix}.norm1")
        h = self.group_norm(self.conv(gelu(h), self.p[f"{prefix}.conv2.conv.weight"], padding=1),
                            f"{prefix}.norm2")
        return gelu(self.prec.operand(x + h)) if residual else h

    def attention_core(self, q, k, v):
        scale = 1.0 / math.sqrt(q.shape[-1])
        if self.count_attention:
            return _CountedAttention.apply(q, k, v, scale)
        r = self.prec.operand
        p = torch.softmax(torch.matmul(r(q), r(k).transpose(-1, -2)) * scale, dim=-1)
        return r(torch.matmul(r(p), r(v)))

    def self_attention(self, x, prefix):
        n, c, h, w = x.shape
        s, d = h * w, c // HEADS
        tokens = x.flatten(2).transpose(1, 2)
        qkv = self.linear(self.layer_norm(tokens, f"{prefix}.ln"), f"{prefix}.qkv")
        q, k, v = qkv.reshape(n, s, 3, HEADS, d).permute(2, 0, 3, 1, 4)
        attn = self.attention_core(q, k, v).transpose(1, 2).reshape(n, s, c)
        r = self.prec.operand
        tokens = r(self.linear(attn, f"{prefix}.out") + tokens)
        ff = self.layer_norm(tokens, f"{prefix}.ff_ln")
        ff = self.linear(self.gelu(self.linear(ff, f"{prefix}.ff1")), f"{prefix}.ff2")
        tokens = r(ff + tokens)
        return tokens.transpose(1, 2).reshape(n, c, h, w)

    def emb(self, x, t_emb, prefix):
        return self.prec.operand(
            x + self.linear(F.silu(t_emb), f"{prefix}.emb.proj")[:, :, None, None])

    def down(self, x, t_emb, prefix, resample, mode):
        x = F.max_pool2d(x, 2) if resample == "maxpool" else self.fir(x, self.down_taps, 2)
        x = self.double_conv(x, f"{prefix}.conv_res", mode, residual=True)
        return self.emb(self.double_conv(x, f"{prefix}.conv_out", mode), t_emb, prefix)

    def up(self, x, skip, t_emb, prefix, resample, mode):
        x = self.bilinear_up(x) if resample == "bilinear" else self.up_fir(x)
        x = torch.cat([skip, x], dim=1)
        x = self.double_conv(x, f"{prefix}.conv_res", mode, residual=True)
        return self.emb(self.double_conv(x, f"{prefix}.conv_out", mode), t_emb, prefix)


class _CountedAttention(torch.autograd.Function):
    """softmax(q·kᵀ·scale)·v whose backward recomputes the scores: two
    products forward, five backward (for the FLOP count)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return torch.matmul(torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, -1), v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * ctx.scale, -1)
        dv = torch.matmul(p.transpose(-1, -2), g)
        dp = torch.matmul(g, v.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * ctx.scale
        return torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), dv, None


def forward(p: dict, m: Model, x: torch.Tensor, t: torch.Tensor, prec=F32,
            count_attention: bool = False) -> torch.Tensor:
    """eps(x_t, t): ``x`` NHWC, ``t`` integer timesteps (B,); float32 out."""
    ops = _Ops(p, m, prec, x.device, count_attention)
    down_rs, up_rs, stage, trunk = VARIANTS[m.variant]
    table = torch.from_numpy(_time_table_np(m.table_size, m.time_dim)).to(x.device)
    t_emb = table[t.long().clamp(0, m.table_size - 1)].to(x.dtype)
    x1 = ops.double_conv(x.permute(0, 3, 1, 2), "inc", trunk)
    x2 = ops.self_attention(ops.down(x1, t_emb, "down1", down_rs, stage), "sa1")
    x3 = ops.self_attention(ops.down(x2, t_emb, "down2", down_rs, stage), "sa2")
    x4 = ops.self_attention(ops.down(x3, t_emb, "down3", down_rs, stage), "sa3")
    for name in ("bot1", "bot2", "bot3"):
        x4 = ops.double_conv(x4, name, trunk)
    h = ops.self_attention(ops.up(x4, x3, t_emb, "up1", up_rs, stage), "sa4")
    h = ops.self_attention(ops.up(h, x2, t_emb, "up2", up_rs, stage), "sa5")
    h = ops.self_attention(ops.up(h, x1, t_emb, "up3", up_rs, stage), "sa6")
    out = ops.conv(h, p["outc.weight"], bias=p["outc.bias"])
    return out.permute(0, 2, 3, 1).float()


def attention_shapes(m: Model, batch: int) -> list[tuple[str, int, int, int]]:
    """(block, B·H, S, D) of the six attention cores at ``batch``."""
    s, px = m.width, m.image_size
    blocks = (("sa1", 2, 2 * s), ("sa2", 4, 4 * s), ("sa3", 8, 4 * s), ("sa4", 4, 2 * s),
              ("sa5", 2, s), ("sa6", 1, s))
    return [(name, batch * HEADS, (px // r) ** 2, c // HEADS) for name, r, c in blocks]


def filtered_gelu_shapes(m: Model, batch: int) -> dict[tuple, int]:
    """{(N, C, H, W): calls} of the filtered GELU in one forward at ``batch``
    (none without filtered convs): taken from a forward on the meta device."""
    if VARIANTS[m.variant][2] != "filtered":
        return {}
    shapes: dict = {}
    p = {k: torch.empty(v, device="meta") for k, v in param_shapes(m).items()}

    class Spy(_Ops):
        def filtered_gelu(self, x):
            shapes[tuple(x.shape)] = shapes.get(tuple(x.shape), 0) + 1
            return x

        def fir(self, x, taps, stride):
            return x[:, :, ::stride, ::stride]

        def up_fir(self, x):
            return x.repeat_interleave(2, 2).repeat_interleave(2, 3)

    ops = Spy(p, m, F32, "meta", False)
    ops.up_taps = ops.down_taps = torch.empty(3, 3, device="meta")
    down_rs, up_rs, stage, trunk = VARIANTS[m.variant]
    x = torch.empty(batch, m.channels, m.image_size, m.image_size, device="meta")
    t_emb = torch.empty(batch, m.time_dim, device="meta")
    x1 = ops.double_conv(x, "inc", trunk)
    x2 = ops.down(x1, t_emb, "down1", down_rs, stage)
    x3 = ops.down(x2, t_emb, "down2", down_rs, stage)
    x4 = ops.down(x3, t_emb, "down3", down_rs, stage)
    for name in ("bot1", "bot2", "bot3"):
        x4 = ops.double_conv(x4, name, trunk)
    h = ops.up(x4, x3, t_emb, "up1", up_rs, stage)
    h = ops.up(h, x2, t_emb, "up2", up_rs, stage)
    ops.up(h, x1, t_emb, "up3", up_rs, stage)
    return shapes
