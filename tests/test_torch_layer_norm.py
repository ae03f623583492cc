"""The attention block's LayerNorm: ``TokenLayerNorm``, its dispatch, the
kernel pair ``csrc/layer_norm.cu``, the formulas it computes and the plan the
wrappers hand it.

``SelfAttention.ln`` reads the block's NCHW map in place (the tokens view
``x.flatten(2).transpose(1, 2)``, "channel-major") and ``ff_ln`` the residual
sum in row order; both are ``TokenLayerNorm``. On the CPU they are
``F.layer_norm``; on a CUDA tensor the kernel pair, tied by an autograd
Function. The CPU tests hold the parameter names, the CPU path against
``nn.LayerNorm``, the kernels' formulas written here with PyTorch operations
(tied as an autograd Function: float64 gradcheck; against float64 autograd),
the plan at every channel count the port builds,
a numpy walk of each warp's maps over its tile, the source's constants and
names, and the calls a forward makes (a spy on the UNet on the meta device).
The tests marked ``cuda`` need an NVIDIA GPU and ``nvcc`` and skip without a
device; the file imports neither JAX nor the JAX package, so on a machine
with only PyTorch run

    python -m pytest --noconftest tests/test_torch_layer_norm.py -q

Bounds on the card, stated before any card run. The kernels sum each row's
moments in two passes where PyTorch's kernels use Welford's updates, and sum
dw and db in another order, so results differ from PyTorch's in the f32
roundings before the last; each bound is one unit in the last place of the
reference (bf16), or none (f32), plus a floor for the values that cancel,
a share of the magnitude of the terms they are formed from:

* y: |w|·m + |b|, with m = (1/σ)·(|x| + |mean|), the scale of x̂'s rounding;
* dx: (1/σ)·(|g| + (m·Σ|g|·m + Σ|g|)/C), g = w·dy;
* dw: Σ|dy|·m over the rows; db: Σ|dy|.

bf16 is held against ``nn.LayerNorm`` (the transposed map copied into row
order first) with the floor at 2^-16 of those magnitudes; f32 against the
float64 computation from the same inputs with the floor at 2^-18 (y, dx) and
2^-20 (dw, db).
"""

import math
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from aliasfree_diffusion_models_pytorch_tpu_torch.ops import layer_norm as ln
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels

EPS = 1e-5
# (C, S) of the six attention blocks of the 32-px UNet (base width 32), sa1..sa6
SHAPES_32PX = [(64, 256), (128, 64), (128, 16), (64, 64), (32, 256), (32, 1024)]
FLOORS = {torch.bfloat16: (2.0**-16, 2.0**-16), torch.float32: (2.0**-18, 2.0**-20)}


def _tokens(n, c, s, layout, dtype, seed, device="cpu"):
    """(n, S, C) tokens: the transposed view of an (n, C, S) map
    ("channels") or a contiguous tensor ("rows"), values with a per-channel
    offset and scale."""
    gen = torch.Generator().manual_seed(seed)
    base = torch.randn((n, c, s), generator=gen) * (0.5 + torch.rand((1, c, 1), generator=gen))
    base = base + torch.randn((1, c, 1), generator=gen)
    x = base.to(dtype).to(device).transpose(1, 2)
    return x.contiguous() if layout == "rows" else x


def _params(c, dtype, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    w = (1 + 0.5 * torch.randn(c, generator=gen)).to(dtype).to(device)
    b = (0.5 * torch.randn(c, generator=gen)).to(dtype).to(device)
    return w, b


def _reference(x, w, b, dy):
    """nn.LayerNorm's path: y and (dx, dw, db) by autograd through
    F.layer_norm on the tokens in row order."""
    xg = x.detach().contiguous().requires_grad_()
    wg, bg = w.detach().clone().requires_grad_(), b.detach().clone().requires_grad_()
    y = F.layer_norm(xg, (x.shape[-1],), wg, bg, EPS)
    return (y.detach(), *torch.autograd.grad(y, (xg, wg, bg), dy))


def _plain_fwd(x, w, b, eps):
    """The forward kernel's steps over the last dimension: mean, then the mean
    square deviation from it (two passes, in f32; f64 for an f64 input), 1/σ =
    rsqrt(var + eps), y = w·((x − mean)·(1/σ)) + b rounded once to x's dtype.
    Returns (y, mean, rstd), the last two over x's leading dimensions."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(acc)
    mean = xf.mean(-1)
    xc = xf - mean[..., None]
    rstd = torch.rsqrt((xc * xc).mean(-1) + eps)
    return (w.to(acc) * (xc * rstd[..., None]) + b.to(acc)).to(x.dtype), mean, rstd


def _plain_bwd(x, dy, w, mean, rstd):
    """The backward kernel's formulas: with x̂ = (x − mean)·(1/σ) and g = w·dy,
    dx = (C·g − x̂·Σg·x̂ − Σg)·(1/σ)/C over each row, dw = Σ dy·x̂ and db = Σ dy
    over the rows; each rounded once to its input's dtype."""
    acc = mean.dtype
    xh = (x.to(acc) - mean[..., None]) * rstd[..., None]
    dyf = dy.to(acc)
    g = w.to(acc) * dyf
    c = x.shape[-1]
    dx = (c * g - xh * (g * xh).sum(-1, keepdim=True) - g.sum(-1, keepdim=True)) * (
        rstd[..., None] / c)
    dw, db = (dyf * xh).reshape(-1, c).sum(0), dyf.reshape(-1, c).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype), db.to(w.dtype)


class _PlainLayerNorm(torch.autograd.Function):
    """The kernels' formulas tied as the kernel pair is (``_LayerNorm``): the
    forward saves x, the weight and each row's mean and 1/σ."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        y, mean, rstd = _plain_fwd(x, w, b, eps)
        ctx.save_for_backward(x, w, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, mean, rstd = ctx.saved_tensors
        return (*_plain_bwd(x, dy, w, mean, rstd), None)


# ---- the module and the CPU path ----

def test_modules_keep_their_names_and_type():
    from aliasfree_diffusion_models_pytorch_tpu_torch.models.blocks import SelfAttention

    block = SelfAttention(64)
    assert [k for k in block.state_dict() if "ln" in k] == [
        "ln.weight", "ln.bias", "ff_ln.weight", "ff_ln.bias"]
    for m in (block.ln, block.ff_ln):
        assert isinstance(m, ln.TokenLayerNorm) and isinstance(m, nn.LayerNorm)
        assert m.eps == EPS and m.normalized_shape == (64,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["channels", "rows"])
def test_cpu_path_is_nn_layer_norm_bit_for_bit(layout, dtype):
    """On the CPU a TokenLayerNorm is F.layer_norm: the same output and the
    same gradients of x, weight and bias as nn.LayerNorm, in either layout,
    and no launch."""
    torch.manual_seed(0)
    mine, ref = ln.TokenLayerNorm(32, eps=EPS).to(dtype), nn.LayerNorm(32, eps=EPS).to(dtype)
    with torch.no_grad():
        for m in (mine, ref):
            m.weight.copy_(_params(32, dtype, 1)[0])
            m.bias.copy_(_params(32, dtype, 1)[1])
    x = _tokens(2, 32, 20, layout, dtype, seed=2)
    dy = torch.randn(x.shape).to(dtype)
    before = (ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches)
    out = []
    for m in (mine, ref):
        xg = x.detach().clone().requires_grad_()
        y = m(xg)
        out.append((y, *torch.autograd.grad(y, (xg, m.weight, m.bias), dy)))
    assert all(torch.equal(a, b) for a, b in zip(*out))
    assert (ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches) == before


@pytest.mark.parametrize("layout", ["channels", "rows"])
def test_function_plain_path_passes_float64_gradcheck(layout):
    """The kernels' forward and backward formulas, tied as the kernel pair's
    autograd Function ties them: float64 gradcheck holds them to finite
    differences, x, weight and bias."""
    x = _tokens(2, 8, 6, layout, torch.float64, seed=3).requires_grad_()
    w, b = (t.requires_grad_() for t in _params(8, torch.float64, 4))
    assert torch.autograd.gradcheck(lambda x, w, b: _PlainLayerNorm.apply(x, w, b, EPS), (x, w, b))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16],
                         ids=["f64", "f32", "bf16"])
def test_plain_versions_against_float64_autograd(dtype):
    """The kernels' formulas against autograd through F.layer_norm in float64
    on the same inputs: float64 to 1e-12; f32 and bf16 (computed in f32, as
    the kernels do) within the bounds of the module docstring, against the
    float64 results rounded to their type."""
    x = _tokens(3, 32, 40, "rows", dtype, seed=5)
    w, b = _params(32, dtype, 6)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(7)).to(dtype)
    y, mean, rstd = _plain_fwd(x, w, b, EPS)
    got = (y, *_plain_bwd(x, dy, w, mean, rstd))
    ref = tuple(t.to(dtype) for t in _reference(x.double(), w.double(), b.double(), dy.double()))
    if dtype == torch.float64:
        assert all(torch.allclose(a, r, rtol=0, atol=1e-12) for a, r in zip(got, ref))
        return
    for name, a, r, sc in zip(("y", "dx", "dw", "db"), got, ref, _scales(x, w, b, dy)):
        assert _within(a, r, sc, dtype, name), name


def test_layer_norm_tokens_off_the_card_is_f_layer_norm():
    """A CPU tensor, and a meta tensor (the shape spies of the tests and of
    chip_smoke), take F.layer_norm: no launch."""
    x = _tokens(2, 16, 5, "channels", torch.float32, seed=8)
    w, b = _params(16, torch.float32, 9)
    before = (ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches)
    assert torch.equal(ln.layer_norm_tokens(x, w, b, EPS), F.layer_norm(x, (16,), w, b, EPS))
    on_meta = ln.layer_norm_tokens(x.to("meta"), w.to("meta"), b.to("meta"), EPS)
    assert on_meta.shape == x.shape and on_meta.device.type == "meta"
    assert (ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches) == before


def test_token_layout():
    t = torch.zeros(2, 3, 5)  # (n, C, S)
    assert ln.token_layout(t.transpose(1, 2)) == "channels"
    assert ln.token_layout(t.transpose(1, 2).contiguous()) == "rows"
    assert ln.token_layout(t.transpose(1, 2)[:, ::2]) is None
    assert ln.token_layout(torch.zeros(2, 1, 5)) == "rows"  # one token: both; row order
    with pytest.raises(ValueError, match=r"\(n, S, C\)"):
        ln.token_layout(torch.zeros(2, 3))


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_wrappers_refuse_other_devices(device):
    """The kernels' wrappers take CUDA tensors alone; off the card
    layer_norm_tokens calls F.layer_norm and never reaches them."""
    x = torch.zeros(1, 8, 64, dtype=torch.bfloat16, device=device)
    w = torch.zeros(64, dtype=torch.bfloat16, device=device)
    m = torch.zeros(8, device=device)
    with pytest.raises(ValueError, match="runs on cuda"):
        ln.layer_norm_fwd(x, w, w, EPS)
    with pytest.raises(ValueError, match="runs on cuda"):
        ln.layer_norm_bwd(x, x, w, m, m)


# ---- the plan ----

def _rows_per_pass(plan):
    return 32 // plan.lpr


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_plan_of_every_channel_count_it_takes(dtype):
    """Every multiple of 8 (bf16) or 4 (f32) up to 512 has a plan the
    kernels take: the fewest lanes a row (a power of two) that hold it with
    an instantiated words-a-lane, a tile of whole 16-byte words along S and
    at most 64 tokens, shared memory within a block's 227 KB; the other
    multiples of 4 raise."""
    vec = 8 if dtype == torch.bfloat16 else 4
    for channels in range(4, ln.LN_MAX_CHANNELS + 1, 4):
        if channels % vec:
            with pytest.raises(ValueError, match="multiple of"):
                ln.ln_plan(channels, dtype)
            continue
        p = ln.ln_plan(channels, dtype)
        assert (p.vec, p.chunks) == (vec, channels // vec)
        assert p.lpr & (p.lpr - 1) == 0 and 1 <= p.lpr <= 32
        assert p.lpr >= min(p.chunks, 32) and (p.lpr == 1 or p.lpr // 2 < p.chunks)
        assert p.cpl == min(c for c in ln.LN_CPL[dtype] if c * p.lpr >= p.chunks)
        assert p.tw % vec == 0 and vec <= p.tw <= ln.LN_MAX_TW
        assert p.tile_bytes == p.tw * channels * 16 // vec <= 8192
        assert p.tw == ln.LN_MAX_TW or p.tile_bytes + 16 * channels > 4096
        assert p.smem_bwd <= 232448 and p.smem_fwd == ln.LN_WARPS * p.tile_bytes


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_every_width_the_cards_attention_takes_has_a_plan(dtype):
    """A SelfAttention runs on the card only where its heads' depth is one the
    attention kernels take (4 heads of ops/flash_attention.py:HEAD_DIMS), and
    each such C has a LayerNorm plan at every row count: the kernels refuse
    no width that ran before them."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.models.blocks import SelfAttention
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops.flash_attention import HEAD_DIMS

    heads = SelfAttention(64).num_heads
    for channels in (heads * d for d in HEAD_DIMS):
        ln.ln_plan(channels, dtype)
        for rows in (1, 16, 4096, 262144):
            for backward, channel_major in ((False, False), (True, False), (True, True)):
                ln.ln_plan(channels, dtype, tw=ln.tile_tokens(channels, dtype, rows, backward,
                                                              channel_major))


def test_plan_takes_smaller_tiles():
    """A tile of fewer tokens (a multiple of 16 bytes along S) is a plan too;
    a larger one than the instantiation's shared memory takes is refused."""
    p = ln.ln_plan(64, torch.bfloat16, tw=8)
    assert (p.tw, p.tile_bytes, p.swz_stride) == (8, 1024, 4)
    assert ln.ln_plan(64, torch.bfloat16) == ln.ln_plan(64, torch.bfloat16, tw=32)
    for tw in (4, 12, 64, 72):
        with pytest.raises(ValueError, match="a tile of"):
            ln.ln_plan(64, torch.bfloat16, tw=tw)


# (C, rows) of the step's calls at batch 256 and the sampler's at n=200 and n=16,
# and the tokens of the tile each takes: forward, backward in row order,
# backward channel-major.
TILES = [((64, 65536), (32, 32, 32)), ((128, 16384), (8, 8, 16)), ((128, 4096), (8, 8, 16)),
         ((64, 16384), (8, 8, 16)), ((32, 65536), (32, 32, 32)), ((32, 262144), (64, 32, 32)),
         ((64, 51200), (32, 32, 32)), ((32, 204800), (64, 32, 32)), ((64, 4096), (8, 8, 16)),
         ((32, 16384), (8, 8, 16))]


@pytest.mark.parametrize("channels,rows,tiles", [(c, r, t) for (c, r), t in TILES])
def test_tile_tokens_at_the_port_shapes(channels, rows, tiles):
    """bf16: the largest tile that leaves a call 1536 tiles, 32 tokens at most
    backward, two words along S at least for a channel-major backward."""
    got = (ln.tile_tokens(channels, torch.bfloat16, rows),
           ln.tile_tokens(channels, torch.bfloat16, rows, backward=True),
           ln.tile_tokens(channels, torch.bfloat16, rows, backward=True, channel_major=True))
    assert got == tiles
    for tw in got:
        ln.ln_plan(channels, torch.bfloat16, tw=tw)  # a plan the kernels take


@pytest.mark.parametrize("channels,dtype", [(12, torch.bfloat16), (0, torch.float32),
                                            (520, torch.float32), (1024, torch.bfloat16),
                                            (64, torch.float16), (64, torch.float64)])
def test_plan_refuses_what_the_kernels_do_not_take(channels, dtype):
    with pytest.raises((ValueError, TypeError)):
        ln.ln_plan(channels, dtype)


def _word_at(p, r, j):
    """The tile's 16-byte word that holds word j of row r (csrc/layer_norm.cu:word_at)."""
    return r * p.chunks + (j ^ ((r // p.vec * p.swz_stride) & p.swz_mask))


def _element_at(p, r, c):
    """The tile's element (in units of the type) that holds (row r, channel c)."""
    return _word_at(p, r, c // p.vec) * p.vec + c % p.vec


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("channels", [8, 24, 32, 64, 96, 128, 256, 512])
def test_warp_maps_cover_the_tile_once(channels, dtype):
    """A numpy walk of a warp over its tile, as the kernels index it: the
    word permutation keeps every word inside its row and is one to one; the
    row passes (lane -> row rl + r0, words jl + lpr·i) visit every word of
    every valid row once and nothing else, full tile or ragged last tile;
    the channel-major walk along S (item i -> channel i // W, word i % W of
    the tile's W words along S) reads each (token, channel) once and fills
    each element of the tile once; the dw, db reduction's cross-row shuffles
    (xor lpr .. 16) join exactly the lanes that hold the same words."""
    p = ln.ln_plan(channels, dtype)
    rows_all = np.arange(p.tw)[:, None]
    words = _word_at(p, rows_all, np.arange(p.chunks)[None, :])
    assert (np.sort(words, axis=1) == rows_all * p.chunks + np.arange(p.chunks)).all()
    lanes = np.arange(32)
    jl, rl = lanes & (p.lpr - 1), lanes // p.lpr
    for rows in sorted({p.tw, p.tw - 1, p.vec, 1}):
        seen = np.zeros((p.tw, p.chunks), dtype=int)
        for r0 in range(0, rows, _rows_per_pass(p)):
            for i in range(p.cpl):
                r, j = r0 + rl, jl + p.lpr * i
                ok = (r < rows) & (j < p.chunks)
                np.add.at(seen, (r[ok], j[ok]), 1)
        assert (seen[:rows] == 1).all() and (seen[rows:] == 0).all()
        if rows % p.vec:
            continue
        w = rows // p.vec
        items = np.arange(channels * w)
        c, r0 = items // w, items % w * p.vec
        reads = np.zeros((channels, rows), dtype=int)
        filled = np.zeros(p.tw * channels, dtype=int)
        for k in range(p.vec):
            np.add.at(reads, (c, r0 + k), 1)
            np.add.at(filled, _element_at(p, r0 + k, c), 1)
        assert (reads == 1).all() and (filled[:rows * channels] == 1).all()
    assert _xor_closure(p.lpr) == {int(lane) for lane in lanes if jl[lane] == 0}


def _xor_closure(lpr):
    """The lanes reachable from lane 0 by the xor shuffles lpr, 2·lpr .. 16."""
    reach = {0}
    off = lpr
    while off < 32:
        reach |= {r ^ off for r in reach}
        off <<= 1
    return reach


def _ways(byte_addresses, width):
    """Bank conflicts of one warp's shared-memory access of `width` bytes a
    lane: the most distinct 4-byte words any bank serves in one pass (a pass
    is the whole warp for 4 bytes or less, a half for 8, a quarter for 16)."""
    lanes = 32 * 4 // max(width, 4)
    worst = 0
    for start in range(0, len(byte_addresses), lanes):
        part = np.asarray(byte_addresses[start:start + lanes])
        words = np.unique(np.concatenate([part // 4 + k for k in range(max(width, 4) // 4)]))
        worst = max(worst, np.bincount(words % 32).max())
    return worst


# The most ways the channel-major moves may take: none but at 32 bf16 channels,
# whose 16 words a row leave two rows' words on each bank.
CM_WAYS = {(torch.bfloat16, 32): 2}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("channels", [32, 64, 128, 256])
def test_shared_memory_banks(channels, dtype):
    """The tile's accesses, lane by lane, as the kernels make them: the row
    passes' 16-byte reads and writes and the row-order spans' copies meet in
    no bank; the channel-major walk's element writes (load) and reads (store)
    meet in none but at 32 bf16 channels (two ways)."""
    p = ln.ln_plan(channels, dtype)
    size = 16 // p.vec
    lanes = np.arange(32)
    jl, rl = lanes & (p.lpr - 1), lanes // p.lpr
    for r0 in range(0, p.tw, _rows_per_pass(p)):
        for i in range(p.cpl):
            r, j = r0 + rl, jl + p.lpr * i
            ok = (r < p.tw) & (j < p.chunks)
            assert _ways(16 * _word_at(p, r[ok], j[ok]), 16) == 1
    span = np.arange(p.tw * p.chunks)
    for base in range(0, len(span), 32):
        m = span[base:base + 32]
        assert _ways(16 * _word_at(p, m // p.chunks, m % p.chunks), 16) == 1
    w = p.tw // p.vec
    items = np.arange(channels * w)
    worst = 0
    for base in range(0, len(items), 32):
        i = items[base:base + 32]
        for k in range(p.vec):
            worst = max(worst, _ways(size * _element_at(p, i % w * p.vec + k, i // w), size))
    assert worst == CM_WAYS.get((dtype, channels), 1)


# ---- the source ----

def _source():
    return (kernels.CSRC / kernels.SOURCES["layer_norm"]).read_text()


def test_source_is_registered_and_its_constants_are_the_plans():
    assert kernels.SOURCES["layer_norm"] == "layer_norm.cu"
    src = _source()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kWarps"]) == ln.LN_WARPS
    assert int(consts["kMaxTileTokens"]) == ln.LN_MAX_TW
    cases = re.findall(r"case (\d+): err = launch<(bf16|float), (\d+)>", src)
    assert {(int(a), t) for a, t, b in cases if a == b} == {
        (c, "bf16" if d == torch.bfloat16 else "float") for d, cpls in ln.LN_CPL.items()
        for c in cpls}
    assert all(a == b for a, _, b in cases)
    assert "atomicAdd" not in src  # the gradients' sums are in a fixed order


def test_kernel_names_are_their_own():
    """The benchmark's trace readers find kernels by substring: the pair's
    names hold none of PyTorch's LayerNorm kernels' (``layer_norm``,
    ``GammaBeta``), nor ``flash_`` or ``filtered_gelu``."""
    names = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(", _source())
    assert names == ["ln_fwd_kernel", "ln_bwd_kernel", "ln_dparams_kernel"]
    for n in names:
        assert not any(p in n for p in ("layer_norm", "GammaBeta", "flash_", "filtered_gelu"))


# ---- the calls a forward makes ----

def _ln_calls(variant, batch=2):
    """[(shape, layout)] of the TokenLayerNorm calls in one forward of the
    bf16 32-px UNet (forward hooks on the model on the meta device; attention
    and the filtered GELU stubbed)."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
    from aliasfree_diffusion_models_pytorch_tpu_torch.models import blocks, unet

    config = TrainConfig(image_size=32, image_channels=3, variant=variant, batch_size=batch,
                         compute_dtype="bfloat16",
                         filters=FilterSettings() if variant == 3 else None)
    with torch.device("meta"):
        model = unet.build_model(config, device="meta")
    calls = []
    for m in model.modules():
        if isinstance(m, ln.TokenLayerNorm):
            m.register_forward_hook(lambda mod, inp, out: calls.append(
                (tuple(inp[0].shape), ln.token_layout(inp[0]))))
    real = blocks.filtered_gelu, blocks.flash_mha
    blocks.filtered_gelu = lambda x, *a, **k: x
    blocks.flash_mha = lambda q, k, v, scale: torch.empty_like(q)
    try:
        with torch.no_grad():
            model(torch.zeros((batch, 32, 32, 3), device="meta"),
                  torch.ones((batch,), dtype=torch.long, device="meta"))
    finally:
        blocks.filtered_gelu, blocks.flash_mha = real
    return calls


@pytest.mark.parametrize("variant", [0, 3], ids=["config_A", "config_D"])
def test_layer_norm_calls_of_a_forward(variant):
    """Twelve calls a forward, in both configurations: each block's ``ln``
    on its map channel-major, then its ``ff_ln`` in row order; 71,680
    elements an image each way, 143,360 in all (36.7 M at batch 256)."""
    calls = _ln_calls(variant)
    assert [layout for _, layout in calls] == ["channels", "rows"] * 6
    assert [(shape[2], shape[1]) for shape, _ in calls[::2]] == SHAPES_32PX
    assert [shape for shape, _ in calls[::2]] == [shape for shape, _ in calls[1::2]]
    assert sum(math.prod(shape) for shape, _ in calls) // 2 == 143_360


# ---- bounds ----

def _scales(x, w, b, dy):
    """The magnitudes the module docstring's floors are shares of: (y, dx,
    dw, db), in float64 from the inputs, with m = (1/σ)·(|x| + |mean|) in
    place of |x̂| (a rounding of the mean moves x̂ by a share of that)."""
    xd, wd, bd, dyd = (t.double() for t in (x, w, b, dy))
    mean = xd.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xd - mean) ** 2).mean(-1, keepdim=True) + EPS)
    m = rstd * (xd.abs() + mean.abs())
    g = (wd * dyd).abs()
    c = x.shape[-1]
    dx = rstd * (g + (m * (g * m).sum(-1, keepdim=True) + g.sum(-1, keepdim=True)) / c)
    flat = lambda t: t.reshape(-1, c)  # noqa: E731
    return wd.abs() * m + bd.abs(), dx, flat(dyd.abs() * m).sum(0), flat(dyd.abs()).sum(0)


def _ulp_bf16(v):
    """The spacing of bf16 values at |v| (0 at 0)."""
    a = v.double().abs()
    return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a.clamp_min(1e-38))) - 7), 0.0)


def _within(got, ref, scale, dtype, name):
    floor = FLOORS[dtype][name in ("dw", "db")]
    err = (got.double() - ref.double()).abs()
    allowed = floor * scale.double() + (_ulp_bf16(ref) if dtype == torch.bfloat16 else 0.0)
    return bool((err <= allowed).all())


# ---- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels in csrc/ have no CPU mode")
    return torch.device("cuda")


def _launches():
    return ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches


def _kernel_pair(x, w, b, dy):
    """(y, dx, dw, db) through the autograd Function on the card."""
    xg = x.detach().clone().requires_grad_()
    wg, bg = w.detach().clone().requires_grad_(), b.detach().clone().requires_grad_()
    y = ln.layer_norm_tokens(xg, wg, bg, EPS)
    return (y.detach(), *torch.autograd.grad(y, (xg, wg, bg), dy))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("layout", ["channels", "rows"])
@pytest.mark.parametrize("n", [16, 200, 256])
@pytest.mark.parametrize("c,s", SHAPES_32PX, ids=[f"c{c}_s{s}" for c, s in SHAPES_32PX])
def test_kernels_at_the_blocks_shapes(card, c, s, n, layout, dtype):
    """At the six blocks' shapes, batch 16, 200 and 256, both layouts and
    both types: one launch each way, y in row order, dx laid out as x, and
    y, dx, dw, db within the module docstring's bounds (bf16 against
    nn.LayerNorm, f32 against float64)."""
    seed = c * 7 + s + n
    x = _tokens(n, c, s, layout, dtype, seed, card)
    w, b = _params(c, dtype, seed + 1, card)
    gen = torch.Generator().manual_seed(seed + 2)
    dy = torch.randn((n, s, c), generator=gen).to(dtype).to(card)
    before = _launches()
    got = _kernel_pair(x, w, b, dy)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1, before[1] + 1)
    assert got[0].is_contiguous() and got[1].stride() == x.stride()
    if dtype == torch.bfloat16:
        ref = _reference(x, w, b, dy)
    else:
        xd, wd, bd = x.double(), w.double(), b.double()
        ref = tuple(t.float() for t in _reference(xd, wd, bd, dy.double()))
    scales = _scales(x, w, b, dy)
    for name, a, r, sc in zip(("y", "dx", "dw", "db"), got, ref, scales):
        assert _within(a, r, sc, dtype, name), (name, (a.double() - r.double()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["channels", "rows"])
def test_two_runs_are_bit_equal(card, layout):
    x = _tokens(256, 32, 1024, layout, torch.bfloat16, 11, card)
    w, b = _params(32, torch.bfloat16, 12, card)
    dy = torch.randn((256, 1024, 32), device=card).bfloat16()
    first, second = _kernel_pair(x, w, b, dy), _kernel_pair(x, w, b, dy)
    assert all(torch.equal(a, c) for a, c in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("c,s,n", [(64, 4, 3), (32, 9, 5), (128, 12, 2), (256, 5, 1),
                                   (512, 64, 4), (8, 1024, 2), (96, 30, 3)])
def test_ragged_sizes_and_other_channel_counts(card, c, s, n, dtype):
    """S that is not a multiple of 16 bytes of tokens (channel-major read one
    token at a time), tiles cut short, 8 and 96 channels, 512 (128-px base
    width 128): the same bounds, both layouts."""
    vec = 8 if dtype == torch.bfloat16 else 4
    if c % vec:
        pytest.skip(f"{c} channels are not a whole number of 16-byte words in {dtype}")
    for layout in ("channels", "rows"):
        x = _tokens(n, c, s, layout, dtype, c + s, card)
        w, b = _params(c, dtype, c, card)
        dy = torch.randn((n, s, c), device=card).to(dtype)
        got = _kernel_pair(x, w, b, dy)
        if dtype == torch.bfloat16:
            ref = _reference(x, w, b, dy)
        else:
            ref = tuple(t.float() for t in _reference(x.double(), w.double(), b.double(),
                                                      dy.double()))
        for name, a, r, sc in zip(("y", "dx", "dw", "db"), got, ref, _scales(x, w, b, dy)):
            assert _within(a, r, sc, dtype, name), (layout, name)


@pytest.mark.cuda
def test_misaligned_inputs_are_copied_not_refused(card):
    store = torch.randn(2 * 64 * 64 + 1, device=card).bfloat16()
    x = store[1:].view(2, 64, 64).transpose(1, 2)  # a map starting 2 bytes off a boundary
    w, b = _params(64, torch.bfloat16, 13, card)
    dy = torch.randn((2, 64, 64), device=card).bfloat16()
    got, ref = _kernel_pair(x, w, b, dy), _reference(x, w, b, dy)
    for name, a, r, sc in zip(("y", "dx", "dw", "db"), got, ref, _scales(x, w, b, dy)):
        assert _within(a, r, sc, torch.bfloat16, name), name


@pytest.mark.cuda
def test_kernels_under_cuda_graph_capture(card):
    x = _tokens(16, 64, 256, "channels", torch.bfloat16, 14, card)
    w, b = _params(64, torch.bfloat16, 15, card)
    dy = torch.randn((16, 256, 64), device=card).bfloat16()

    def run():
        y, mean, rstd = ln.layer_norm_fwd(x, w, b, EPS)
        return (y, *ln.layer_norm_bwd(x, dy, w, mean, rstd))

    run()  # loads the library and readies the instantiation
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            captured = run()
    torch.cuda.current_stream().wait_stream(stream)
    for seed in (16, 17):
        x.copy_(_tokens(16, 64, 256, "channels", torch.bfloat16, seed, card))
        dy.copy_(torch.randn((16, 256, 64), device=card).bfloat16())
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, e) for a, e in zip(captured, run()))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    w12 = torch.ones(12, device=card).bfloat16()
    with pytest.raises(ValueError, match="multiple of 8"):
        ln.layer_norm_fwd(torch.zeros((2, 4, 12), device=card).bfloat16(), w12, w12, EPS)
    w = torch.ones(1024, device=card).bfloat16()
    with pytest.raises(ValueError, match="up to 512"):
        ln.layer_norm_fwd(torch.zeros((1, 8, 1024), device=card).bfloat16(), w, w, EPS)
    w16 = torch.ones(64, device=card).half()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ln.layer_norm_fwd(torch.zeros((1, 8, 64), device=card).half(), w16, w16, EPS)
    x = torch.zeros((2, 8, 64), device=card).bfloat16()
    with pytest.raises(ValueError, match="weight and bias"):
        ln.layer_norm_fwd(x, w16, w16, EPS)
    with pytest.raises(ValueError, match="row order or the transposed view"):
        ln.layer_norm_fwd(x[:, ::2], x[0, 0], x[0, 0], EPS)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [0, 3], ids=["config_A", "config_D"])
def test_launches_of_a_forward_and_an_eager_train_step(card, variant):
    """Twelve forward launches a forward; twelve each way a train step."""
    from aliasfree_diffusion_models_pytorch_tpu_torch import train as train_mod
    from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion

    config = TrainConfig(image_size=32, image_channels=3, variant=variant, batch_size=4,
                         compute_dtype="bfloat16", noise_steps=50,
                         filters=FilterSettings() if variant == 3 else None)
    model, state = train_mod.create_train_state(config, device=card)
    before = _launches()
    with torch.no_grad():
        model(torch.zeros((4, 32, 32, 3), device=card), torch.ones(4, dtype=torch.long,
                                                                   device=card))
    assert _launches() == (before[0] + 12, before[1])
    step = train_mod.make_train_step(model, config, Diffusion(noise_steps=50, img_size=32,
                                                              device=card), graphs=False)
    batch = torch.rand((4, 32, 32, 3), generator=torch.Generator().manual_seed(18)) * 2 - 1
    before = _launches()
    state, loss = step(state, batch.to(card), train_mod.step_generator(
        torch.Generator(device=card), 0, 0))
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert _launches() == (before[0] + 12, before[1] + 12)


@pytest.mark.cuda
def test_launches_of_a_graphed_sampler_call(card):
    """A DDPM call replays one graph a noised step, and the counters add the
    launches it captured at each replay: twelve forward launches in each of
    the STEPS - 1 forwards, no backward."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
    from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import build_model
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import init_params

    steps = 12
    config = TrainConfig(image_size=16, base_width=32, image_channels=3, variant=3,
                         compute_dtype="bfloat16", noise_steps=steps, batch_size=2,
                         filters=FilterSettings())
    model = build_model(config, device=card, state_dict=init_params(config, 0))
    sampler = Diffusion(noise_steps=steps, img_size=16, device=card)
    gen = torch.Generator(device=card).manual_seed(19)
    sampler.sample(model, 2, 3, generator=gen)  # warm-up and capture
    before = _launches()
    sampler.sample(model, 2, 3, generator=gen)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 12 * (steps - 1), before[1])
