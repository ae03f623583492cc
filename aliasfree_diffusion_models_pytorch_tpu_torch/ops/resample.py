"""Alias-free resampling ops, and the CUDA kernel pairs of the filtered and
the plain bf16 GELU.

Port of ``aliasfree_diffusion_models_pytorch_tpu/ops/resample.py``. Layout is
NCHW here (PyTorch's convolution layout); the JAX package's functions take
NHWC. Each op is the same cross-correlation with the same padding as its JAX
counterpart:

* ``depthwise_fir``: SAME depthwise FIR, every channel with the same taps;
* ``downsample2x``: SAME depthwise FIR and decimation as one strided conv;
* ``upsample2x``: zero-stuffing by ``factor`` then a SAME depthwise FIR. The
  JAX version folds the stuffing into ``lhs_dilation``; here the stuffed
  tensor is built with its padding in place and convolved unpadded.
* ``filtered_gelu``: up → GELU → down in one of two forms, chosen as the JAX
  package's ``_fg_auto_impl`` chooses (JAX ``:205-250``): the conv form
  (the three ops above around ``gelu_exact``) for f32, the polyphase form
  (``filtered_gelu_phases``, index plan ``phase_terms``) for bf16, the port's
  counterpart of the JAX bf16 path's ``precision=None``. ``AFDM_FG_IMPL=conv``
  or ``phases`` overrides, as in the JAX package. On the CPU the phases form
  is the plain version; on the card it is the hand-written kernel pair of
  ``csrc/filtered_gelu.cu`` (``filtered_gelu_fwd``, ``filtered_gelu_bwd``,
  tied by a ``torch.autograd.Function``), which keeps every intermediate on
  chip and saves only x for the backward.
* ``gelu_exact``: the GELU. On bf16 it is the JAX package's polynomial
  (``gelu_poly``, the plain version and the CPU's path); on the card the
  kernel pair of ``csrc/plain_gelu.cu`` (``plain_gelu_fwd``,
  ``plain_gelu_bwd``), which share the polynomial with the filtered GELU's
  (``csrc/gelu.cuh``).

Parity trap preserved: the reference's ``custom_upsample`` does **not**
apply the ``factor**2`` gain compensation of StyleGAN3, so ``gain`` defaults
to 1.0 (the trained weights compensate).

``taps`` may be a NumPy array (design-time constant) or a tensor; the modules
hold them as buffers already on the right device and dtype.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.kernels import I64, INT, PTR

__all__ = [
    "same_pad",
    "depthwise_fir",
    "downsample2x",
    "upsample2x",
    "filtered_gelu",
    "fg_impl",
    "fg_impl_override",
    "capture_key",
    "gelu_exact",
    "gelu_mode",
    "gelu_form",
    "gelu_poly",
    "plain_gelu_fwd",
    "plain_gelu_bwd",
    "phase_terms",
    "filtered_gelu_phases",
    "filtered_gelu_fwd",
    "filtered_gelu_bwd",
    "fg_plan",
    "FG_KERNEL_SIZES",
    "maxpool2x",
    "upsample_bilinear_align_corners",
    "resize_matrix_1d",
]


def same_pad(k: int) -> tuple[int, int]:
    """(lo, hi) spatial padding reproducing torch ``F.conv2d(padding='same')``:
    ``(k-1)//2`` low, ``k//2`` high (the extra tap of an even kernel goes high)."""
    return ((k - 1) // 2, k // 2)


def _taps(taps, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(taps, dtype=x.dtype, device=x.device)


def _depthwise(x: torch.Tensor, taps: torch.Tensor, stride: int) -> torch.Tensor:
    """Unpadded depthwise cross-correlation with one shared (kh, kw) filter."""
    c = x.shape[1]
    w = taps[None, None].expand(c, 1, *taps.shape)
    return F.conv2d(x, w, stride=stride, groups=c)


def depthwise_fir(x: torch.Tensor, taps) -> torch.Tensor:
    """SAME depthwise FIR (NCHW): every channel cross-correlated with the same
    2D taps, no decimation."""
    t = _taps(taps, x)
    (hlo, hhi), (wlo, whi) = same_pad(t.shape[0]), same_pad(t.shape[1])
    return _depthwise(F.pad(x, (wlo, whi, hlo, hhi)), t, 1)


def downsample2x(x: torch.Tensor, taps, factor: int = 2) -> torch.Tensor:
    """Alias-free downsample (NCHW): SAME depthwise low-pass FIR, then keep
    every ``factor``-th sample — one strided conv."""
    t = _taps(taps, x)
    (hlo, hhi), (wlo, whi) = same_pad(t.shape[0]), same_pad(t.shape[1])
    return _depthwise(F.pad(x, (wlo, whi, hlo, hhi)), t, factor)


def upsample2x(x: torch.Tensor, taps, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """Alias-free upsample (NCHW): zero-stuff by ``factor``, SAME depthwise FIR.

    ``gain=1.0`` keeps the reference's un-compensated energy.
    """
    t = _taps(taps, x)
    if gain != 1.0:
        t = t * float(gain)
    n, c, h, w = x.shape
    (hlo, hhi), (wlo, whi) = same_pad(t.shape[0]), same_pad(t.shape[1])
    stuffed = x.new_zeros(n, c, hlo + h * factor + hhi, wlo + w * factor + whi)
    stuffed[:, :, hlo:hlo + h * factor:factor, wlo:wlo + w * factor:factor] = x
    return _depthwise(stuffed, t, 1)


# Minimax polynomials for gelu(x) = x·(0.5 + x_c·R(x_c²)), x_c = clip(x, ±XC):
# the JAX package's bf16 fits, copied coefficient for coefficient (JAX
# ``ops/resample.py:311-315``): degree 15 by default (max |gelu err| 3.7e-4,
# an order below bf16 rounding), degree 13 under ``AFDM_GELU=poly13``
# (1.4e-3, one Horner step fewer).
_GELU_POLY_15 = (
    0.39847720532397357, -0.06533923798456039, 0.009128171697420397,
    -0.0008978316975850138, 5.914830951568466e-05, -2.454260270985954e-06,
    5.750126543924546e-08, -5.770954416805585e-10,
)
_GELU_POLY_13 = (
    0.39736903338755974, -0.06336353822103462, 0.008126449758425384,
    -0.0006760143548142659, 3.4051160496925107e-05, -9.359854638467884e-07,
    1.0721949130855751e-08,
)
_GELU_CLAMP = 3.2 * float(np.sqrt(2.0))  # |erf(x/√2)| == 1 to f32 beyond


def gelu_mode() -> str | None:
    """The GELU form ``AFDM_GELU`` asks for (``exact`` | ``poly13``), else
    None, as the JAX package reads it. A captured step or sampler keys its
    CUDA graph on it: the form is fixed at capture, as JAX fixes it at trace."""
    env = os.environ.get("AFDM_GELU")
    return env if env in ("exact", "poly13") else None


def gelu_form(dtype: torch.dtype) -> str:
    """What :func:`gelu_exact` computes for ``dtype``: ``"erf"`` on f32 and
    under ``AFDM_GELU=exact``; on bf16 otherwise ``"poly13"`` under
    ``AFDM_GELU=poly13`` and ``"poly15"`` by default."""
    mode = gelu_mode()
    if dtype != torch.bfloat16 or mode == "exact":
        return "erf"
    return "poly13" if mode == "poly13" else "poly15"


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU (torch's ``F.gelu``) with the JAX package's bf16 fast
    path: on bf16 a polynomial evaluated in f32 and rounded once, degree 15 or
    13 (:func:`gelu_form`); ``AFDM_GELU=exact`` forces the erf form, which on
    bf16 torch also computes in f32 and rounds once. The polynomial on a CUDA
    tensor is the kernel pair of ``csrc/plain_gelu.cu`` (:func:`plain_gelu_fwd`,
    :func:`plain_gelu_bwd`, tied by a ``torch.autograd.Function`` that saves
    only x); elsewhere it is :func:`gelu_poly`, with autograd's backward."""
    form = gelu_form(x.dtype)
    if form == "erf":
        return F.gelu(x)
    if x.device.type == "cuda":
        return _PlainGelu.apply(x)
    return gelu_poly(x)


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """The bf16 polynomial GELU of :func:`gelu_form` (``poly15`` or
    ``poly13``) composed of PyTorch operations: x·(0.5 + x_c·R(x_c²)), x_c the
    input clamped to ±3.2·√2, each f32 product and sum rounded in Horner's
    order, the result rounded once to x's dtype. The plain version of the
    kernel pair ``csrc/plain_gelu.cu``, and the CPU's path."""
    form = gelu_form(x.dtype)
    if form == "erf":
        raise ValueError(f"gelu_poly takes the polynomial forms, and {x.dtype} under "
                         f"AFDM_GELU={gelu_mode()} is the erf form")
    coefs = _GELU_POLY_13 if form == "poly13" else _GELU_POLY_15
    xf = x.float()
    xc = xf.clamp(-_GELU_CLAMP, _GELU_CLAMP)
    t = xc * xc
    p = torch.full_like(t, coefs[-1])
    for coef in coefs[-2::-1]:
        p = p * t + coef
    return (xf * (0.5 + xc * p)).to(x.dtype)


# The C entry point (csrc/plain_gelu.cu), each argument before the stream: x, g, y; n; the
# GELU form's index in FG_GELU_FORMS, sms.
_PLAIN_GELU = kernels.Entry("plain_gelu", [PTR] * 3 + [I64, INT, INT])


def _dense(x: torch.Tensor) -> bool:
    """Whether x's elements fill the span of storage they lie in, each once:
    its strides, smallest first, are the running products of its sizes in
    some order of its dimensions (NCHW, channels-last, a transposed view)."""
    expected = 1
    for size, stride in sorted(((n, s) for n, s in zip(x.shape, x.stride()) if n != 1),
                               key=lambda d: d[1]):
        if stride != expected:
            return False
        expected *= size
    return True


def _pg_launch(x: torch.Tensor, g: torch.Tensor | None) -> torch.Tensor:
    """Checks and launches one kernel of the plain GELU pair: the forward
    without ``g``, the backward with it, in the form :func:`gelu_form` gives.
    The result is a new tensor with x's strides; an empty x launches nothing."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the plain GELU kernels take bfloat16, got {x.dtype}")
    form = gelu_form(x.dtype)
    if form == "erf":
        raise ValueError("the plain GELU kernels take the polynomial forms, not erf "
                         "(AFDM_GELU=exact takes F.gelu)")
    if not _dense(x):
        raise ValueError(f"x must be dense and non-overlapping, got shape {tuple(x.shape)} "
                         f"strides {x.stride()}")
    if g is not None and (g.device != x.device or g.dtype != x.dtype or g.shape != x.shape
                          or g.stride() != x.stride()):
        raise ValueError(f"g must be laid out as x: {g.dtype} {tuple(g.shape)} {g.stride()} on "
                         f"{g.device} against {tuple(x.shape)} {x.stride()}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    _PLAIN_GELU(x.device, x, g, y, x.numel(), FG_GELU_FORMS.index(form),
                kernels.sm_count(x.device.index))
    return y


def plain_gelu_fwd(x: torch.Tensor) -> torch.Tensor:
    """The bf16 polynomial GELU's forward kernel on a CUDA tensor that is
    dense and non-overlapping (any order of its dimensions); a CPU tensor
    takes :func:`gelu_poly`. ``launches`` counts the calls that reached the
    card."""
    if not kernels.on_card(x, "plain_gelu_fwd"):
        return gelu_poly(x)
    y = _pg_launch(x, None)
    plain_gelu_fwd.launches += int(x.numel() > 0)
    return y


kernels.count_launches(plain_gelu_fwd)


def plain_gelu_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dx of the bf16 polynomial GELU for the cotangent ``g`` (laid out as
    x): the backward kernel on a CUDA tensor; on a CPU tensor autograd of
    :func:`gelu_poly`. ``launches`` counts the calls that reached the card."""
    if not kernels.on_card(x, "plain_gelu_bwd"):
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            return torch.autograd.grad(gelu_poly(xg), xg, g)[0]
    dx = _pg_launch(x, g)
    plain_gelu_bwd.launches += int(x.numel() > 0)
    return dx


kernels.count_launches(plain_gelu_bwd)


class _PlainGelu(torch.autograd.Function):
    """Forward saves x alone (made dense first if it is not); backward is the
    backward kernel, on the cotangent laid out as x."""

    @staticmethod
    def forward(ctx, x):
        if not _dense(x):
            x = x.contiguous()
        ctx.save_for_backward(x)
        return plain_gelu_fwd(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        if g.stride() != x.stride():
            g = torch.empty_like(x).copy_(g)
        return plain_gelu_bwd(x, g)


def fg_impl_override() -> str | None:
    """The form ``AFDM_FG_IMPL`` asks for (``conv`` | ``phases``), else None.
    A captured step keys its CUDA graph on it: the form is fixed at capture."""
    env = os.environ.get("AFDM_FG_IMPL")
    return env if env in ("conv", "phases") else None


def capture_key() -> tuple:
    """The numerics knobs a captured train step or sampler keys its CUDA
    graphs on (:func:`fg_impl_override`, :func:`gelu_mode`): they are read
    while the graph is captured, so a changed knob needs a graph of its own."""
    return fg_impl_override(), gelu_mode()


def fg_impl(x: torch.Tensor, k: int, factor: int = 2) -> str:
    """The form :func:`filtered_gelu` takes: ``"phases"`` for a bf16 input
    (the JAX bf16 path's ``precision=None``), ``"conv"`` otherwise, so f32
    keeps the conv form its parity tests were built on; ``AFDM_FG_IMPL``
    (``conv`` | ``phases``) overrides. The phases form needs factor 2, an odd
    k and a 4-D input, as in the JAX package (JAX ``:213-248``)."""
    impl = fg_impl_override() or ("phases" if x.dtype == torch.bfloat16 else "conv")
    if impl == "phases" and factor == 2 and k % 2 == 1 and x.dim() == 4:
        return "phases"
    return "conv"


def filtered_gelu(x: torch.Tensor, up_taps, down_taps, factor: int = 2) -> torch.Tensor:
    """Filtered nonlinearity (NCHW): 2x alias-free up → GELU → 2x down, in
    the form :func:`fg_impl` picks. The phases form is
    :func:`filtered_gelu_phases` on a CPU tensor and the kernel pair on a
    CUDA tensor (which raises on what the kernels cannot take)."""
    if fg_impl(x, int(up_taps.shape[0]), factor) == "phases":
        if x.device.type == "cpu":
            return filtered_gelu_phases(x, up_taps, down_taps)
        up, down = (_taps(t, x).contiguous() for t in (up_taps, down_taps))
        return _FilteredGelu.apply(x.contiguous(), up, down)
    x = upsample2x(x, up_taps, factor)
    x = gelu_exact(x)
    return downsample2x(x, down_taps, factor)


def phase_terms(k: int):
    """Static polyphase index plans for factor-2 up and down FIR convs (odd k),
    copied from the JAX package (JAX ``:253-294``).

    ``up[(a, b)]`` lists ``(dy, dx, row_shift, col_shift)`` terms building the
    output-parity-(a, b) plane of the zero-stuffed upsample conv directly from
    the low-res grid; ``down`` lists ``(dy, dx, phase_a, phase_b, row_shift,
    col_shift)`` mapping each decimating-conv tap onto a constant-offset read
    of a phase plane. With p = k//2, cross-correlation and zero 'same'
    padding:

      up-phase  y[2i+a, 2j+b] = Σ_{dy≡p-a (2), dx≡p-b (2)} h[dy,dx] ·
                                  x[i+(a+dy-p)/2, j+(b+dx-p)/2]
      down      z[i, j]       = Σ_{dy,dx} g[dy,dx] · y_phase(a',b')[i+r, j+s]
                with a'=(dy-p) mod 2, r=(dy-p-a')/2 (same for columns).
    """
    p = k // 2
    up = {}
    for a in (0, 1):
        for b in (0, 1):
            terms = []
            for dy in range(k):
                if (a + dy - p) % 2:
                    continue
                for dx in range(k):
                    if (b + dx - p) % 2:
                        continue
                    terms.append((dy, dx, (a + dy - p) // 2, (b + dx - p) // 2))
            up[(a, b)] = terms
    down = []
    for dy in range(k):
        a = (dy - p) % 2
        r = (dy - p - a) // 2
        for dx in range(k):
            b = (dx - p) % 2
            s = (dx - p - b) // 2
            down.append((dy, dx, a, b, r, s))
    return up, down


def filtered_gelu_phases(x: torch.Tensor, up_taps, down_taps) -> torch.Tensor:
    """Polyphase form of :func:`filtered_gelu` (factor 2, odd k, NCHW): the
    JAX package's ``filtered_gelu_phases`` (JAX ``:345-393``), and the plain
    version of the kernel pair.

    The zero-stuffed upsample is evaluated per output-parity phase on the
    original grid (its zero samples never exist), GELU is applied per phase,
    and the decimating down conv reads the phases back at constant offsets.
    Rounding points, those of the conv form: the taps in the input's dtype;
    each phase summed in f32 and rounded to the input dtype (the upsample's
    output); :func:`gelu_exact` (on bf16 the polynomial, or erf: :func:`gelu_form`); the down sum in f32,
    rounded once. In f32 nothing rounds between the steps.
    """
    tu, td = (_taps(t, x).float() for t in (up_taps, down_taps))
    k = tu.shape[0]
    n, c, h, w = x.shape
    m = k // 2 + 1  # covers every |shift| in both plans
    up_plan, down_plan = phase_terms(k)
    xp = F.pad(x.float(), (m, m, m, m))

    def sh(a4, r, s):
        return a4[:, :, m + r:m + r + h, m + s:m + s + w]

    gp = {}
    for (a, b), terms in up_plan.items():
        acc = x.new_zeros((n, c, h, w), dtype=torch.float32)
        for dy, dx, r, s in terms:
            acc = acc + tu[dy, dx] * sh(xp, r, s)
        gp[(a, b)] = F.pad(gelu_exact(acc.to(x.dtype)).float(), (m, m, m, m))
    out = x.new_zeros((n, c, h, w), dtype=torch.float32)
    for dy, dx, a, b, r, s in down_plan:
        out = out + td[dy, dx] * sh(gp[(a, b)], r, s)
    return out.to(x.dtype)


# The kernel pair's instantiations (csrc/filtered_gelu.cu): odd k up to 7, f32
# and bf16, 128 threads a block, each thread a strip of `cols` columns × `rows`
# rows of one plane. Square planes of these sides at k = 3 (every filtered GELU
# of the model) have instantiations of their own, the side a template constant;
# every other shape and k takes the generic one.
FG_KERNEL_SIZES = (1, 3, 5, 7)
FG_THREADS = 128
FG_SIDES = (4, 8, 16, 32, 64, 128)
FG_MAX_ROWS = 16
FG_MIN_ROWS = 2
# Threads a call should have before its strips are made shorter: about what
# an H100 SXM holds at once (132 SMs × 512 threads at the pair's register
# counts, rounded down). A constant, not kernels.sm_count × 512: that would
# change the plans the pair was tuned at.
FG_TARGET_THREADS = 65536
# The kernels' GELU forms, by the index the C interfaces take (csrc/gelu.cuh:
# kGeluPoly15, kGeluPoly13, kGeluErf); the filtered GELU's f32 takes "erf"
# only, the plain GELU's kernels the first two.
FG_GELU_FORMS = ("poly15", "poly13", "erf")


@dataclasses.dataclass(frozen=True)
class FgPlan:
    """Launch plan of the filtered-GELU kernels on (planes, h, w) arrays: the
    instantiation and its geometry."""

    instantiation: str  # "k3_side32", or "k5_generic" and the like
    side: int  # the square-plane instantiation's side; 0 for the generic one
    rows: int  # rows of a thread's strip
    cols: int  # columns of a thread's strip
    strips_x: int  # strips across a plane
    strips_y: int  # strips down a plane
    threads: int
    blocks: int


def fg_plan(planes: int, h: int, w: int, k: int, aligned: bool = True) -> FgPlan:
    """Square planes of a side in ``FG_SIDES`` at k = 3 with 16-byte aligned
    tensors take their own instantiation (strips of min(side, 8) columns, so
    rows are read and written as whole 8- or 16-byte words); any other input
    the generic one (strips of 4 columns, 2 at k >= 5). Strips are up to 16
    rows tall and are halved, down to 2 rows, while the call would have fewer
    than ``FG_TARGET_THREADS`` threads: a tall strip recomputes less of the
    phase row above it, a short one fills the card on a small call."""
    if planes < 1 or h < 1 or w < 1:
        raise ValueError(f"empty filtered-GELU input: planes={planes}, h={h}, w={w}")
    side = h if k == 3 and aligned and h == w and h in FG_SIDES else 0
    cols = min(side, 8) if side else (4 if k <= 3 else 2)
    strips_x = -(-w // cols)
    rows = min(h, FG_MAX_ROWS)
    while rows > FG_MIN_ROWS and planes * strips_x * -(-h // rows) < FG_TARGET_THREADS:
        rows = -(-rows // 2)
    strips_y = -(-h // rows)
    threads = planes * strips_x * strips_y
    name = f"k{k}_side{side}" if side else f"k{k}_generic"
    return FgPlan(instantiation=name, side=side, rows=rows, cols=cols, strips_x=strips_x,
                  strips_y=strips_y, threads=threads, blocks=-(-threads // FG_THREADS))


# The C entry point (csrc/filtered_gelu.cu), each argument before the stream: x, g, up, down,
# y; planes, h, w, k, rows, cols, side, is_bf16, the GELU form's index in FG_GELU_FORMS.
_FILTERED_GELU = kernels.Entry("filtered_gelu", [PTR] * 5 + [INT] * 9)


def _fg_launch(x, g, up, down) -> tuple[torch.Tensor, FgPlan]:
    """Checks and launches one kernel of the pair: the forward without ``g``,
    the backward with it, in the GELU form :func:`gelu_form` gives for x's
    dtype. Returns the new (n, c, h, w) tensor and the plan it launched."""
    if x.dim() != 4:
        raise ValueError(f"expected an (N, C, H, W) tensor, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the filtered-GELU kernels take float32 or bfloat16, got {x.dtype}")
    k = up.shape[0]
    if k not in FG_KERNEL_SIZES or up.shape != (k, k) or down.shape != (k, k):
        raise ValueError(f"taps must be k × k with k in {FG_KERNEL_SIZES}, got "
                         f"{tuple(up.shape)} and {tuple(down.shape)}")
    for name, t in (("x", x), ("g", g), ("up_taps", up), ("down_taps", down)):
        if t is None:
            continue
        if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {x.dtype} tensor on {x.device}, "
                             f"got {t.dtype} on {t.device}")
    if g is not None and g.shape != x.shape:
        raise ValueError(f"g must match x: {tuple(g.shape)} vs {tuple(x.shape)}")
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, g, y) if t is not None)
    plan = fg_plan(n * c, h, w, k, aligned)
    _FILTERED_GELU(x.device, x, g, up, down, y, n * c, h, w, k, plan.rows, plan.cols, plan.side,
                   int(x.dtype == torch.bfloat16), FG_GELU_FORMS.index(gelu_form(x.dtype)))
    return y, plan


def filtered_gelu_fwd(x: torch.Tensor, up_taps, down_taps) -> torch.Tensor:
    """The filtered GELU's forward kernel on an (N, C, H, W) CUDA tensor (f32
    or bf16; taps k × k in x's dtype and device, k odd up to 7); a CPU tensor
    takes :func:`filtered_gelu_phases`. ``launches`` counts the calls that
    reached the card, ``last_plan`` is the plan the last of them launched."""
    if not kernels.on_card(x, "filtered_gelu_fwd"):
        return filtered_gelu_phases(x, up_taps, down_taps)
    y, filtered_gelu_fwd.last_plan = _fg_launch(x, None, up_taps, down_taps)
    filtered_gelu_fwd.launches += 1
    return y


kernels.count_launches(filtered_gelu_fwd)
filtered_gelu_fwd.last_plan = None


def filtered_gelu_bwd(x: torch.Tensor, up_taps, down_taps, g: torch.Tensor) -> torch.Tensor:
    """dx of the filtered GELU for the cotangent ``g``: the backward kernel on
    a CUDA tensor, which recomputes the phases from x; on a CPU tensor autograd
    of :func:`filtered_gelu_phases`. ``launches`` counts the calls that
    reached the card, ``last_plan`` is the plan the last of them launched."""
    if not kernels.on_card(x, "filtered_gelu_bwd"):
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            return torch.autograd.grad(filtered_gelu_phases(xg, up_taps, down_taps), xg, g)[0]
    dx, filtered_gelu_bwd.last_plan = _fg_launch(x, g, up_taps, down_taps)
    filtered_gelu_bwd.launches += 1
    return dx


kernels.count_launches(filtered_gelu_bwd)
filtered_gelu_bwd.last_plan = None


class _FilteredGelu(torch.autograd.Function):
    """Forward saves x and the taps; backward is the backward kernel."""

    @staticmethod
    def forward(ctx, x, up, down):
        ctx.save_for_backward(x, up, down)
        return filtered_gelu_fwd(x, up, down)

    @staticmethod
    def backward(ctx, g):
        x, up, down = ctx.saved_tensors
        return filtered_gelu_bwd(x, up, down, g.contiguous()), None, None


def maxpool2x(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool (NCHW) — the baseline ``Down`` block's pool."""
    return F.max_pool2d(x, 2)


@functools.lru_cache(maxsize=32)
def resize_matrix_1d(
    in_size: int,
    out_size: int,
    align_corners: bool,
    dtype=np.float32,
) -> np.ndarray:
    """Dense 1D bilinear interpolation operator, shape (out_size, in_size).

    Built in float64, cast on return. The cached array is shared: do not
    write to it.
    """
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if in_size == 1:
        m[:, 0] = 1.0
        return m.astype(dtype)
    for i in range(out_size):
        if align_corners:
            src = i * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        else:
            src = (i + 0.5) * in_size / out_size - 0.5
        src = min(max(src, 0.0), in_size - 1.0)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    return m.astype(dtype)


@functools.lru_cache(maxsize=32)
def _resize_matrix(in_size: int, out_size: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """:func:`resize_matrix_1d` (align_corners) as a tensor on ``device``,
    made once: a forward that a CUDA graph captures copies nothing from the
    host. It is made outside inference mode, so that a training forward may
    save it for its backward. The cached tensor is shared: do not write to it."""
    with torch.inference_mode(False):
        return torch.as_tensor(resize_matrix_1d(in_size, out_size, True), dtype=dtype,
                               device=device)


def upsample_bilinear_align_corners(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Bilinear upsample with align_corners=True semantics (NCHW), as two
    separable matrix products — the JAX package's formulation."""
    _, _, h, w = x.shape
    mh = _resize_matrix(h, h * factor, x.dtype, x.device)
    mw = _resize_matrix(w, w * factor, x.dtype, x.device)
    x = torch.einsum("oh,nchw->ncow", mh, x)
    return torch.einsum("pw,ncow->ncop", mw, x)
