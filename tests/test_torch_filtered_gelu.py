"""Port vs JAX package: the polyphase filtered GELU and its selection.

``phase_terms`` and ``filtered_gelu_phases`` of the port (NCHW, plain
PyTorch: the CPU's path and the plain version of ``csrc/filtered_gelu.cu``)
against the JAX package's (NHWC), forward and gradient (``jax.vjp`` against
autograd), with inputs made by numpy from a seed; then which form
``filtered_gelu`` takes; then the kernel pair's launch plan (``fg_plan``):
the instantiation and geometry it picks, that every shape of the main path
(four train steps and the n = 16 sampler, from a spy on the UNet on the meta
device) takes a square-plane instantiation, and, by a numpy simulation of
the kernels' thread-to-strip map, that each output is written exactly once.
Tolerances:

* f32: both sides sum the same f32 tap products in the same order and use
  the exact erf GELU; they differ only in where XLA and PyTorch round inside
  erf, so 1e-6 of the largest entry (a few f32 ulps there).
* bf16: the JAX function multiplies and sums in bf16 arithmetic as XLA on the
  CPU carries it out; the port sums in f32 and rounds each phase and the
  result once, as its conv form (and the kernels) do. One bf16 ulp is at most
  2^-7 of an entry, so 2^-6 of the largest entry allows two ulps there.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu.ops import resample as jr
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import filters as tf
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import resample as tr

F32_REL = 1e-6
BF16_REL = 2.0**-6


def _taps(k):
    return (tf.circular_lowpass_kernel(math.pi / 2, k, 2.0),
            tf.circular_lowpass_kernel(math.pi / 3, k, 1.0))


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(dtype)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _assert_share(got, ref, rel, what):
    err, largest = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rel * largest, f"{what}: max error {err} > {rel} of {largest}"


@pytest.mark.parametrize("k", [3, 5, 7])
def test_phase_terms_equal_the_jax_plans(k):
    assert tr.phase_terms(k) == jr.phase_terms(k)


@pytest.mark.parametrize("k,shape", [(3, (2, 9, 8, 5)), (5, (1, 12, 7, 3)), (7, (2, 6, 6, 2))])
def test_phases_form_matches_jax_in_f32(k, shape):
    """Forward and gradient; odd and non-square planes reach every halo."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    up, down = _taps(k)
    ref, vjp = jax.vjp(lambda a: jr.filtered_gelu_phases(a, up, down), jnp.asarray(x))
    ref_dx = np.asarray(vjp(jnp.asarray(g))[0])
    xt = _nchw(x).requires_grad_()
    out = tr.filtered_gelu_phases(xt, up, down)
    (dx,) = torch.autograd.grad(out, xt, _nchw(g))
    _assert_share(_nhwc(out), np.asarray(ref), F32_REL, "out")
    _assert_share(_nhwc(dx), ref_dx, F32_REL, "dx")
    # the conv form computes the same function
    _assert_share(_nhwc(tr.filtered_gelu(_nchw(x), up, down)), np.asarray(ref), 1e-5, "conv form")


@pytest.mark.parametrize("k", [3, 5])
def test_phases_form_matches_jax_in_bf16(k):
    rng = np.random.default_rng(10 + k)
    x = (2.0 * rng.standard_normal((2, 8, 8, 4))).astype(np.float32)
    g = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    up, down = _taps(k)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref, vjp = jax.vjp(lambda a: jr.filtered_gelu_phases(a, up, down), xb)
    ref_dx = np.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[0].astype(jnp.float32))
    xt = _nchw(x, torch.bfloat16).requires_grad_()
    out = tr.filtered_gelu_phases(xt, up, down)
    (dx,) = torch.autograd.grad(out, xt, _nchw(g, torch.bfloat16))
    assert out.dtype == dx.dtype == torch.bfloat16
    _assert_share(_nhwc(out), np.asarray(ref.astype(jnp.float32)), BF16_REL, "out")
    _assert_share(_nhwc(dx), ref_dx, BF16_REL, "dx")


def test_cpu_wrappers_are_the_plain_version_and_autograd():
    """On the CPU the kernel wrappers take the plain version and launch
    nothing; the backward wrapper is autograd of the plain version."""
    rng = np.random.default_rng(3)
    x = _nchw(rng.standard_normal((2, 6, 6, 3)).astype(np.float32))
    g = _nchw(rng.standard_normal((2, 6, 6, 3)).astype(np.float32))
    up, down = (torch.from_numpy(t) for t in _taps(3))
    launches = tr.filtered_gelu_fwd.launches, tr.filtered_gelu_bwd.launches
    y = tr.filtered_gelu_fwd(x, up, down)
    assert torch.equal(y, tr.filtered_gelu_phases(x, up, down))
    xg = x.clone().requires_grad_()
    (expect,) = torch.autograd.grad(tr.filtered_gelu_phases(xg, up, down), xg, g)
    assert torch.equal(tr.filtered_gelu_bwd(x, up, down, g), expect)
    assert (tr.filtered_gelu_fwd.launches, tr.filtered_gelu_bwd.launches) == launches


@pytest.mark.parametrize("dtype,env,expect", [
    (torch.bfloat16, None, "phases"),
    (torch.float32, None, "conv"),
    (torch.bfloat16, "conv", "conv"),
    (torch.float32, "phases", "phases"),
])
def test_selection_follows_dtype_and_env(monkeypatch, dtype, env, expect):
    """bf16 takes the phases form (the JAX bf16 path's precision=None), f32 the
    conv form, AFDM_FG_IMPL overrides; a CPU tensor launches no kernel."""
    if env is None:
        monkeypatch.delenv("AFDM_FG_IMPL", raising=False)
    else:
        monkeypatch.setenv("AFDM_FG_IMPL", env)
    x = _nchw(np.random.default_rng(4).standard_normal((1, 8, 8, 2)).astype(np.float32), dtype)
    up, down = _taps(3)
    assert tr.fg_impl(x, 3) == expect
    calls = []
    real = tr.filtered_gelu_phases
    monkeypatch.setattr(tr, "filtered_gelu_phases", lambda *a: calls.append(1) or real(*a))
    launches = tr.filtered_gelu_fwd.launches, tr.filtered_gelu_bwd.launches
    xg = x.clone().requires_grad_()
    out = tr.filtered_gelu(xg, up, down)
    out.float().sum().backward()
    assert len(calls) == (expect == "phases")
    assert (tr.filtered_gelu_fwd.launches, tr.filtered_gelu_bwd.launches) == launches
    conv = tr.downsample2x(tr.gelu_exact(tr.upsample2x(x, up)), down)
    if expect == "conv":
        assert torch.equal(out.detach(), conv)
    else:
        _assert_share(out.detach().float().numpy(), conv.float().numpy(),
                      1e-5 if dtype == torch.float32 else BF16_REL, "phases vs conv")
    # even k, another factor or a 3-D input keep the conv form whatever is asked
    assert tr.fg_impl(x, 4) == "conv" and tr.fg_impl(x, 3, factor=3) == "conv"
    assert tr.fg_impl(x[0], 3) == "conv"


@pytest.mark.parametrize("planes,h,w,k,expect", [
    (8192, 32, 32, 3, ("k3_side32", 16, 8, 512)),   # 32-px step, first stage: 4 x 2 strips a plane
    (65536, 4, 4, 3, ("k3_side4", 4, 4, 512)),      # 4x4 planes: a whole plane a thread
    (32768, 16, 16, 3, ("k3_side16", 16, 8, 512)),
    (16, 128, 128, 3, ("k3_side128", 2, 8, 128)),   # few planes: strips of 2 rows
    (5, 1, 1, 7, ("k7_generic", 1, 2, 1)),          # k = 7 and a 1x1 plane: generic
    (3, 9, 40, 5, ("k5_generic", 2, 2, 3)),         # ragged in width
    (16384, 8, 8, 3, ("k3_side8", 2, 8, 512)),      # strips halved to fill the card
    (4096, 4, 4, 3, ("k3_side4", 2, 4, 64)),        # the n = 16 sampler's 4x4 planes
    (15, 4, 4, 3, ("k3_side4", 2, 4, 1)),           # planes no multiple of a block
    (1024, 128, 128, 3, ("k3_side128", 16, 8, 1024)),
    (16384, 64, 64, 3, ("k3_side64", 16, 8, 4096)),
    (8192, 32, 16, 3, ("k3_generic", 16, 4, 512)),  # not square
    (2048, 32, 32, 5, ("k5_generic", 16, 2, 512)),  # square, but k = 5
])
def test_kernel_launch_plan(planes, h, w, k, expect):
    plan = tr.fg_plan(planes, h, w, k)
    assert (plan.instantiation, plan.rows, plan.cols, plan.blocks) == expect
    assert plan.strips_x == -(-w // plan.cols) and plan.strips_y == -(-h // plan.rows)
    assert plan.threads == planes * plan.strips_x * plan.strips_y
    assert (plan.blocks - 1) * tr.FG_THREADS < plan.threads <= plan.blocks * tr.FG_THREADS
    if plan.side:  # what csrc/filtered_gelu.cu demands of a square-plane instantiation
        assert plan.side == h == w and plan.side % plan.rows == 0 and plan.side % plan.cols == 0
        assert plan.strips_y & (plan.strips_y - 1) == 0
    with pytest.raises(ValueError):
        tr.fg_plan(0, h, w, k)


@pytest.mark.parametrize("side", tr.FG_SIDES)
def test_plan_names_its_instantiation(side):
    """A square plane of a listed side at k = 3 takes its own instantiation,
    and only with 16-byte aligned tensors; strips are min(side, 8) wide."""
    plan = tr.fg_plan(64, side, side, 3)
    assert (plan.instantiation, plan.side, plan.cols) == (f"k3_side{side}", side, min(side, 8))
    assert tr.fg_plan(64, side, side, 3, aligned=False).instantiation == "k3_generic"
    assert tr.fg_plan(64, side, side, 5).instantiation == "k5_generic"
    assert tr.fg_plan(64, side + 1, side + 1, 3).side == 0


# The main path's runs: (image, base width, batch) of the four bf16 train
# steps (32 px, 64 px, the two 128-px regimes) and of the n = 16 sampler.
MAIN_PATH_RUNS = {"train32_b256": (32, 32, 256), "train64_b32": (64, 64, 32),
                  "train128_w128_b4": (128, 128, 4), "train128_w32_b8": (128, 32, 8),
                  "sample32_n16": (32, 32, 16)}


def _main_path_shapes(px, width, batch):
    """{(n, c, h, w): calls} of the filtered GELU in one Config-D forward:
    a spy on the blocks' ``filtered_gelu`` over the model on the meta device
    (shapes only; attention stubbed, since its kernels take no meta tensors)."""
    import dataclasses

    from aliasfree_diffusion_models_pytorch_tpu_torch import cli
    from aliasfree_diffusion_models_pytorch_tpu_torch.models import blocks, unet

    config = cli.config_from_args(cli.build_parser().parse_args(
        ["sample", "--variant", "3", "--image-size", str(px), "--image-channels", "3",
         "--compute-dtype", "bfloat16", "--f-kernel", "3", "--f-beta", "2"]))
    config = dataclasses.replace(config, base_width=width, batch_size=batch)
    with torch.device("meta"):
        model = unet.build_model(config, device="meta")
    shapes = {}

    def spy(x, *a, **k):
        shapes[tuple(x.shape)] = shapes.get(tuple(x.shape), 0) + 1
        return x

    real = blocks.filtered_gelu, blocks.flash_mha
    blocks.filtered_gelu, blocks.flash_mha = spy, lambda q, k, v, scale: torch.empty_like(q)
    try:
        with torch.no_grad():
            model(torch.zeros((batch, px, px, 3), device="meta"),
                  torch.ones((batch,), dtype=torch.long, device="meta"))
    finally:
        blocks.filtered_gelu, blocks.flash_mha = real
    return shapes


@pytest.mark.parametrize("run", list(MAIN_PATH_RUNS))
def test_main_path_shapes_take_a_compile_time_instantiation(run):
    shapes = _main_path_shapes(*MAIN_PATH_RUNS[run])
    assert sum(shapes.values()) == 22
    for (n, c, h, w), _ in shapes.items():
        plan = tr.fg_plan(n * c, h, w, 3)
        assert plan.side == h == w and plan.instantiation == f"k3_side{h}", (run, (n, c, h, w))


def _writes(plan, planes, h, w):
    """How often each output of a (planes, h, w) array is written under the
    plan, simulating the kernels' thread-to-strip map (csrc/filtered_gelu.cu:
    locate, and the stores of the row loop)."""
    tid = np.arange(plan.blocks * tr.FG_THREADS, dtype=np.int64)
    if plan.side:
        per_row = plan.side // plan.cols
        shift = (plan.strips_y - 1).bit_length()
        sx, rest = tid % per_row, tid // per_row
        plane, i0 = rest >> shift, (rest & (plan.strips_y - 1)) * plan.rows
    else:
        sx, rest = tid % plan.strips_x, tid // plan.strips_x
        plane, i0 = rest // plan.strips_y, rest % plan.strips_y * plan.rows
    live = plane < planes
    plane, i0, j0 = plane[live, None, None], i0[live, None, None], (sx * plan.cols)[live, None, None]
    rows = i0 + np.arange(plan.rows)[None, :, None]
    cols = j0 + np.arange(plan.cols)[None, None, :]
    stored = (rows < h) & (cols < w)
    flat = ((plane * h + rows) * w + cols)[stored]
    return np.bincount(flat, minlength=planes * h * w)


def _assert_each_output_once(n, c, h, w, k):
    plan = tr.fg_plan(n * c, h, w, k)
    counts = _writes(plan, n * c, h, w)
    assert counts.size == n * c * h * w, (n, c, h, w, plan)
    assert counts.min() == 1 and counts.max() == 1, (n, c, h, w, plan)


@pytest.mark.parametrize("run", list(MAIN_PATH_RUNS))
def test_every_main_path_output_is_written_once(run):
    for n, c, h, w in _main_path_shapes(*MAIN_PATH_RUNS[run]):
        _assert_each_output_once(n, c, h, w, 3)


@pytest.mark.parametrize("n,c,h,w,k", [
    (3, 5, 9, 40, 3), (2, 4, 12, 7, 5), (2, 3, 6, 6, 7), (3, 2, 1, 1, 7), (2, 2, 5, 5, 1),
    (3, 5, 4, 4, 3), (1, 2, 128, 128, 3), (2, 3, 32, 32, 5), (1, 1, 33, 130, 3),
])
def test_every_ragged_output_is_written_once(n, c, h, w, k):
    _assert_each_output_once(n, c, h, w, k)


def test_kernels_need_no_shared_memory():
    """The redesigned pair keeps every intermediate in registers: no shared
    array, and every launch asks for 0 bytes of dynamic shared memory, so no
    plan can exceed a block's shared memory."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels

    src = (kernels.CSRC / kernels.SOURCES["filtered_gelu"]).read_text()
    assert "__shared__" not in src and "MaxDynamicSharedMemorySize" not in src
    launches = [m.group(1) for m in re.finditer(r"<<<([^>]*)>>>", src)]
    assert launches == ["blocks, kThreads, 0, stream"] * 2
