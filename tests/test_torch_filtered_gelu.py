"""Port vs JAX package: the polyphase filtered GELU and its selection.

``phase_terms`` and ``filtered_gelu_phases`` of the port (NCHW, plain
PyTorch: the CPU's path and the plain version of ``csrc/filtered_gelu.cu``)
against the JAX package's (NHWC), forward and gradient (``jax.vjp`` against
autograd), with inputs made by numpy from a seed; then which form
``filtered_gelu`` takes. Tolerances:

* f32: both sides sum the same f32 tap products in the same order and use
  the exact erf GELU; they differ only in where XLA and PyTorch round inside
  erf, so 1e-6 of the largest entry (a few f32 ulps there).
* bf16: the JAX function multiplies and sums in bf16 arithmetic as XLA on the
  CPU carries it out; the port sums in f32 and rounds each phase and the
  result once, as its conv form (and the kernels) do. One bf16 ulp is at most
  2^-7 of an entry, so 2^-6 of the largest entry allows two ulps there.
"""

import math

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
    (8192, 32, 32, 3, (16, 32, 1, 16384)),   # 32-px step, first stage: two tiles a plane
    (65536, 4, 4, 3, (4, 4, 32, 2048)),      # 4x4 planes: 32 whole planes a block
    (32768, 16, 16, 3, (16, 16, 2, 16384)),
    (16, 128, 128, 3, (16, 32, 1, 512)),
    (5, 1, 1, 7, (1, 1, 64, 1)),             # shared memory, not the tile, limits the planes
    (3, 9, 40, 5, (9, 32, 1, 6)),            # ragged in width
])
def test_kernel_launch_plan(planes, h, w, k, expect):
    plan = tr.fg_plan(planes, h, w, k)
    assert (plan.tile_h, plan.tile_w, plan.planes_per_block, plan.blocks) == expect
    assert plan.tile_h * plan.tile_w * plan.planes_per_block <= tr.FG_TILE_ELEMS
    with pytest.raises(ValueError):
        tr.fg_plan(0, h, w, k)
