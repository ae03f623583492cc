"""Port vs JAX package: filter design and the alias-free resampling ops.

Same inputs, made with numpy from a seed, through both packages on the CPU.
The JAX ops take NHWC, the port's NCHW; the tests transpose. Both sides run
in f32 (JAX at Precision.HIGHEST, its default for these ops), so the 1e-5
tolerance covers only summation order in the convolutions.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu.ops import filters as jf
from aliasfree_diffusion_models_pytorch_tpu.ops import resample as jr
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import filters as tf
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import resample as tr

ATOL = 1e-5  # f32 convolutions, different summation order


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port(fn, x_nhwc, *args):
    out = fn(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2), *args)
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("omega,size,beta,normalize", [
    (math.pi / 2, 3, 2.0, True),
    (math.pi / 2, 4, None, True),
    (math.pi, 6, 0.0, False),
    (math.pi / 3, 5, 1.0, True),
    (math.pi / 2, 1, None, True),
])
def test_circular_lowpass_kernel_bit_equal(omega, size, beta, normalize):
    a = jf.circular_lowpass_kernel(omega, size, beta, normalize)
    b = tf.circular_lowpass_kernel(omega, size, beta, normalize)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_other_filter_designs_bit_equal():
    assert np.array_equal(jf.jinc_filter_2d(6, 14.0), tf.jinc_filter_2d(6, 14.0))
    k = tf.circular_lowpass_kernel(math.pi / 2, 3, 2.0)
    assert np.array_equal(jf.kernel_frequency_response(k), tf.kernel_frequency_response(k))


@pytest.mark.parametrize("k", [3, 4, 5])  # odd and even: same_pad's asymmetry
def test_downsample2x(k):
    x = _x((2, 8, 8, 3), seed=k)
    taps = tf.circular_lowpass_kernel(math.pi / 2, k, 2.0)
    ref = np.asarray(jr.downsample2x(jnp.asarray(x), taps))
    np.testing.assert_allclose(_port(tr.downsample2x, x, taps), ref, atol=ATOL)


@pytest.mark.parametrize("k", [3, 4, 5])
def test_upsample2x_gain_one(k):
    x = _x((2, 6, 6, 3), seed=10 + k)
    taps = tf.circular_lowpass_kernel(math.pi / 2, k, 2.0)
    ref = np.asarray(jr.upsample2x(jnp.asarray(x), taps))
    out = _port(tr.upsample2x, x, taps)
    assert out.shape == (2, 12, 12, 3)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("k", [3, 4])
def test_filtered_gelu(k):
    x = _x((2, 8, 8, 4), seed=20 + k)
    up = tf.circular_lowpass_kernel(math.pi / 2, k, 2.0)
    down = tf.circular_lowpass_kernel(math.pi / 3, k, 1.0)
    ref = np.asarray(jr.filtered_gelu(jnp.asarray(x), up, down))
    np.testing.assert_allclose(_port(tr.filtered_gelu, x, up, down), ref, atol=ATOL)


def test_maxpool2x_and_bilinear():
    x = _x((2, 8, 8, 3), seed=30)
    np.testing.assert_array_equal(_port(tr.maxpool2x, x), np.asarray(jr.maxpool2x(jnp.asarray(x))))
    ref = np.asarray(jr.upsample_bilinear_align_corners(jnp.asarray(x)))
    np.testing.assert_allclose(_port(tr.upsample_bilinear_align_corners, x), ref, atol=ATOL)
    for args in [(4, 8, True), (28, 32, False), (1, 3, True)]:
        assert np.array_equal(tr.resize_matrix_1d(*args), jr.resize_matrix_1d(*args))


def test_gelu_exact_f32_is_erf_form():
    x = _x((4096,), seed=40) * 4
    ref = np.asarray(jr.gelu_exact(jnp.asarray(x)))
    np.testing.assert_allclose(tr.gelu_exact(torch.from_numpy(x)).numpy(), ref, atol=1e-6)


def test_gelu_exact_bf16_polynomial():
    # Both sides evaluate the same degree-15 polynomial in f32 and round to
    # bf16; a different fusion of the f32 steps may flip the final rounding,
    # so allow one bf16 ulp (2^-7 relative, 8 mantissa bits) per element.
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = np.asarray(jr.gelu_exact(jnp.asarray(xb.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    out = tr.gelu_exact(xb)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    np.testing.assert_allclose(out, ref, rtol=2.0**-7, atol=1e-30)
    assert np.mean(out == ref) > 0.99
