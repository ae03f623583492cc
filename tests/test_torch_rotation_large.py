"""Rotation above 64 px and fractional shifts, against the JAX package and
scipy.

* ``rotation_gather_plan``'s ``idx``, ``w`` and ``pre`` are bit-equal to the
  JAX package's at 96 and 128 px, spline orders 1 and 3 (the same float64
  numpy arithmetic, then the same f32 rounding);
* ``rotate_nhwc`` (the gather path above 64 px) and fractional ``shift_nhwc``
  match the JAX functions at Precision.HIGHEST within 1e-5, and
  ``scipy.ndimage.rotate`` / ``shift`` (float64) within 1e-5: f32 sums of up
  to 16 taps and two prefilter products of order-1 values, in another order;
* ``Diffusion.sample(theta=...)`` at 72 px (gather path, order 3) with a
  narrow UNet, 4 noise steps and the JAX sampler's own noise matches the JAX
  sampler on the uint8 output: at most ±1 on at most 2% of the values (a
  float difference of ~1e-5 flips a value on a truncation edge).
"""

import numpy as np
import pytest
import torch
from jax import random
from scipy import ndimage

from aliasfree_diffusion_models_pytorch_tpu.diffusion import Diffusion as JDiffusion
from aliasfree_diffusion_models_pytorch_tpu.models.unet import UNet as JUNet
from aliasfree_diffusion_models_pytorch_tpu.ops import rotation as jrot
from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import UNet
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import rotation
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import params_from_jax

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers run at once: two threads each are enough."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("size", [96, 128])
@pytest.mark.parametrize("order", [1, 3])
def test_gather_plan_is_bit_equal_to_the_jax_one(size, order):
    ours = rotation.rotation_gather_plan(size, 37.5, order)
    theirs = jrot.rotation_gather_plan(size, 37.5, order)
    taps = (order + 1) ** 2
    assert ours.idx.shape == ours.w.shape == (taps, size * size)
    np.testing.assert_array_equal(ours.idx, theirs.idx)
    np.testing.assert_array_equal(ours.w, theirs.w)
    if order == 1:
        assert ours.pre is None and theirs.pre is None
    else:
        np.testing.assert_array_equal(ours.pre, theirs.pre)


def _batch(size, seed):
    return np.random.default_rng(seed).standard_normal((2, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("size,order,degrees", [(96, 1, 30.0), (96, 3, -72.5), (128, 3, 0.09)])
def test_rotate_matches_the_jax_package_and_scipy(size, order, degrees):
    x = _batch(size, seed=order)
    m = rotation.build_rotation(size, degrees, order, device="cpu")
    assert isinstance(m, rotation.GatherRotation) and m.idx.dtype == torch.long
    out = rotation.rotate_nhwc(torch.from_numpy(x), degrees, order).numpy()
    np.testing.assert_allclose(out, np.asarray(jrot.rotate_nhwc(x, degrees, order)),
                               rtol=0, atol=ATOL)
    ref = ndimage.rotate(x.astype(np.float64), degrees, axes=(1, 2), reshape=False,
                         mode="grid-wrap", order=order)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="limited to 64x64"):
        rotation.rotation_operator(size, degrees, order)


@pytest.mark.parametrize("hshift,vshift", [(2.5, -1.25), (0.0, 0.5), (-3.75, 0.0), (2, -1)])
def test_fractional_shift_matches_the_jax_package_and_scipy(hshift, vshift):
    x = _batch(24, seed=5)
    out = rotation.shift_nhwc(torch.from_numpy(x), hshift, vshift).numpy()
    np.testing.assert_allclose(out, np.asarray(jrot.shift_nhwc(x, hshift, vshift)),
                               rtol=0, atol=ATOL)
    ref = ndimage.shift(x.astype(np.float64), (0, vshift, hshift, 0), mode="grid-wrap", order=3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


SIZE, WIDTH, TDIM, C, STEPS = 72, 4, 16, 3, 4


def test_sampler_with_rotation_above_64_px_matches_the_jax_sampler():
    kw = dict(c_in=C, c_out=C, image_size=SIZE, base_width=WIDTH, time_dim=TDIM, variant=0)
    jmodel = JUNet(**kw)
    params = jmodel.init_params(random.key(6), batch=1)
    tmodel = UNet(**kw)
    tmodel.load_state_dict(params_from_jax(params), strict=True)
    tmodel.eval()

    shape = (1, SIZE, SIZE, C)
    key, xkey = random.split(random.key(7))
    draws = [np.array(random.normal(xkey, shape))]
    for _ in range(STEPS - 1):
        key, nkey = random.split(key)
        draws.append(np.array(random.normal(nkey, shape)))

    jd = JDiffusion(noise_steps=STEPS, img_size=SIZE)
    td = Diffusion(noise_steps=STEPS, img_size=SIZE, device="cpu")
    ref, _ = jd.sample(jmodel.apply, 1, C, random.key(7), theta=90.0, params=params)
    out, _ = td.sample(tmodel, 1, C, theta=90.0,
                       noise_fn=lambda s, step: torch.from_numpy(draws[step]))
    diff = np.abs(out.numpy().astype(np.int16) - np.asarray(ref).astype(np.int16))
    assert diff.max() <= 1 and np.mean(diff > 0) <= 0.02, (diff.max(), np.mean(diff > 0))
    assert out.numpy().std() > 0
