"""Port vs JAX package: the samplers, with the JAX sampler's own noise.

The JAX samplers draw their noise from ``jax.random`` keys; the tests rebuild
that exact sequence (``random.split`` in the order of ``diffusion.py:223-224``
and ``:179,185``, or ``:399-400`` and ``:407,415`` for DDIM) and hand it to
the port through ``noise_fn``. A tiny UNet (image 8, base width 4) with the
same weights on both sides, f32, 10 noise steps.

Tolerance on the uint8 outputs: both truncate ``(x+1)/2·255``, so a float
difference of ~1e-5 between the two frameworks flips a value sitting on a
truncation edge by one. Allowed: at most ±1, on at most 2% of the values.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from aliasfree_diffusion_models_pytorch_tpu.config import FilterSettings as JFilters
from aliasfree_diffusion_models_pytorch_tpu.diffusion import Diffusion as JDiffusion
from aliasfree_diffusion_models_pytorch_tpu.models.unet import UNet as JUNet
from aliasfree_diffusion_models_pytorch_tpu.ops.rotation import rotation_operator as j_rotation
from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings
from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import UNet
from aliasfree_diffusion_models_pytorch_tpu_torch.ops.rotation import rotation_operator
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import params_from_jax

SIZE, WIDTH, TDIM, C, N, STEPS = 8, 4, 16, 3, 2, 10


def _models(variant=0, num_classes=None):
    f = dict(kernel_size=3, kaiser_beta=2.0, omega_c_down=math.pi / 2, omega_c_up=math.pi / 2)
    kw = dict(c_in=C, c_out=C, image_size=SIZE, base_width=WIDTH, time_dim=TDIM,
              variant=variant, num_classes=num_classes)
    jmodel = JUNet(filters=None if variant == 0 else JFilters(**f), **kw)
    params = jmodel.init_params(random.key(3), batch=1)
    tmodel = UNet(filters=None if variant == 0 else FilterSettings(**f), **kw)
    tmodel.load_state_dict(params_from_jax(params), strict=True)
    return jmodel, params, tmodel.eval()


def _jax_noise(seed, n_steps, n=N):
    """The JAX sampler's draws: step 0 the initial latent, then one per step."""
    shape = (n, SIZE, SIZE, C)
    key, xkey = random.split(random.key(seed))
    draws = [np.array(random.normal(xkey, shape))]
    for _ in range(n_steps):
        key, nkey = random.split(key)
        draws.append(np.array(random.normal(nkey, shape)))

    def noise_fn(shape_, step):
        assert tuple(shape_) == shape
        return torch.from_numpy(draws[step])

    return noise_fn


def _close_uint8(out, ref):
    out = out.numpy().astype(np.int16) if torch.is_tensor(out) else out.astype(np.int16)
    ref = np.asarray(ref).astype(np.int16)
    assert out.shape == ref.shape
    diff = np.abs(out - ref)
    assert diff.max() <= 1, diff.max()
    assert np.mean(diff > 0) <= 0.02, np.mean(diff > 0)


def _pair_diffusion():
    return (JDiffusion(noise_steps=STEPS, img_size=SIZE, snapshot_every=3),
            Diffusion(noise_steps=STEPS, img_size=SIZE, snapshot_every=3, device="cpu"))


def test_schedule_and_noise_images():
    jd, td = _pair_diffusion()
    np.testing.assert_allclose(td.beta.numpy(), np.asarray(jd.beta), rtol=1e-6)
    np.testing.assert_allclose(td.alpha_hat.numpy(), np.asarray(jd.alpha_hat), rtol=1e-6)
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (N, SIZE, SIZE, C)))
    t = torch.tensor([1, STEPS - 1])
    xt, eps = td.noise_images(x.float(), t, torch.Generator().manual_seed(0))
    ah = td.alpha_hat[t][:, None, None, None]
    torch.testing.assert_close(xt, ah.sqrt() * x.float() + (1 - ah).sqrt() * eps)


def test_ddpm_sample_and_revert():
    jmodel, params, tmodel = _models()
    jd, td = _pair_diffusion()
    ref_final, ref_traj = jd.sample(jmodel.apply, N, C, random.key(0), params=params)
    final, traj = td.sample(tmodel, N, C, noise_fn=_jax_noise(0, STEPS - 1))
    assert final.dtype == torch.uint8 and traj.shape == (4 * N, SIZE, SIZE, C)
    _close_uint8(final, ref_final)
    _close_uint8(traj, ref_traj)
    _close_uint8(td.revert(tmodel, N, C, noise_fn=_jax_noise(0, STEPS - 1)), ref_traj)


def test_ddpm_sample_with_rotation():
    jmodel, params, tmodel = _models()
    jd, td = _pair_diffusion()
    ref, _ = jd.sample(jmodel.apply, N, C, random.key(4), theta=90.0, params=params)
    out, _ = td.sample(tmodel, N, C, theta=90.0, noise_fn=_jax_noise(4, STEPS - 1))
    _close_uint8(out, ref)


def test_sample_shift():
    jmodel, params, tmodel = _models()
    jd, td = _pair_diffusion()
    ref = jd.sample_shift(jmodel.apply, N, C, random.key(5), shift=-3, params=params)
    out = td.sample_shift(tmodel, N, C, shift=-3, noise_fn=_jax_noise(5, STEPS - 1))
    _close_uint8(out, ref)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim(eta):
    jmodel, params, tmodel = _models()
    jd, td = _pair_diffusion()
    ref = jd.sample_ddim(jmodel.apply, N, C, random.key(1), steps=5, eta=eta, params=params)
    out = td.sample_ddim(tmodel, N, C, steps=5, eta=eta, noise_fn=_jax_noise(1, 5))
    _close_uint8(out, ref)


def test_ddim_cfg_conditional():
    jmodel, params, tmodel = _models(num_classes=3)
    jd, td = _pair_diffusion()
    labels = np.array([2, 0])
    ref = jd.sample_ddim(jmodel.apply, N, C, random.key(2), steps=4, labels=labels,
                         cfg_scale=3.0, params=params)
    out = td.sample_ddim(tmodel, N, C, steps=4, labels=torch.from_numpy(labels),
                         cfg_scale=3.0, noise_fn=_jax_noise(2, 4))
    _close_uint8(out, ref)
    with pytest.raises(ValueError, match="cfg_scale requires labels"):
        td.sample_ddim(tmodel, N, C, steps=4, cfg_scale=3.0)


def test_config_e_rotation_operator_equal():
    ref = j_rotation(16, 37.5, 3)
    out = rotation_operator(16, 37.5, 3)
    assert out.dtype == ref.dtype and np.array_equal(out, ref)
    x = np.random.default_rng(0).standard_normal((1, 16, 16, 2)).astype(np.float32)
    from aliasfree_diffusion_models_pytorch_tpu.ops.rotation import apply_pixel_operator as jap
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops.rotation import apply_pixel_operator

    np.testing.assert_allclose(
        apply_pixel_operator(torch.from_numpy(x), torch.from_numpy(out)).numpy(),
        np.asarray(jap(jnp.asarray(x), jnp.asarray(ref))), atol=1e-5)
