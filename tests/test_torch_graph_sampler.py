"""The samplers' static-buffer step runner against the JAX samplers.

On the card each sampler configuration's reverse step runs as a CUDA graph;
on the CPU the runner calls the same step directly. These tests drive the
CPU path with the JAX sampler's own noise (``noise_fn``, rebuilt from its
keys as ``tests/test_torch_diffusion.py`` does) and watch the runner: which
step each call ran (the index on the device, whether it drew noise), that
the last DDPM step and DDIM's σ = 0 steps draw none, and that a new θ, new
labels or new weights reuse the configuration's buffers. A tiny UNet (image
8, base width 4), the same weights on both sides, f32, 10 noise steps.

Tolerance on the uint8 outputs, as in ``tests/test_torch_diffusion.py``: at
most ±1 (a float difference of ~1e-5 flips a value on a truncation edge), on
at most 2% of the values.
"""

import math

import numpy as np
import pytest
import torch
from jax import random

from aliasfree_diffusion_models_pytorch_tpu.diffusion import Diffusion as JDiffusion
from aliasfree_diffusion_models_pytorch_tpu.models.unet import UNet as JUNet
from aliasfree_diffusion_models_pytorch_tpu_torch import diffusion as diffusion_mod
from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import UNet
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import params_from_jax

SIZE, WIDTH, TDIM, C, N, STEPS = 8, 4, 16, 3, 2, 10


def _models(num_classes=None, seed=3):
    kw = dict(c_in=C, c_out=C, image_size=SIZE, base_width=WIDTH, time_dim=TDIM, variant=0,
              num_classes=num_classes)
    jmodel = JUNet(filters=None, **kw)
    params = jmodel.init_params(random.key(seed), batch=1)
    tmodel = UNet(filters=None, **kw)
    tmodel.load_state_dict(params_from_jax(params), strict=True)
    return jmodel, params, tmodel.eval()


def _jax_noise(seed, n_steps):
    """The JAX sampler's draws: step 0 the initial latent, then one per step."""
    shape = (N, SIZE, SIZE, C)
    key, xkey = random.split(random.key(seed))
    draws = [np.array(random.normal(xkey, shape))]
    for _ in range(n_steps):
        key, nkey = random.split(key)
        draws.append(np.array(random.normal(nkey, shape)))
    return lambda shape_, step: torch.from_numpy(draws[step])


def _close_uint8(out, ref):
    diff = np.abs(out.numpy().astype(np.int16) - np.asarray(ref).astype(np.int16))
    assert diff.max() <= 1 and np.mean(diff > 0) <= 0.02, (diff.max(), np.mean(diff > 0))


def _pair():
    return (JDiffusion(noise_steps=STEPS, img_size=SIZE, snapshot_every=3),
            Diffusion(noise_steps=STEPS, img_size=SIZE, snapshot_every=3, device="cpu"))


@pytest.fixture
def steps(monkeypatch):
    """Every step the runner ran: (kind, index on the device before the
    step, variant, whether the step read the handed-in noise)."""
    ran = []
    plain_step, plain_draw = diffusion_mod._Sampler.step, diffusion_mod._Sampler._draw

    def step(self, noisy):
        self.drawn = False
        index = int(self.index)
        plain_step(self, noisy)
        ran.append((self.kind, index, noisy, self.drawn))

    def draw(self):
        self.drawn = True
        return plain_draw(self)

    monkeypatch.setattr(diffusion_mod._Sampler, "step", step)
    monkeypatch.setattr(diffusion_mod._Sampler, "_draw", draw)
    return ran


def test_ddpm_steps_snapshots_and_noiseless_last_step(steps):
    jmodel, params, tmodel = _models()
    jd, td = _pair()
    ref_final, ref_traj = jd.sample(jmodel.apply, N, C, random.key(0), params=params)
    final, traj = td.sample(tmodel, N, C, noise_fn=_jax_noise(0, STEPS - 1))
    _close_uint8(final, ref_final)
    _close_uint8(traj, ref_traj)  # snapshots at i = 9, 6, 3 and the final state
    # t runs 9 … 1 from the device index; every step draws but the last
    assert steps == [("ddpm", i, i > 1, i > 1) for i in range(STEPS - 1, 0, -1)]
    steps.clear()
    _close_uint8(td.revert(tmodel, N, C, noise_fn=_jax_noise(0, STEPS - 1)), ref_traj)
    assert [s[1] for s in steps] == list(range(STEPS - 1, 0, -1))


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_steps(steps, eta):
    jmodel, params, tmodel = _models()
    jd, td = _pair()
    ref = jd.sample_ddim(jmodel.apply, N, C, random.key(1), steps=5, eta=eta, params=params)
    out = td.sample_ddim(tmodel, N, C, steps=5, eta=eta, noise_fn=_jax_noise(1, 5))
    _close_uint8(out, ref)
    # η = 0 never draws; η = 1 draws on every step but the last (σ = 0 there)
    assert steps == [("ddim", j, eta > 0 and j < 4, eta > 0 and j < 4) for j in range(5)]


def test_ddim_cfg_steps_and_new_labels_reuse_the_buffers(steps):
    jmodel, params, tmodel = _models(num_classes=3)
    jd, td = _pair()
    for seed, labels in ((2, [2, 0]), (6, [1, 1])):
        ref = jd.sample_ddim(jmodel.apply, N, C, random.key(seed), steps=4,
                             labels=np.array(labels), cfg_scale=3.0, params=params)
        out = td.sample_ddim(tmodel, N, C, steps=4, labels=torch.tensor(labels), cfg_scale=3.0,
                             noise_fn=_jax_noise(seed, 4))
        _close_uint8(out, ref)
    # one configuration served both label sets; its labels are the last call's
    (sampler,) = diffusion_mod._SAMPLERS[tmodel].values()
    assert sampler.labels.tolist() == [1, 1] and sampler.cfg_scale == 3.0
    assert len(steps) == 8


def test_rotation_steps_and_new_theta_reuse_the_buffers():
    jmodel, params, tmodel = _models()
    jd, td = _pair()
    for theta in (90.0, -45.0):
        ref, _ = jd.sample(jmodel.apply, N, C, random.key(4), theta=theta, params=params)
        out, _ = td.sample(tmodel, N, C, theta=theta, noise_fn=_jax_noise(4, STEPS - 1))
        _close_uint8(out, ref)
    (sampler,) = diffusion_mod._SAMPLERS[tmodel].values()
    assert sampler.rot.shape == (SIZE * SIZE, SIZE * SIZE)


def test_shift_steps(steps):
    jmodel, params, tmodel = _models()
    jd, td = _pair()
    ref = jd.sample_shift(jmodel.apply, N, C, random.key(5), shift=-3, params=params)
    out = td.sample_shift(tmodel, N, C, shift=-3, noise_fn=_jax_noise(5, STEPS - 1))
    _close_uint8(out, ref)
    assert len(steps) == STEPS - 1  # the shifts happen on the host between steps


def test_new_weights_in_place_reuse_the_configuration():
    jmodel, params, tmodel = _models()
    _, other, _ = _models(seed=11)
    jd, td = _pair()
    td.sample(tmodel, N, C, noise_fn=_jax_noise(0, STEPS - 1))
    tmodel.load_state_dict(params_from_jax(other))  # copies into the same tensors
    ref, _ = jd.sample(jmodel.apply, N, C, random.key(0), params=other)
    out, _ = td.sample(tmodel, N, C, noise_fn=_jax_noise(0, STEPS - 1))
    _close_uint8(out, ref)
    assert len(diffusion_mod._SAMPLERS[tmodel]) == 1


def test_generator_draws_as_the_eager_loop():
    """Without handed-in noise the steps draw from the sampler's own
    generator, which takes the caller's state and gives it back: the same
    draws, and the same generator state after, as a loop drawing from the
    caller's generator itself (the loop of the port before the runner)."""
    _, _, tmodel = _models()
    td = Diffusion(noise_steps=STEPS, img_size=SIZE, device="cpu")
    gen = torch.Generator().manual_seed(9)
    final, _ = td.sample(tmodel, N, C, generator=gen)

    ref_gen = torch.Generator().manual_seed(9)
    shape = (N, SIZE, SIZE, C)
    x = torch.randn(shape, generator=ref_gen)
    alpha, alpha_hat, beta = td.alpha, td.alpha_hat, td.beta
    with torch.inference_mode():
        for i in range(STEPS - 1, 0, -1):
            eps = tmodel(x, torch.full((N,), i, dtype=torch.long))
            x = (1.0 / torch.sqrt(alpha[i])) * (
                x - ((1.0 - alpha[i]) / torch.sqrt(1.0 - alpha_hat[i])) * eps)
            if i > 1:
                x = x + torch.sqrt(beta[i]) * torch.randn(shape, generator=ref_gen)
    assert torch.equal(final, Diffusion.to_uint8(x))
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    assert math.isfinite(float(x.abs().max()))
