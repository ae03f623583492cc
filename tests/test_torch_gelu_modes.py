"""Port vs JAX package: the bf16 GELU under ``AFDM_GELU``.

The JAX package's ``gelu_exact`` reads ``AFDM_GELU``: ``exact`` forces the erf
form everywhere, ``poly13`` takes the degree-13 polynomial on bf16, anything
else the degree-15 one on bf16 and erf on f32. The port's ``gelu_exact``, its
``filtered_gelu_phases`` (the plain version of the CUDA kernel pair) and the
keys of its CUDA graphs follow the same knob. Inputs are made by numpy from
a seed. Tolerances:

* bf16, unset and ``poly13``: both packages evaluate the same polynomial in
  f32 and round once to bf16, so ``gelu_exact`` is held to one bf16 ulp of
  each element (it is equal on this CPU), and to 2^-6 of the largest entry
  (chip_smoke's share). ``filtered_gelu_phases`` sums its taps in bf16 in the
  JAX package and in f32 in the port (``tests/test_torch_filtered_gelu.py``),
  so it is held to 2^-6 of the largest entry, forward and gradient.
* bf16, ``exact``: ``jax.nn.gelu`` rounds every operation of its erf formula
  to bf16 (x·√½, erf, +1, ·x, /2), the port rounds torch's f32 erf GELU once.
  Measured here on 50000 draws of 3·N(0, 1): 1.3e-3 of the largest entry, and
  at most five bf16 ulps of an element with |gelu| above 2^-8 (below that, an
  element's ulp is finer than the rounding of the JAX formula's x·√½ and +1
  can follow: 254 ulps near gelu = 0). Held to 2^-6 of the largest entry, and
  8 ulps above 2^-8. ``filtered_gelu_phases`` under ``exact`` measured 5.6e-3
  and 8.3e-3 of the largest entry (k = 3, 5), as in the other modes.
* f32: the erf form in every mode, 1e-6 of the largest entry, as
  ``tests/test_torch_filtered_gelu.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu.ops import resample as jr
from aliasfree_diffusion_models_pytorch_tpu_torch import diffusion as tdiffusion
from aliasfree_diffusion_models_pytorch_tpu_torch import train as ttrain
from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import build_model
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import filters as tf
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import resample as tr

MODES = [None, "exact", "poly13"]
BF16_REL = 2.0**-6
F32_REL = 1e-6
EXACT_BF16_ULPS = 8


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several worker processes at once; two threads each keep
    their OpenMP barriers from spinning against each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _set_mode(monkeypatch, mode):
    if mode is None:
        monkeypatch.delenv("AFDM_GELU", raising=False)
    else:
        monkeypatch.setenv("AFDM_GELU", mode)


def _share(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _bf16_ulps(got, ref, floor=0.0):
    """Largest |got − ref| in bf16 ulps of ref, over the entries |ref| > floor."""
    keep = np.abs(ref) > max(floor, 1e-30)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref[keep]))) - 7)
    return float((np.abs(got[keep] - ref[keep]) / ulp).max())


@pytest.mark.parametrize("mode", MODES)
def test_gelu_form_follows_the_knob(monkeypatch, mode):
    _set_mode(monkeypatch, mode)
    assert tr.gelu_mode() == mode
    assert tr.gelu_form(torch.float32) == "erf"
    assert tr.gelu_form(torch.bfloat16) == {None: "poly15", "exact": "erf",
                                            "poly13": "poly13"}[mode]
    monkeypatch.setenv("AFDM_GELU", "poly11")  # anything else: the default
    assert tr.gelu_mode() is None and tr.gelu_form(torch.bfloat16) == "poly15"


def test_degree_13_coefficients_are_the_jax_ones():
    assert tr._GELU_POLY_13 == jr._GELU_POLY_13
    assert tr._GELU_POLY_15 == jr._GELU_POLY_15


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gelu_exact_matches_jax(monkeypatch, mode, dtype):
    _set_mode(monkeypatch, mode)
    x = (3.0 * np.random.default_rng(7).standard_normal(50000)).astype(np.float32)
    ref = np.asarray(jr.gelu_exact(jnp.asarray(x, getattr(jnp, dtype))).astype(jnp.float32))
    out = tr.gelu_exact(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    got = out.float().numpy()
    if dtype == "float32":
        assert _share(got, ref) <= F32_REL
    elif mode == "exact":
        assert _share(got, ref) <= BF16_REL
        assert _bf16_ulps(got, ref, floor=2.0**-8) <= EXACT_BF16_ULPS
    else:
        assert _share(got, ref) <= BF16_REL
        assert _bf16_ulps(got, ref) <= 1.0


def _taps(k):
    return (tf.circular_lowpass_kernel(math.pi / 2, k, 2.0),
            tf.circular_lowpass_kernel(math.pi / 3, k, 1.0))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [3, 5])
def test_filtered_gelu_phases_matches_jax_in_bf16(monkeypatch, mode, k):
    import jax

    _set_mode(monkeypatch, mode)
    rng = np.random.default_rng(20 + k)
    x = (2.0 * rng.standard_normal((2, 8, 8, 4))).astype(np.float32)
    g = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    up, down = _taps(k)
    ref, vjp = jax.vjp(lambda a: jr.filtered_gelu_phases(a, up, down),
                       jnp.asarray(x, jnp.bfloat16))
    ref_dx = np.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[0].astype(jnp.float32))
    ref = np.asarray(ref.astype(jnp.float32))

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(torch.bfloat16)

    xt = nchw(x).requires_grad_()
    out = tr.filtered_gelu_phases(xt, up, down)
    (dx,) = torch.autograd.grad(out, xt, nchw(g))
    assert out.dtype == dx.dtype == torch.bfloat16
    got = out.detach().float().permute(0, 2, 3, 1).numpy()
    got_dx = dx.float().permute(0, 2, 3, 1).numpy()
    assert _share(got, ref) <= BF16_REL
    assert _share(got_dx, ref_dx) <= BF16_REL


def _config(**kw):
    base = dict(run_name="g", epochs=1, batch_size=2, image_size=8, base_width=8,
                image_channels=3, noise_steps=10, variant=3, seed=0, time_dim=32,
                compute_dtype="bfloat16", filters=FilterSettings(kaiser_beta=2.0))
    base.update(kw)
    return TrainConfig(**base)


def test_train_step_captures_a_graph_per_mode(monkeypatch):
    """A step keys its static buffers (and so its CUDA graphs) on the mode,
    as the JAX package's trace latches it: a changed mode takes a signature
    of its own and never replays the old one."""
    seen = []
    plain_step = ttrain._StepInputs.step

    def step(self, variant):
        seen.append(id(self))
        plain_step(self, variant)

    monkeypatch.setattr(ttrain._StepInputs, "step", step)
    config = _config()
    model, state = ttrain.create_train_state(config, device="cpu")
    step_fn = ttrain.make_train_step(
        model, config, tdiffusion.Diffusion(noise_steps=10, img_size=8, device="cpu"))
    batch = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8, 8, 3))
                             .astype(np.float32))
    losses = []
    for mode in (None, "poly13", None, "poly13", "exact"):
        _set_mode(monkeypatch, mode)
        gen = torch.Generator().manual_seed(5)
        state, loss = step_fn(state, batch, gen)
        losses.append(float(loss))
    assert len(set(seen)) == 3
    assert seen[0] == seen[2] and seen[1] == seen[3] and seen[4] not in seen[:4]
    assert all(math.isfinite(v) for v in losses)


def test_sampler_is_made_per_mode(monkeypatch):
    config = _config()
    model = build_model(config, device="cpu")
    d = tdiffusion.Diffusion(noise_steps=3, img_size=8, device="cpu")
    for mode in (None, "poly13", "exact", None):
        _set_mode(monkeypatch, mode)
        d.sample_ddim(model, n=1, image_channels=3, generator=torch.Generator().manual_seed(0),
                      steps=2)
    assert len(tdiffusion._SAMPLERS[model]) == 3


@pytest.mark.parametrize("knob,value", [("AFDM_GELU", "poly13"), ("AFDM_FG_IMPL", "conv")])
def test_sampler_captures_a_graph_of_its_own_per_knob(monkeypatch, knob, value):
    """A sampler made under a numerics knob is keyed on ``capture_key()`` and
    is never the one made without it, nor made again when the knob returns."""
    monkeypatch.delenv("AFDM_GELU", raising=False)
    monkeypatch.delenv("AFDM_FG_IMPL", raising=False)
    config = _config()
    model = build_model(config, device="cpu")
    d = tdiffusion.Diffusion(noise_steps=3, img_size=8, device="cpu")
    keys = []
    for setting in (None, value, None, value):
        if setting is None:
            monkeypatch.delenv(knob, raising=False)
        else:
            monkeypatch.setenv(knob, setting)
        d.sample_ddim(model, n=1, image_channels=3, generator=torch.Generator().manual_seed(0),
                      steps=2)
        keys.append(tr.capture_key())
    assert keys[1] != keys[0] and value in keys[1]
    samplers = tdiffusion._SAMPLERS[model]
    assert len(samplers) == 2
    assert {key[-2] for key in samplers} == {keys[0], keys[1]}
