"""Port vs JAX package: the train step, trajectory against trajectory.

Both sides start from the same weights (the JAX initialisation, through
``params_from_jax``), see the same batch, and use the same timesteps, noise
and label mask: the test splits the per-step JAX key exactly as ``loss_fn``
does (``train.py:263-265`` of the JAX package) and hands the draws to the
port's step as ``t=``, ``noise=`` and ``keep=``. Everything is f32 on the
CPU, tiny (image 8, base width 8).

Tolerances. The loss is one f32 forward on each side: rtol 2e-5. Parameters
move by at most ~lr = 3e-4 per AdamW update, as lr·m̂/(√v̂ + eps); the two
frameworks' gradients differ by f32 summation order (~1e-6 relative), which
the normalisation passes through, so parameters are held to atol 2e-6 after
each step. AdamW's normalisation amplifies that error where a gradient entry
is itself near zero (its sign and size are then rounding noise, and the step
is up to lr either way), so two allowances are made, and stated here:

* at most 0.1% of a tensor's entries (two, in a small tensor) may miss atol
  2e-6, and every entry stays within the bound both sides obey, |Δ| ≤ 2·lr
  per update. A wrong lr, decay, clip, schedule or EMA moves every entry, so
  the check keeps its power;
* the key bias (the middle third of every ``qkv.bias``) is held to that bound
  only: adding a constant to all keys leaves the softmax unchanged, so its
  true gradient is exactly zero and what each framework computes is noise.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from aliasfree_diffusion_models_pytorch_tpu.config import FilterSettings as JFilters
from aliasfree_diffusion_models_pytorch_tpu.config import TrainConfig as JTrainConfig
from aliasfree_diffusion_models_pytorch_tpu.data import synthetic_dataset
from aliasfree_diffusion_models_pytorch_tpu.diffusion import Diffusion as JDiffusion
from aliasfree_diffusion_models_pytorch_tpu.train import create_train_state as j_create_train_state
from aliasfree_diffusion_models_pytorch_tpu.train import make_train_step as j_make_train_step
from aliasfree_diffusion_models_pytorch_tpu_torch import train as ttrain
from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import params_from_jax

FILTERS = dict(kernel_size=3, kaiser_beta=2.0, omega_c_down=math.pi / 2, omega_c_up=math.pi / 2)
LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-6
N, SIZE, C, STEPS = 4, 8, 3, 50


def _configs(**kw):
    base = dict(run_name="t", epochs=1, batch_size=N, image_size=SIZE, base_width=8,
                image_channels=C, noise_steps=STEPS, variant=0, seed=0, time_dim=32)
    base.update(kw)
    variant = base["variant"]
    jcfg = JTrainConfig(filters=None if variant == 0 else JFilters(**FILTERS), **base)
    tcfg = TrainConfig(filters=None if variant == 0 else FilterSettings(**FILTERS), **base)
    return jcfg, tcfg


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)  # copies: the jitted step donates its state


class _Pair:
    """A JAX trainer and the port's, from the same weights."""

    def __init__(self, start_step=0, **kw):
        self.jcfg, self.tcfg = _configs(**kw)
        self.jmodel, self.jstate = j_create_train_state(self.jcfg, random.key(0))
        if start_step:
            self.jstate = dataclasses.replace(self.jstate, step=jnp.asarray(start_step, jnp.int32))
        self.jdiff = JDiffusion(noise_steps=STEPS, img_size=SIZE)
        self.jstep = j_make_train_step(self.jmodel, self.jcfg, self.jdiff)
        self.tmodel, self.tstate = ttrain.create_train_state(
            self.tcfg, device="cpu", state_dict=params_from_jax(_numpy_tree(self.jstate.params)))
        self.tstate.step = start_step
        self.tstep = ttrain.make_train_step(
            self.tmodel, self.tcfg, Diffusion(noise_steps=STEPS, img_size=SIZE, device="cpu"))
        self.batch = synthetic_dataset(n=N, image_size=SIZE, channels=C, seed=3).images

    def step(self, i, labels=None, n_real=None):
        """Micro-batch ``i`` on both sides with the JAX side's draws; returns
        the two losses."""
        key = random.fold_in(random.key(1), i)
        tkey, nkey, dkey = random.split(key, 3)
        t = np.array(self.jdiff.sample_timesteps(tkey, N))
        noise = np.array(random.normal(nkey, self.batch.shape, jnp.float32))
        keep = None
        if self.jcfg.label_dropout > 0.0:
            keep = np.array(random.uniform(dkey, (N,)) >= self.jcfg.label_dropout, np.float32)
        self.jstate, jloss = self.jstep(
            self.jstate, jnp.asarray(self.batch), key,
            None if labels is None else jnp.asarray(labels),
            None if n_real is None else jnp.asarray(n_real, jnp.int32))
        self.tstate, tloss = self.tstep(
            self.tstate, torch.from_numpy(self.batch), None,
            None if labels is None else torch.from_numpy(labels).long(), n_real,
            t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise),
            keep=None if keep is None else torch.from_numpy(keep))
        assert t.min() >= 1 and t.max() < STEPS
        return float(jloss), float(tloss)

    def assert_same(self, what, atol=PARAM_ATOL):
        noise_bound = 2.0 * self.tcfg.lr * max(1, self.tstate.updates)
        for field in what:
            expect = params_from_jax(_numpy_tree(getattr(self.jstate, field)))
            got = getattr(self.tstate, field)
            assert set(got) == set(expect)
            for name, value in got.items():
                a, e = value.numpy(), expect[name].numpy()
                if name.endswith(".qkv.bias") and atol:
                    third = len(a) // 3
                    key_bias = slice(third, 2 * third)  # zero true gradient: see the docstring
                    assert np.abs(a[key_bias] - e[key_bias]).max() <= noise_bound, name
                    a, e = np.delete(a, key_bias), np.delete(e, key_bias)
                err = np.abs(a - e)
                assert err.max() <= (noise_bound if atol else 0), (field, name, err.max())
                misses = int((err > atol).sum())
                assert misses <= max(2, 1e-3 * err.size), (field, name, misses, err.max())
        assert self.tstate.step == int(self.jstate.step)


def test_config_d_three_steps_match_jax_train_step():
    pair = _Pair(variant=3)
    for i in range(3):
        jloss, tloss = pair.step(i)
        np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
        pair.assert_same(["params"])
    # use_ema is off: the EMA stays the initial copy on both sides
    pair.assert_same(["ema_params"], atol=0)


def test_ema_accumulation_clip_and_warmup_cosine_match_jax():
    """Variant 0 with every opt-in knob, started two micro-batches before
    ``step_start_ema``: the updates land on micro-batches 2, 4 and 6 with
    lr 0, lr and 0.75·lr; the EMA copies on the first and blends on the
    others, and holds still in between."""
    pair = _Pair(start_step=ttrain.STEP_START_EMA - 2, variant=0, use_ema=True, ema_beta=0.9,
                 grad_accum=2, grad_clip=0.05, lr_schedule="warmup_cosine", warmup_steps=1,
                 lr_total_steps=4, lr=1e-3)
    assert [ttrain.lr_at(pair.tcfg, u) for u in range(3)] == pytest.approx([0.0, 1e-3, 0.75e-3])
    start = {k: v.clone() for k, v in pair.tstate.params.items()}
    for i in range(6):
        ema_before = {k: v.clone() for k, v in pair.tstate.ema_params.items()}
        jloss, tloss = pair.step(i)
        np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
        pair.assert_same(["params", "ema_params"])
        if i % 2 == 0:  # no update emitted: the EMA holds still
            assert all(torch.equal(v, ema_before[k]) for k, v in pair.tstate.ema_params.items())
        if i < 3:  # the first update has lr 0
            assert all(torch.equal(v, start[k]) for k, v in pair.tstate.params.items())
    assert pair.tstate.updates == 3 and pair.tstate.mini_step == 0
    moved = max((v - start[k]).abs().max().item() for k, v in pair.tstate.params.items())
    assert moved > 1e-4
    blended = max((pair.tstate.ema_params[k] - v).abs().max().item()
                  for k, v in pair.tstate.params.items())
    assert blended > 1e-5  # past step_start_ema the EMA trails the parameters


def test_n_real_mask_and_label_dropout_match_jax():
    pair = _Pair(variant=0, num_classes=4, label_dropout=0.5)
    labels = np.array([1, 3, 0, 2], np.int32)
    jloss, tloss = pair.step(0, labels=labels, n_real=3)
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    pair.assert_same(["params"])
    # the mask really excludes the last sample: the full-batch loss differs
    other = _Pair(variant=0, num_classes=4, label_dropout=0.5)
    _, full = other.step(0, labels=labels)
    assert abs(full - tloss) > 1e-6


def test_variant4_dead_norm1_parameters_still_decay():
    """The reference's variant-4 stages carry ``norm1`` parameters that its
    forward never uses. The JAX parameter tree leaves them out, and so does
    the port's: every parameter of variant 4 receives a gradient, and one
    step agrees with the JAX step."""
    pair = _Pair(variant=4)
    jloss, tloss = pair.step(0)
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    pair.assert_same(["params"])
    assert all(p.grad is not None for p in pair.tmodel.parameters())
    assert not [n for n in pair.tstate.params if n.count(".") == 2 and ".norm1." in n]


def test_parameters_without_gradient_still_decay():
    """A conditional model stepped without labels never touches its label
    embedding. optax's AdamW still decays it (update −lr·wd·p at zero
    gradient); torch skips a parameter whose ``.grad`` is None, so the step
    hands it a zero gradient: table·(1 − lr·wd) on both sides."""
    pair = _Pair(variant=0, num_classes=4)
    before = pair.tstate.params["label_emb.embed.weight"].clone()
    jloss, tloss = pair.step(0)
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    pair.assert_same(["params"])
    assert pair.tmodel.label_emb.embed.weight.grad is None
    torch.testing.assert_close(pair.tstate.params["label_emb.embed.weight"],
                               before * (1.0 - 3e-4 * 1e-2), rtol=0, atol=1e-7)


def test_drawn_timesteps_noise_and_seeding():
    """Without injected draws the step draws from the generator: t in
    [1, noise_steps), and the same (seed, index) gives the same step."""
    _, tcfg = _configs(variant=0)
    diff = Diffusion(noise_steps=STEPS, img_size=SIZE, device="cpu")
    gen = torch.Generator()
    t = diff.sample_timesteps(4000, ttrain.step_generator(gen, 0, 7))
    assert t.min() == 1 and t.max() == STEPS - 1
    batch = torch.from_numpy(synthetic_dataset(n=N, image_size=SIZE, channels=C).images)
    losses = []
    for index in (5, 5, 6):
        model, state = ttrain.create_train_state(tcfg, device="cpu")
        step = ttrain.make_train_step(model, tcfg, diff)
        _, loss = step(state, batch, ttrain.step_generator(gen, tcfg.seed, index))
        losses.append(float(loss))
    assert losses[0] == losses[1] != losses[2]


def test_ema_helper_class():
    ema = ttrain.EMA(0.5)
    p = {"w": torch.ones(2)}
    e = ema.step_ema({"w": torch.zeros(2)}, p, step_start_ema=1)
    assert torch.equal(e["w"], p["w"]) and e["w"] is not p["w"]
    e = ema.step_ema({"w": torch.zeros(2)}, p, step_start_ema=1)
    assert torch.equal(e["w"], torch.full((2,), 0.5))


def test_warmup_cosine_needs_a_horizon():
    _, tcfg = _configs(lr_schedule="warmup_cosine")
    with pytest.raises(ValueError, match="decay horizon"):
        ttrain.lr_at(tcfg, 0)
