"""The train step's static buffers and branches against the JAX train step.

On the card the step runs as CUDA graphs, one per branch that the host
chooses: the accumulation window's position (accumulate, or update) and, on
an update, whether the EMA copies or blends. On the CPU the same step runs
directly. These tests follow the branches the step took and hold the result
against the JAX step, which jits all of them into one program: the same
weights, batch, timesteps, noise and label mask on both sides (the per-step
JAX key split as ``tests/test_torch_train.py`` splits it), f32, image 8.

Tolerances, as in ``tests/test_torch_train.py``: loss rtol 2e-5, parameters
and EMA atol 2e-6 with at most 0.1% of a tensor's entries (two in a small
tensor) allowed up to the bound of 2·lr per update, and the key bias held to
that bound only (its true gradient is zero).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from aliasfree_diffusion_models_pytorch_tpu.config import TrainConfig as JTrainConfig
from aliasfree_diffusion_models_pytorch_tpu.data import synthetic_dataset
from aliasfree_diffusion_models_pytorch_tpu.diffusion import Diffusion as JDiffusion
from aliasfree_diffusion_models_pytorch_tpu.train import create_train_state as j_create_train_state
from aliasfree_diffusion_models_pytorch_tpu.train import make_train_step as j_make_train_step
from aliasfree_diffusion_models_pytorch_tpu_torch import train as ttrain
from aliasfree_diffusion_models_pytorch_tpu_torch.config import TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import params_from_jax

LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-6
N, SIZE, C, STEPS = 4, 8, 3, 50
KNOBS = dict(num_classes=4, label_dropout=0.5, use_ema=True, ema_beta=0.9, grad_accum=2,
             grad_clip=0.05, lr_schedule="warmup_cosine", warmup_steps=1, lr_total_steps=4,
             lr=1e-3)


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)  # copies: the jitted step donates


class _Pair:
    """A JAX trainer and the port's, from the same weights, both started at
    micro-batch ``start_step``."""

    def __init__(self, start_step=0, **kw):
        base = dict(run_name="t", epochs=1, batch_size=N, image_size=SIZE, base_width=8,
                    image_channels=C, noise_steps=STEPS, variant=0, seed=0, time_dim=32, **kw)
        self.jcfg, self.tcfg = JTrainConfig(**base), TrainConfig(**base)
        jmodel, self.jstate = j_create_train_state(self.jcfg, random.key(0))
        self.jstate = dataclasses.replace(self.jstate, step=jnp.asarray(start_step, jnp.int32))
        self.jdiff = JDiffusion(noise_steps=STEPS, img_size=SIZE)
        self.jstep = j_make_train_step(jmodel, self.jcfg, self.jdiff)
        self.tmodel, self.tstate = ttrain.create_train_state(
            self.tcfg, device="cpu", state_dict=params_from_jax(_numpy_tree(self.jstate.params)))
        self.tstate.step = start_step
        self.tstep = ttrain.make_train_step(
            self.tmodel, self.tcfg, Diffusion(noise_steps=STEPS, img_size=SIZE, device="cpu"))
        self.batch = synthetic_dataset(n=N, image_size=SIZE, channels=C, seed=3).images

    def step(self, i, n=N, labels=None, n_real=None):
        batch = self.batch[:n]
        key = random.fold_in(random.key(1), i)
        tkey, nkey, dkey = random.split(key, 3)
        t = np.array(self.jdiff.sample_timesteps(tkey, n))
        noise = np.array(random.normal(nkey, batch.shape, jnp.float32))
        keep = None
        if self.jcfg.label_dropout > 0.0:
            keep = np.array(random.uniform(dkey, (n,)) >= self.jcfg.label_dropout, np.float32)
        self.jstate, jloss = self.jstep(
            self.jstate, jnp.asarray(batch), key,
            None if labels is None else jnp.asarray(labels),
            None if n_real is None else jnp.asarray(n_real, jnp.int32))
        self.tstate, tloss = self.tstep(
            self.tstate, torch.from_numpy(batch), None,
            None if labels is None else torch.from_numpy(labels).long(), n_real,
            t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise),
            keep=None if keep is None else torch.from_numpy(keep))
        return float(jloss), float(tloss)

    def assert_same(self, fields=("params", "ema_params")):
        bound = 2.0 * self.tcfg.lr * max(1, self.tstate.updates)
        for field in fields:
            expect = params_from_jax(_numpy_tree(getattr(self.jstate, field)))
            for name, value in getattr(self.tstate, field).items():
                a, e = value.numpy(), expect[name].numpy()
                if name.endswith(".qkv.bias"):
                    third = len(a) // 3
                    key_bias = slice(third, 2 * third)  # zero true gradient
                    assert np.abs(a[key_bias] - e[key_bias]).max() <= bound, name
                    a, e = np.delete(a, key_bias), np.delete(e, key_bias)
                err = np.abs(a - e)
                assert err.max() <= bound, (field, name, err.max())
                assert int((err > PARAM_ATOL).sum()) <= max(2, 1e-3 * err.size), (field, name)
        assert self.tstate.step == int(self.jstate.step)


@pytest.fixture
def branches(monkeypatch):
    """(batch size, variant) of every step the port ran, and the lr each
    update was given."""
    ran, lrs = [], []
    plain_step, plain_set_lr = ttrain._StepInputs.step, ttrain._set_lr

    def step(self, variant):
        ran.append((self.batch.shape[0], variant))
        plain_step(self, variant)

    def set_lr(optimizer, value):
        lrs.append(value)
        plain_set_lr(optimizer, value)

    monkeypatch.setattr(ttrain._StepInputs, "step", step)
    monkeypatch.setattr(ttrain, "_set_lr", set_lr)
    return ran, lrs


def test_branches_ema_accumulation_clip_schedule_and_label_mask_match_jax(branches):
    """Started four micro-batches before ``STEP_START_EMA``, accumulation 2:
    updates on micro-batches 1, 3, 5 and 7, the EMA copying on the first two
    and blending on the others, at lr 0, lr, 0.75·lr and 0.25·lr; labels with
    CFG dropout, the last sample masked out by ``n_real``."""
    ran, lrs = branches
    pair = _Pair(start_step=ttrain.STEP_START_EMA - 4, **KNOBS)
    labels = np.array([1, 3, 0, 2], np.int32)
    for i in range(8):
        jloss, tloss = pair.step(i, labels=labels, n_real=3)
        np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
        pair.assert_same()
    assert ran == [(N, (0, False)), (N, (1, True))] * 2 + [(N, (0, False)), (N, (1, False))] * 2
    assert lrs == pytest.approx([0.0, 1e-3, 0.75e-3, 0.25e-3])
    assert pair.tstate.updates == 4 and pair.tstate.mini_step == 0
    # the blend left the EMA behind the parameters
    assert max((pair.tstate.ema_params[k] - v).abs().max().item()
               for k, v in pair.tstate.params.items()) > 1e-6


def test_short_last_batch_takes_its_own_buffers(branches):
    ran, _ = branches
    pair = _Pair()
    for i, n in enumerate((N, N - 1, N, N - 1)):
        jloss, tloss = pair.step(i, n=n)
        np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
        pair.assert_same(["params"])
    assert [r[0] for r in ran] == [N, N - 1, N, N - 1]


def test_drawn_inputs_follow_the_callers_generator():
    """Without handed-in draws the step draws t, the noise and the keep-mask
    from its own generator, which takes the caller's state and gives it
    back: the caller's generator ends where drawing them itself would leave
    it, and the same (seed, index) gives the same step."""
    base = dict(run_name="t", epochs=1, batch_size=N, image_size=SIZE, base_width=8,
                image_channels=C, noise_steps=STEPS, variant=0, seed=0, time_dim=32,
                num_classes=4, label_dropout=0.5)
    cfg = TrainConfig(**base)
    batch = torch.from_numpy(synthetic_dataset(n=N, image_size=SIZE, channels=C).images)
    labels = torch.tensor([0, 1, 2, 3])
    losses = []
    for index in (5, 5):
        model, state = ttrain.create_train_state(cfg, device="cpu")
        step = ttrain.make_train_step(model, cfg, Diffusion(noise_steps=STEPS, img_size=SIZE,
                                                            device="cpu"))
        gen = torch.Generator()
        _, loss = step(state, batch, ttrain.step_generator(gen, cfg.seed, index), labels)
        losses.append(float(loss))
    ref = ttrain.step_generator(torch.Generator(), cfg.seed, 5)
    torch.randint(1, STEPS, (N,), generator=ref)
    torch.randn(batch.shape, generator=ref)
    torch.rand((N,), generator=ref)
    assert torch.equal(gen.get_state(), ref.get_state())
    assert losses[0] == losses[1] and math.isfinite(losses[0])


def test_cpu_optimizer_is_the_plain_adamw():
    """PyTorch refuses a capturable AdamW on the CPU: the CPU keeps the plain
    one with a float lr, which the step sets before each update."""
    base = dict(run_name="t", epochs=1, batch_size=N, image_size=SIZE, base_width=8,
                image_channels=C, noise_steps=STEPS, variant=0, seed=0, time_dim=32)
    _, state = ttrain.create_train_state(TrainConfig(**base), device="cpu")
    group = state.optimizer.param_groups[0]
    assert not group["capturable"] and isinstance(group["lr"], float)
    ttrain._set_lr(state.optimizer, 1.5e-4)
    assert group["lr"] == 1.5e-4
