"""Optimizer state in the ``.npz`` checkpoint, across the two packages, and
exact resume on the CPU.

* A checkpoint the port writes with ``checkpoint_opt_state`` restores in the
  JAX package's ``restore_checkpoint(path, template)`` (npz backend) under the
  template of its ``make_optimizer`` state, for plain AdamW, with
  ``grad_clip`` and with ``grad_accum=2`` (and the warmup-cosine schedule's
  count); one the JAX package writes loads into the port's AdamW. Arrays are
  only transposed on the way: bit-equal.
* f32 training on the CPU for 2 epochs equals 1 epoch and a resumed 1 more:
  parameters, EMA and every optimizer array within 1e-6 of each tensor's
  largest entry (the CPU's kernels are deterministic, so it is in fact
  bit-equal).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu.config import TrainConfig as JTrainConfig
from aliasfree_diffusion_models_pytorch_tpu.train import create_train_state as j_create_state
from aliasfree_diffusion_models_pytorch_tpu.utils import checkpoint as jckpt
from aliasfree_diffusion_models_pytorch_tpu_torch import cli
from aliasfree_diffusion_models_pytorch_tpu_torch import train as train_mod
from aliasfree_diffusion_models_pytorch_tpu_torch.config import TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import checkpoint as tckpt
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import weights

BASE = dict(image_size=8, base_width=4, image_channels=1, variant=0, time_dim=16,
            batch_size=2, noise_steps=20, checkpoint_opt_state=True)
FORMS = {"adamw": {}, "clip": dict(grad_clip=0.5), "accum2": dict(grad_accum=2),
         "accum2_clip_cosine": dict(grad_accum=2, grad_clip=0.5, lr_schedule="warmup_cosine",
                                    warmup_steps=1, lr_total_steps=10)}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers run at once: two threads each are enough."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _port_state(form, steps):
    """A port TrainState after ``steps`` micro-batches of random data."""
    config = TrainConfig(**BASE, **FORMS[form])
    model, state = train_mod.create_train_state(config, device="cpu")
    step = train_mod.make_train_step(model, config, Diffusion(noise_steps=20, img_size=8,
                                                               device="cpu"))
    rng = np.random.default_rng(0)
    for i in range(steps):
        batch = torch.from_numpy(rng.uniform(-1, 1, (2, 8, 8, 1)).astype(np.float32))
        step(state, batch, torch.Generator().manual_seed(i))
    return config, model, state


def _flat(tree):
    return {"/".join(getattr(p, "key", None) or str(getattr(p, "idx", p)) for p in path):
            np.asarray(leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("form", list(FORMS))
def test_port_opt_state_restores_in_the_jax_package(tmp_path, form):
    config, _, state = _port_state(form, steps=3)  # accum2: one update, one open window
    path = str(tmp_path / "ckpt_MNIST_0")
    tckpt.save_checkpoint(path, state.params, state.ema_params, state.step,
                          tckpt.opt_state_arrays(config, state))
    _, jstate = j_create_state(JTrainConfig(**BASE, **FORMS[form]), jax.random.key(0))
    template = {"params": jstate.params, "ema_params": jstate.ema_params,
                "step": jstate.step, "opt_state": jstate.opt_state}
    restored = jckpt.restore_checkpoint(path, template)
    assert jax.tree.structure(restored) == jax.tree.structure(template)
    got = _flat(restored["opt_state"])
    assert set(got) == set(_flat(jstate.opt_state))
    updates = 1 if config.grad_accum == 2 else 3
    inner = ".inner_opt_state/" if config.grad_accum == 2 else ""
    chain = inner + ("1/" if config.grad_clip else "")
    assert int(got[f"{chain}0/.count"]) == updates
    names = list(state.params)
    for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        expect = weights._flatten(weights.params_to_jax(
            {n: state.optimizer.state[state.params[n]][key] for n in names}))
        for leaf, value in expect.items():
            np.testing.assert_array_equal(got[f"{chain}0/.{moment}/params/{leaf}"], value)
    if config.grad_accum == 2:
        assert int(got[".mini_step"]) == 1 and int(got[".gradient_step"]) == 1
        acc = weights._flatten(weights.params_to_jax(dict(zip(names, state.grad_acc))))
        for leaf, value in acc.items():
            np.testing.assert_array_equal(got[f".acc_grads/params/{leaf}"], value)
    if config.lr_schedule != "constant":
        assert int(got[f"{chain}2/.count"]) == updates


@pytest.mark.parametrize("form", list(FORMS))
def test_jax_opt_state_loads_into_the_port(tmp_path, form):
    _, jstate = j_create_state(JTrainConfig(**BASE, **FORMS[form]), jax.random.key(1))
    rng = np.random.default_rng(2)
    # Every leaf of the optax state filled with its own numbers.
    opt_state = jax.tree.map(
        lambda a: (np.asarray(7, a.dtype) if a.ndim == 0
                   else rng.standard_normal(a.shape).astype(a.dtype)), jstate.opt_state)
    if FORMS[form].get("grad_accum"):
        opt_state = opt_state._replace(mini_step=np.asarray(1, np.int32))
    jstate = jstate.__class__(jstate.params, opt_state, jstate.ema_params, np.int32(15))
    path = str(tmp_path / "ckpt_MNIST_0")
    jckpt.save_checkpoint(path, jstate, save_opt_state=True, backend="npz")

    config = TrainConfig(**BASE, **FORMS[form])
    _, state = train_mod.create_train_state(
        config, device="cpu", state_dict=weights.params_from_jax(jax.tree.map(np.asarray,
                                                                              jstate.params)))
    restored = tckpt.restore_checkpoint(path)
    assert restored["step"] == 15
    tckpt.load_opt_state(config, state, restored["opt_state"])
    assert state.updates == 7
    flat = _flat(opt_state)
    chain = (".inner_opt_state/" if config.grad_accum == 2 else "") + (
        "1/" if config.grad_clip else "")
    for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        expect = weights.state_from_flat(flat, f"{chain}0/.{moment}/")
        for name, p in state.params.items():
            assert torch.equal(state.optimizer.state[p][key], expect[name]), (moment, name)
            assert float(state.optimizer.state[p]["step"]) == 7.0
    if config.grad_accum == 2:
        assert state.mini_step == 1
        acc = weights.state_from_flat(flat, ".acc_grads/")
        assert all(torch.equal(b, acc[n]) for b, n in zip(state.grad_acc, state.params))
    # A checkpoint of another optimizer form is refused, not half read.
    other = TrainConfig(**BASE, grad_clip=None if config.grad_clip else 1.0)
    with pytest.raises(KeyError, match="optimizer form"):
        tckpt.load_opt_state(other, state, restored["opt_state"])


TINY = ["train", "--device", "cpu", "--variant", "3", "--f-kernel", "3", "--f-beta", "2",
        "--image-size", "8", "--image-channels", "3", "--base-width", "8", "--batch-size", "128",
        "--noise-steps", "20", "--compute-dtype", "float32", "--image-gen-per-epoch", "0",
        "--dataset", "CIFAR10", "--checkpoint-opt-state", "--use-ema"]
CKPT = os.path.join("models", "DDPM_Uncondtional_CIFAR10_3", "ckpt_CIFAR10_3.npz")


@pytest.mark.parametrize("extra,first", [
    ([], []),
    (["--grad-accum", "3", "--grad-clip", "1.0"], []),
    # The first call is told the whole run's horizon (the straight run derives
    # 8 updates from its 2 epochs); the resumed call derives 4 from its own
    # epoch and must adopt the 8 stored beside the checkpoint instead.
    (["--lr-schedule", "warmup_cosine", "--warmup-steps", "2"], ["--lr-total-steps", "8"]),
], ids=["adamw", "accum3_clip", "warmup_cosine"])
def test_two_epochs_equal_one_and_a_resumed_one(tmp_path, extra, first):
    straight, split = str(tmp_path / "a"), str(tmp_path / "b")
    assert cli.main([*TINY, *extra, "--epochs", "2", "--root", straight]) == 0
    assert cli.main([*TINY, *extra, *first, "--epochs", "1", "--root", split]) == 0
    assert cli.main([*TINY, *extra, "--epochs", "1", "--root", split, "--resume"]) == 0
    with np.load(os.path.join(straight, CKPT)) as a, np.load(os.path.join(split, CKPT)) as b:
        assert set(a.files) == set(b.files)
        assert int(a["step"]) == 8  # 512 synthetic images at batch 128, two epochs
        assert any(k.startswith("opt_state/") for k in a.files)
        for key in a.files:
            scale = max(float(np.abs(a[key]).max()), 1e-30)
            assert float(np.abs(a[key] - b[key]).max()) <= 1e-6 * scale, key


def test_a_resumed_run_numbers_its_epochs_on(tmp_path):
    """The resumed call's epoch is the checkpoint's: its sample grid is
    ``1.jpg`` beside the first call's ``0.jpg``, which it leaves as it was,
    and its run header names the epoch it starts at."""
    root = str(tmp_path)
    flags = [*TINY, "--image-gen-per-epoch", "2", "--epochs", "1", "--root", root]
    results = tmp_path / "results" / "DDPM_Uncondtional_CIFAR10_3"
    assert cli.main(flags) == 0
    first = (results / "0.jpg").read_bytes()
    assert sorted(p.name for p in results.iterdir()) == ["0.jpg"]
    assert cli.main([*flags, "--resume"]) == 0
    assert sorted(p.name for p in results.iterdir()) == ["0.jpg", "1.jpg"]
    assert (results / "0.jpg").read_bytes() == first
    runs = tmp_path / "runs" / "DDPM_Uncondtional_CIFAR10_3" / "metrics.jsonl"
    headers = [json.loads(line) for line in runs.read_text().splitlines()
               if "run_header" in json.loads(line)]
    assert [(h["resumed_step"], h["first_epoch"]) for h in headers] == [(0, 0), (4, 1)]
