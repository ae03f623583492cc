"""The port's ``train()`` takes the JAX ``train()``'s keywords, with its defaults,
and each does what it does there.

* the names and defaults of the JAX ``train``'s signature are a subset of the
  port's (``mesh`` is the port's own ``Mesh`` type, with the same default);
* at a tiny size on the CPU (Config A, image 8, base width 8, 12 rows at
  batch 4: three steps an epoch, two epochs): ``sample_each_epoch=False``
  with ``image_gen_n > 0`` writes no ``results/<run>/*.jpg``;
  ``checkpoint_each_epoch=False`` writes no ``ckpt_*.npz``; ``log_every=2``
  writes as many loss records to ``metrics.jsonl``, at the same steps, as the
  JAX ``train`` writes for the same loader; ``prefetch=False`` gives losses
  bit-equal to ``prefetch=True`` (the same batches in the same order);
  ``profile_steps=(0, 1)`` writes the trace.
"""

import inspect
import json
import os

import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu.config import TrainConfig as JTrainConfig
from aliasfree_diffusion_models_pytorch_tpu.data import Dataloader as JDataloader
from aliasfree_diffusion_models_pytorch_tpu.data import synthetic_dataset as j_synthetic_dataset
from aliasfree_diffusion_models_pytorch_tpu.train import train as j_train
from aliasfree_diffusion_models_pytorch_tpu_torch import train as ttrain
from aliasfree_diffusion_models_pytorch_tpu_torch.config import TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.data import Dataloader, synthetic_dataset

ROWS, LOG_EVERY = 12, 2
BASE = dict(run_name="kw", epochs=2, batch_size=4, image_size=8, base_width=8, image_channels=1,
            noise_steps=10, variant=0, seed=0, time_dim=32, image_gen_n=1)
RUNS = {
    "defaults": {},
    "prefetch_off": dict(prefetch=False),
    "off": dict(sample_each_epoch=False, checkpoint_each_epoch=False, profile_steps=(0, 1)),
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several worker processes at once; two threads each keep
    their OpenMP barriers from spinning against each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _loss_steps(root: str, config) -> list[int]:
    with open(os.path.join(config.runs_dir(root), "metrics.jsonl")) as f:
        return [r["step"] for r in map(json.loads, f) if "loss" in r]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    config = TrainConfig(**BASE)
    out = {}
    for name, kw in RUNS.items():
        root = str(tmp_path_factory.mktemp(name))
        profile_dir = str(tmp_path_factory.mktemp(name + "_profile"))
        loader = Dataloader(synthetic_dataset(n=ROWS, image_size=8, channels=1, seed=5),
                            batch_size=4, seed=0)
        losses = ttrain.train(config, loader, root=root, device="cpu", log_every=LOG_EVERY,
                              profile_dir=profile_dir, **kw)
        out[name] = dict(root=root, profile_dir=profile_dir, losses=losses)
    return config, out


def test_signature_holds_the_jax_keywords_and_defaults():
    jax_params = inspect.signature(j_train).parameters
    port_params = inspect.signature(ttrain.train).parameters
    for name, param in jax_params.items():
        assert name in port_params, name
        assert port_params[name].kind == param.kind, name
        assert port_params[name].default == param.default, name
        if name != "mesh":  # the port's own Mesh type
            assert port_params[name].annotation == param.annotation, name
    assert set(port_params) - set(jax_params) == {"device"}


@pytest.mark.parametrize("name,expect", [("defaults", True), ("prefetch_off", True),
                                         ("off", False)])
def test_sample_each_epoch_gates_the_epoch_grids(runs, name, expect):
    config, out = runs
    grids = sorted(os.listdir(config.results_dir(out[name]["root"])))
    assert grids == (["0.jpg", "1.jpg"] if expect else [])


@pytest.mark.parametrize("name,expect", [("defaults", True), ("off", False)])
def test_checkpoint_each_epoch_gates_the_checkpoint(runs, name, expect):
    config, out = runs
    files = os.listdir(config.model_dir(out[name]["root"]))
    assert ("ckpt_MNIST_0.npz" in files) == expect
    assert "config.json" in files


def test_prefetch_off_gives_the_same_losses(runs):
    _, out = runs
    assert len(out["defaults"]["losses"]) == 2
    assert out["prefetch_off"]["losses"] == out["defaults"]["losses"]


def test_profile_steps_window_writes_the_trace(runs):
    _, out = runs
    assert os.listdir(out["off"]["profile_dir"]) == [f"trace_{BASE['run_name']}.json"]
    # the default window (10, 20) lies past the run's six steps: no trace
    assert os.listdir(out["defaults"]["profile_dir"]) == []


def test_log_every_writes_the_jax_trainers_loss_records(runs, tmp_path):
    config, out = runs
    jconfig = JTrainConfig(**BASE)
    loader = JDataloader(j_synthetic_dataset(n=ROWS, image_size=8, channels=1, seed=5),
                         batch_size=4, seed=0)
    root = str(tmp_path)
    j_train(jconfig, loader, root=root, sample_each_epoch=False, checkpoint_each_epoch=False,
            prefetch=False, log_every=LOG_EVERY)
    expect = _loss_steps(root, jconfig)
    assert expect == [2, 4, 6]
    for name in RUNS:
        assert _loss_steps(out[name]["root"], config) == expect, name
