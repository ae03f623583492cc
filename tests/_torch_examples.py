"""Shared pieces of the port's example tests (``test_torch_example_*.py``):
load a port example by its path, run it at a cut size on the CPU, carry its
checkpoint into the JAX model, and hand the JAX samplers' noise to the port.
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import torch
from jax import random

from aliasfree_diffusion_models_pytorch_tpu.config import FilterSettings as JFilters
from aliasfree_diffusion_models_pytorch_tpu.config import TrainConfig as JTrainConfig
from aliasfree_diffusion_models_pytorch_tpu.diffusion import Diffusion as JDiffusion
from aliasfree_diffusion_models_pytorch_tpu.train import build_model as j_build_model
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import load_jax_npz, params_to_jax

REPO = pathlib.Path(__file__).resolve().parents[1]
# The cut knobs: image 8, batch 4, 1 epoch, 10 noise steps (DDIM-5).
CUT = ["--device", "cpu", "--epochs", "1", "--noise-steps", "10", "--ddim-steps", "5",
       "--image-size", "8", "--batch-size", "4"]


def load_example(name: str):
    """The module ``examples/<name>.py``, imported by its path."""
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_side(config, checkpoint: str):
    """The JAX model of ``config`` with the port checkpoint's weights
    (``params_to_jax``), its params, and the JAX ``Diffusion``."""
    fields = {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}
    fields["filters"] = JFilters(**dataclasses.asdict(config.filters))
    jconfig = JTrainConfig(**fields)
    params = {"params": params_to_jax(load_jax_npz(checkpoint))}
    diffusion = JDiffusion(noise_steps=config.noise_steps, img_size=config.image_size)
    return j_build_model(jconfig), params, diffusion


def jax_noise(key):
    """``noise_fn`` for the port's samplers: the draws a JAX sampler makes
    from ``key`` (``tests/test_torch_diffusion.py``): step 0 the initial
    latent, then one per reverse step, for whatever shape the call asks."""
    chains: dict = {}

    def noise_fn(shape, step):
        state = chains.setdefault(tuple(shape), {"draws": []})
        if not state["draws"]:
            state["key"], xkey = random.split(key)
            state["draws"].append(np.array(random.normal(xkey, shape)))
        while len(state["draws"]) <= step:
            state["key"], nkey = random.split(state["key"])
            state["draws"].append(np.array(random.normal(nkey, shape)))
        return torch.from_numpy(state["draws"][step])

    return noise_fn


def close_uint8(out, ref):
    """At most ±1, on at most 2% of the values (``tests/test_torch_diffusion.py``)."""
    out, ref = np.asarray(out).astype(np.int16), np.asarray(ref).astype(np.int16)
    assert out.shape == ref.shape
    diff = np.abs(out - ref)
    assert diff.max() <= 1, diff.max()
    assert np.mean(diff > 0) <= 0.02, np.mean(diff > 0)
