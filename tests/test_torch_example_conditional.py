"""``examples/conditional_cfg_torch.py`` against the JAX package's calls of
``examples/conditional_cfg.py``, on the CPU.

The port example's ``main`` runs with the cut knobs (image 8, batch 4, 1
epoch, 10 noise steps, DDIM-5, one image of each of the ten classes) and
writes its checkpoint and ``classes.png``. Those weights go into the JAX model
(``params_to_jax``); the example's own sampling stage (``sample_stage``:
guided DDIM, labels in class order, ``cfg_scale=3.0``) then runs with the
noise that the JAX script's ``random.key(0)`` draws, handed in through
``noise_fn``, against the JAX script's ``sample_ddim`` call with the same
labels and scale.

Tolerance: the images in uint8 within ±1 on at most 2% of the values (both
truncate ``(x+1)/2·255``, so an f32 difference of ~1e-5 flips a value on a
truncation edge, ``tests/test_torch_diffusion.py``).
"""

import numpy as np
import pytest
import torch
from jax import random

import _torch_examples as ex
from aliasfree_diffusion_models_pytorch_tpu_torch.tasks import _load_model_params

PER_CLASS = 1


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several worker processes at once; two threads each keep
    their OpenMP barriers from spinning against each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The example's ``main`` at the cut size, under a root of its own."""
    root = tmp_path_factory.mktemp("cond_example")
    argv = [*ex.CUT, "--root", str(root), "--per-class", str(PER_CLASS)]
    c = ex.load_example("conditional_cfg_torch")
    return dict(c=c, result=c.main(argv), config=c.build_config(c.parse_args(argv)), root=root)


def test_main_trains_samples_and_writes(run):
    result, root = run["result"], run["root"]
    assert len(result["losses"]) == 1 and np.isfinite(result["losses"][0])
    assert result["grid"] == str(root / "classes.png") and (root / "classes.png").exists()
    assert (root / "models" / "DDPM_conditional_example" / "ckpt_synth_3.npz").exists()
    assert result["images"].shape == (10 * PER_CLASS, 8, 8, 1)
    assert result["images"].dtype == np.uint8
    assert run["config"].num_classes == 10 and run["config"].label_dropout == 0.1


def test_cfg_sampling_stage_matches_the_jax_call(run):
    config, result = run["config"], run["result"]
    jmodel, params, jd = ex.jax_side(config, result["checkpoint"])
    labels = np.repeat(np.arange(10, dtype=np.int32), PER_CLASS)
    key = random.key(0)
    ref = jd.sample_ddim(jmodel.apply, n=len(labels), image_channels=1, key=key, steps=5,
                         labels=labels, cfg_scale=3.0, params=params)
    model = _load_model_params(config, str(run["root"]), "cpu")
    ours = run["c"].sample_stage(config, model, "cpu", PER_CLASS, 5,
                                 noise_fn=ex.jax_noise(key))
    ex.close_uint8(ours, ref)
    # the example's own run drew from a generator seeded 0: the same call again
    again = run["c"].sample_stage(config, model, "cpu", PER_CLASS, 5)
    np.testing.assert_array_equal(again, result["images"])
