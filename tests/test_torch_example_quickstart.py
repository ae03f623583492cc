"""``examples/quickstart_torch.py`` against the JAX package's calls of
``examples/quickstart.py``, on the CPU.

The port example's ``main`` runs with the cut knobs (image 8, batch 4, 1
epoch, 10 noise steps, DDIM-5, 8 images a DDPM and a DDIM call) and writes
its checkpoint. Those weights go into the JAX model (``params_to_jax``); the
example's own sampling stage (``sample_stage``) then runs with the noise that
the JAX script's key draws, handed in through ``noise_fn``, against the JAX
script's three calls (``Diffusion.sample``, ``sample_ddim``, the rotated
``sample`` at θ = 45°). ``calculate_metrics`` runs on the same uint8 arrays in
both packages.

Tolerances: the samples in uint8 within ±1 on at most 2% of the values (both
truncate ``(x+1)/2·255``, so an f32 difference of ~1e-5 flips a value on a
truncation edge, ``tests/test_torch_diffusion.py``); the metric dict with
equal keys and values within 5e-5 relative, 1e-9 absolute
(``tests/test_torch_eval.py``).
"""

import os

import numpy as np
import pytest
import torch
from jax import random

import _torch_examples as ex
from aliasfree_diffusion_models_pytorch_tpu import eval as jeval
from aliasfree_diffusion_models_pytorch_tpu_torch import eval as teval
from aliasfree_diffusion_models_pytorch_tpu_torch.tasks import _load_model_params

N = 8


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
    """The example's ``main`` at the cut size, in a directory of its own."""
    work = tmp_path_factory.mktemp("quickstart")
    q = ex.load_example("quickstart_torch")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        result = q.main([*ex.CUT, "--root", str(work), "--n", str(N)])
    finally:
        os.chdir(cwd)
    config = q.build_config(q.parse_args([*ex.CUT, "--n", str(N)]))
    return dict(q=q, result=result, config=config, work=work)


def test_main_trains_samples_and_writes(run):
    result = run["result"]
    assert len(result["losses"]) == 1 and np.isfinite(result["losses"][0])
    assert (run["work"] / result["grid"]).exists()
    assert (run["work"] / "models" / "DDPM_Uncondtional_quickstart_3"
            / "ckpt_quickstart_3.npz").exists()
    shapes = {k: (v.shape, v.dtype) for k, v in result["samples"].items()}
    assert shapes == {"final": ((N, 8, 8, 1), np.uint8), "fast": ((N, 8, 8, 1), np.uint8),
                      "rotated": ((N // 2, 8, 8, 1), np.uint8)}
    assert all(np.isfinite(v) for v in result["metrics"].values() if isinstance(v, float))


@pytest.fixture(scope="module")
def samples(run):
    """The JAX script's three sampler calls on the carried-over weights, and
    the example's sampling stage with the same noise."""
    config, result = run["config"], run["result"]
    jmodel, params, jd = ex.jax_side(config, result["checkpoint"])
    key = random.key(config.seed)
    final, _ = jd.sample(jmodel.apply, n=N, image_channels=1, key=key, params=params)
    fast = jd.sample_ddim(jmodel.apply, n=N, image_channels=1, key=key, steps=5, params=params)
    rotated, _ = jd.sample(jmodel.apply, n=N // 2, image_channels=1, key=key, theta=45.0,
                           params=params)
    model = _load_model_params(config, str(run["work"]), "cpu")
    ours = run["q"].sample_stage(config, model, "cpu", N, 5, noise_fn=ex.jax_noise(key))
    return ours, {"final": final, "fast": fast, "rotated": rotated}


@pytest.mark.parametrize("call", ["final", "fast", "rotated"])
def test_sampling_stage_matches_the_jax_calls(samples, call):
    """DDPM, DDIM and the rotated DDPM of the example's stage against the JAX
    script's calls."""
    ours, theirs = samples
    ex.close_uint8(ours[call], theirs[call])


def test_metrics_stage_matches_the_jax_package(run):
    """The example's metric call on its own samples against the JAX
    package's on the same uint8 arrays."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.data import get_data

    config, result = run["config"], run["result"]
    _, dataset = get_data(config.dataset, None, config.image_size, config.batch_size,
                          image_channels=1, seed=config.seed, synthetic_fallback=True)
    ref = np.clip((dataset.images[:256] + 1) / 2 * 255, 0, 255).astype(np.uint8)
    ours = result["metrics"]
    assert ours == teval.calculate_metrics(result["samples"]["final"], ref,
                                           teval.RandomFeatures(device="cpu"))
    theirs = jeval.calculate_metrics(result["samples"]["final"], ref, jeval.RandomFeatures())
    assert list(ours) == list(theirs)
    for k, value in theirs.items():
        if k != "feature_space":
            assert ours[k] == pytest.approx(value, rel=5e-5, abs=1e-9), k
