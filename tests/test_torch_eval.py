"""The port's evaluation stack against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages:

* IS, FID, KID and their helpers are numpy float64 on both sides: bit-equal
  on equal features;
* ``utils/jax_random.py`` against ``jax.random``: keys, splits and bits equal;
  normals within four f32 ulps of the largest value (the erf⁻¹ polynomial is
  the same, evaluated by numpy instead of XLA);
* ``RandomFeatures`` against the JAX class for 1 and 3 channels: weights as
  above; features within 2e-6 and probabilities within 2e-5 absolute (three
  f32 convolutions in another summation order, a tanh-form GELU from another
  libm, then a softmax at temperature 5 over standardised features);
* the Inception-v3 forward against ``inception_forward`` with the same seeded
  state dict at batch 2: 2e-5 of the largest entry (94 f32 convolutions in
  another summation order);
* the ``.npz`` weight layout read and written across the two packages;
* ``calculate_metrics``: equal keys, values within 5e-5 relative (float64
  metrics of f32 features that differ by 2e-7; a few dozen samples leave the
  feature covariances singular, and the matrix square root amplifies the
  difference in their null space; measured 4e-6).
"""

import numpy as np
import pytest
import torch
from jax import random

import jax.numpy as jnp

from aliasfree_diffusion_models_pytorch_tpu import eval as jeval
from aliasfree_diffusion_models_pytorch_tpu import eval_inception as jinc
from aliasfree_diffusion_models_pytorch_tpu_torch import eval as teval
from aliasfree_diffusion_models_pytorch_tpu_torch import eval_inception as tinc
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import jax_random


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several worker processes at once. A worker whose
    convolutions take every core makes the others' OpenMP threads spin at
    their barriers, and all of them crawl; two threads are enough here."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _features(n, d, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * rng.uniform(0.5, 2.0, d) + shift).astype(np.float32)


def _images(n, size, channels, seed):
    """uint8 images with structure: smooth blobs plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    freq = rng.uniform(1, 6, (n, 1, 1, channels))
    phase = rng.uniform(0, 6.28, (n, 1, 1, channels))
    img = np.sin(freq * 6.28 * yy[None, :, :, None] + phase) * np.cos(freq * 3 * xx[None, :, :, None])
    img = img + 0.3 * rng.standard_normal(img.shape)
    return np.clip((img + 1) * 127.5, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Metric math: bit-equal
# ---------------------------------------------------------------------------


def test_inception_score_is_bit_equal():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((103, 17)) * 3
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    assert teval.inception_score(probs) == jeval.inception_score(probs)
    assert teval.inception_score(probs, splits=4) == jeval.inception_score(probs, splits=4)
    assert teval.inception_score(probs[:5]) == jeval.inception_score(probs[:5])  # empty splits


def test_fid_is_bit_equal():
    f1, f2 = _features(80, 24, 1), _features(64, 24, 2, shift=0.3)
    assert teval.fid(f1, f2) == jeval.fid(f1, f2)
    assert teval.fid(f1[:10], f2[:12]) == jeval.fid(f1[:10], f2[:12])  # singular covariances
    assert abs(teval.fid(f1, f1)) < 1e-8


def test_kid_is_bit_equal():
    f1, f2 = _features(60, 16, 3), _features(50, 16, 4, shift=0.2)
    kw = dict(subsets=7, subset_size=20, seed=5)
    assert teval.kid(f1, f2, **kw) == jeval.kid(f1, f2, **kw)
    assert teval.kid(f1, f2) == jeval.kid(f1, f2)


def test_metric_helpers_are_bit_equal():
    a, b = _features(30, 8, 6).astype(np.float64), _features(30, 8, 7).astype(np.float64)
    s1, s2 = np.cov(a, rowvar=False), np.cov(b, rowvar=False)
    assert teval._sqrtm_product(s1, s2) == jeval._sqrtm_product(s1, s2)
    np.testing.assert_array_equal(teval._poly_kernel(a, b), jeval._poly_kernel(a, b))


# ---------------------------------------------------------------------------
# jax.random in numpy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 7])
def test_threefry_keys_splits_and_bits_equal_jax(seed):
    key = random.key(seed)
    np.testing.assert_array_equal(jax_random.key(seed), np.asarray(random.key_data(key)))
    ours = jax_random.split(jax_random.key(seed), 4)
    np.testing.assert_array_equal(ours, np.asarray(random.key_data(random.split(key, 4))))
    for i, shape in enumerate([(5,), (3, 3, 1, 64), (7, 11)]):
        np.testing.assert_array_equal(
            jax_random.bits(ours[i], shape),
            np.asarray(random.bits(random.split(key, 4)[i], shape, "uint32")))


@pytest.mark.parametrize("c_in", [1, 3])
def test_normal_matches_jax_random(c_in):
    keys = random.split(random.key(0), 4)
    ours = jax_random.split(jax_random.key(0), 4)
    for i, shape in enumerate([(3, 3, c_in, 64), (3, 3, 64, 128), (3, 3, 128, 128), (256, 128)]):
        got, ref = jax_random.normal(ours[i], shape), np.asarray(random.normal(keys[i], shape))
        assert got.dtype == np.float32 and got.shape == shape
        ulp = np.spacing(np.abs(ref).max())
        assert np.abs(got - ref).max() <= 4 * ulp
        assert np.mean(got == ref) > 0.9


def test_key_refuses_seeds_jax_would_truncate():
    with pytest.raises(ValueError):
        jax_random.key(2**32)
    with pytest.raises(ValueError):
        jax_random.key(-1)


# ---------------------------------------------------------------------------
# RandomFeatures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,stride,expect", [(32, 2, (0, 1)), (16, 2, (0, 1)), (7, 2, (1, 1)),
                                                (8, 1, (1, 1))])
def test_xla_same_pad(size, stride, expect):
    assert teval.xla_same_pad(size, 3, stride) == expect


@pytest.mark.parametrize("c_in", [1, 3])
def test_random_features_weights_are_the_jax_classes(c_in):
    ours = teval.RandomFeatures(device="cpu")._weights(c_in)
    theirs = jeval.RandomFeatures()._weights(c_in)
    assert [w.shape for w in ours] == [tuple(w.shape) for w in theirs]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    other = teval.RandomFeatures(seed=3, device="cpu")._weights(c_in)
    np.testing.assert_allclose(other[3], np.asarray(jeval.RandomFeatures(seed=3)._weights(c_in)[3]),
                               rtol=0, atol=1e-6)
    assert not np.allclose(other[3], ours[3])


@pytest.mark.parametrize("channels,size", [(1, 32), (3, 32), (3, 28)])
def test_random_features_match_the_jax_class(channels, size):
    # 28 px reaches an odd size (7) at the third convolution: SAME pads (1, 1) there
    imgs = _images(12, size, channels, seed=channels + size)
    ours = teval.RandomFeatures(device="cpu", batch_size=5)  # 3 batches, the last ragged
    theirs = jeval.RandomFeatures()
    f, p = ours.features(imgs), ours.logits(imgs)
    fj, pj = theirs.features(imgs), theirs.logits(imgs)
    assert f.shape == (12, 256) and p.shape == (12, 128) and f.dtype == np.float32
    np.testing.assert_allclose(f, fj, rtol=0, atol=2e-6)
    np.testing.assert_allclose(p, pj, rtol=0, atol=2e-5)
    np.testing.assert_allclose(p.sum(1), 1.0, atol=1e-5)
    assert ours.name == theirs.name == "random-conv-v2"


# ---------------------------------------------------------------------------
# Inception-v3
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def state_dict():
    sd = tinc.random_state_dict(0)
    sd["AuxLogits.conv0.conv.weight"] = np.zeros((128, 768, 1, 1), np.float32)
    return sd


def test_inception_table_and_converters(state_dict):
    shapes = tinc.conv_shapes()
    assert len(shapes) == 94
    assert shapes["Conv2d_1a_3x3"] == (32, 3, 3, 3)
    assert shapes["Mixed_6b.branch7x7_2"] == (128, 128, 1, 7)
    assert shapes["Mixed_7c.branch1x1"] == (320, 2048, 1, 1)
    ours = tinc.params_from_state_dict(state_dict)
    theirs = jinc.convert_torch_state_dict(state_dict)
    assert set(ours) == set(theirs) and "fc" in ours
    assert not any(k.startswith("AuxLogits") for k in ours)
    assert ours["Conv2d_1a_3x3"]["conv.weight"].shape == (32, 3, 3, 3)  # OIHW stays
    assert ours["fc"]["weight"].shape == (1008, 2048)
    # the JAX nested dict (HWIO) converts to the same parameters, and back
    from_jax = tinc.params_from_jax_inception(theirs)
    back = tinc.params_to_jax_inception(ours)
    for mod in theirs:
        assert set(ours[mod]) == set(theirs[mod]) == set(from_jax[mod])
        for leaf in theirs[mod]:
            assert torch.equal(ours[mod][leaf], from_jax[mod][leaf]), (mod, leaf)
            np.testing.assert_array_equal(back[mod][leaf], theirs[mod][leaf])


def test_inception_forward_matches_the_jax_forward(state_dict):
    rng = np.random.default_rng(42)
    # 149x149 keeps every spatial size valid and runs in seconds on a CPU
    x = rng.uniform(-1.0, 1.0, size=(2, 149, 149, 3)).astype(np.float32)
    with torch.inference_mode():
        feats, logits = tinc.inception_forward(
            tinc.params_from_state_dict(state_dict), torch.from_numpy(x).permute(0, 3, 1, 2))
    feats_j, logits_j = jinc.inception_forward(
        jinc.convert_torch_state_dict(state_dict), jnp.asarray(x))
    assert feats.shape == (2, 2048) and logits.shape == (2, 1008)
    for got, ref in ((feats.numpy(), np.asarray(feats_j)), (logits.numpy(), np.asarray(logits_j))):
        assert np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 2e-5 * np.abs(ref).max()


def test_inception_preprocessing_is_the_jax_packages(tmp_path, state_dict):
    pt = tmp_path / "w.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in state_dict.items()}, pt)
    ours = tinc.InceptionV3Torch(str(pt), device="cpu")
    theirs = jinc.InceptionV3Flax(str(pt))
    for channels in (1, 3):
        imgs = _images(2, 32, channels, seed=channels)
        a, b = ours._preprocess(imgs), theirs._preprocess(imgs)
        assert a.shape == (2, 299, 299, 3)
        np.testing.assert_array_equal(a, b)


def test_inception_npz_round_trip_across_the_two_packages(tmp_path, state_dict):
    pt = tmp_path / "w.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in state_dict.items()}, pt)
    ours = tinc.InceptionV3Torch(str(pt), batch_size=2, device="cpu")
    theirs = jinc.InceptionV3Flax(str(pt))
    ours.save_npz(str(tmp_path / "port.npz"))
    theirs.save_npz(str(tmp_path / "jax.npz"))
    # the JAX package reads the port's file, and the port the JAX package's
    jax_reads_port = jinc.InceptionV3Flax(str(tmp_path / "port.npz"))
    port_reads_jax = tinc.InceptionV3Torch(str(tmp_path / "jax.npz"), device="cpu")
    for mod, leaves in theirs.params.items():
        for leaf, value in leaves.items():
            np.testing.assert_array_equal(jax_reads_port.params[mod][leaf], value)
            assert torch.equal(port_reads_jax.params[mod][leaf], ours.params[mod][leaf])
    # and the extractor runs end to end from the file (32 px grey → 299 px RGB)
    imgs = _images(3, 32, 1, seed=5)
    feats, probs = port_reads_jax.features(imgs), port_reads_jax.logits(imgs)
    assert feats.shape == (3, 2048) and probs.shape == (3, 1008)
    assert np.isfinite(feats).all()
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-5)
    assert port_reads_jax.name == theirs.name == "inception-v3-fid"


def test_missing_inception_weights_raise_with_the_same_advice(tmp_path):
    path = str(tmp_path / "nope.pt")
    with pytest.raises(FileNotFoundError) as ours:
        teval.InceptionV3Features(path, device="cpu")
    with pytest.raises(FileNotFoundError) as theirs:
        jeval.InceptionV3Features(path)
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# calculate_metrics / evaluate_folders
# ---------------------------------------------------------------------------


def test_calculate_metrics_matches_the_jax_package():
    gen, ref = _images(40, 32, 3, seed=11), _images(48, 32, 3, seed=12)
    ours = teval.calculate_metrics(gen, ref, device="cpu")
    theirs = jeval.calculate_metrics(gen, ref)
    assert list(ours) == list(theirs)
    assert ours["feature_space"] == theirs["feature_space"] == "random-conv-v2"
    for key, value in theirs.items():
        if key != "feature_space":
            assert ours[key] == pytest.approx(value, rel=5e-5, abs=1e-9), key
    only_fid = teval.calculate_metrics(gen, ref, isc=False, compute_kid=False, device="cpu")
    assert list(only_fid) == ["feature_space", "frechet_inception_distance"]


def test_evaluate_folders_reads_sorts_and_saves(tmp_path):
    from PIL import Image

    gen, ref = _images(12, 16, 1, seed=21), _images(12, 16, 1, seed=22)
    for name, imgs in (("gen", gen), ("ref", ref)):
        (tmp_path / name).mkdir()
        for i, img in enumerate(imgs):
            Image.fromarray(img[:, :, 0]).save(tmp_path / name / f"image_{i}.png")
    loaded = teval._load_folder(str(tmp_path / "gen"))
    np.testing.assert_array_equal(loaded, gen)  # numeric order: image_10 after image_9
    np.testing.assert_array_equal(loaded, jeval._load_folder(str(tmp_path / "gen")))
    assert teval._load_folder(str(tmp_path / "gen"), limit=5).shape == (5, 16, 16, 1)
    save = tmp_path / "out" / "eval.txt"
    m = teval.evaluate_folders(str(tmp_path / "gen"), str(tmp_path / "ref"), save_path=str(save),
                               device="cpu")
    mj = jeval.evaluate_folders(str(tmp_path / "gen"), str(tmp_path / "ref"))
    assert list(m) == list(mj)
    for key, value in mj.items():
        if key != "feature_space":
            assert m[key] == pytest.approx(value, rel=5e-5, abs=1e-9), key
    assert save.read_text().splitlines()[0] == "feature_space: random-conv-v2"
    import json

    assert json.loads(save.with_suffix(".json").read_text()) == m
