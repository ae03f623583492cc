"""The port's ``reproduce-grid`` against the JAX package's, on the CPU.

* the grid's tables and ``_build_config`` equal the JAX package's;
* ``format_grid_markdown`` and ``validate_inception_weights`` give identical
  strings and dicts;
* ``reproduce_grid(reuse_generated=True)`` on the same seeded ``gen_*.npz``
  image sets and the same training set gives the JAX package's rows: the
  full-precision metrics within the tolerance of
  ``test_torch_eval.py::test_calculate_metrics_matches_the_jax_package``
  (5e-5 relative, 1e-9 absolute: f32 features in another summation order,
  metrics in float64), the two-decimal ones within one unit of their last
  place, every other key equal;
* ``resume`` refuses an artifact of another recipe, keeps the prior rows of
  configs outside a narrower re-run, and trains nothing where every row is
  done;
* a tiny end-to-end grid (2 configs, 8 px, batch 4, 10 noise steps, 4
  images) on a generated image tree.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from aliasfree_diffusion_models_pytorch_tpu import reproduce as jreproduce
from aliasfree_diffusion_models_pytorch_tpu_torch import cli, reproduce
from aliasfree_diffusion_models_pytorch_tpu_torch import train as train_mod

METRIC_RTOL, METRIC_ATOL = 5e-5, 1e-9


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers run at once: two threads each are enough."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def test_grid_tables_equal_the_jax_packages():
    assert reproduce.GRID_CONFIGS == jreproduce.GRID_CONFIGS
    assert list(reproduce.GRID_CONFIGS) == list(jreproduce.GRID_CONFIGS)  # the canonical order
    assert reproduce.PUBLISHED == jreproduce.PUBLISHED
    assert reproduce.KNOWN_INCEPTION_SHA256_PREFIXES == jreproduce.KNOWN_INCEPTION_SHA256_PREFIXES


@pytest.mark.parametrize("name", ["A", "B-0", "C-1", "D-1N", "D-2N"])
def test_build_config_fields_equal_the_jax_packages(name):
    kw = dict(epochs=3, batch_size=4, image_size=16, image_channels=3, seed=7,
              gen_total=20, gen_per_batch=8, dataset_path="/data/x")
    ours = dataclasses.asdict(reproduce._build_config(name, "CIFAR10", **kw))
    theirs = dataclasses.asdict(jreproduce._build_config(name, "CIFAR10", **kw))
    assert set(ours) <= set(theirs)
    assert ours == {k: theirs[k] for k in ours}
    assert ours["compute_dtype"] == "bfloat16" and ours["run_name"] == f"grid_CIFAR10_{name}"


def _result(comparable: bool) -> dict:
    rows = [{"config": "A", "is": 4.5, "fid": 98.7, "kid_x100": 5.9},
            {"config": "D-2N", "is": 4.1, "fid": 101.0, "kid_x100": 6.2}]
    if comparable:
        rows[0].update(published_fid=98.77, delta_fid=-0.07, published_kid_x100=5.97,
                       delta_kid_x100=-0.07)
    return {"dataset": "CIFAR10", "feature_space": "inception" if comparable else "random-conv-v2",
            "comparable_to_published": comparable, "rows": rows}


@pytest.mark.parametrize("comparable", [True, False], ids=["comparable", "not_comparable"])
def test_format_grid_markdown_is_the_jax_packages(comparable):
    result = _result(comparable)
    assert reproduce.format_grid_markdown(result) == jreproduce.format_grid_markdown(result)


def test_validate_inception_weights_gives_the_same_dict(tmp_path):
    path = tmp_path / "w.npz"
    path.write_bytes(b"not real weights")
    ours = reproduce.validate_inception_weights(str(path))
    assert ours == jreproduce.validate_inception_weights(str(path))
    assert ours["known"] is None and len(ours["sha256"]) == 64


GRID = dict(epochs=1, batch_size=4, seed=3, gen_total=16, gen_per_batch=8, image_size=8,
            noise_steps=10)


def _write_gen(out_dir, names, dataset="MNIST", channels=1):
    rng = np.random.default_rng(5)
    for name in names:
        images = rng.integers(0, 256, (GRID["gen_total"], 8, 8, channels), dtype=np.uint8)
        np.savez_compressed(os.path.join(out_dir, f"gen_{dataset}_{name}.npz"), images=images)


def _assert_rows_match(ours, theirs):
    assert [r["config"] for r in ours] == [r["config"] for r in theirs]
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for key, value in b.items():
            if key.endswith("_raw"):
                assert a[key] == pytest.approx(value, rel=METRIC_RTOL, abs=METRIC_ATOL), key
            elif key in ("is", "fid", "kid_x100"):
                assert abs(a[key] - value) <= 0.01 + 1e-9, key  # one unit of the last place
            else:
                assert a[key] == value, key


def test_reuse_generated_rows_match_the_jax_package(tmp_path):
    names = ["A", "D-2N"]
    _write_gen(str(tmp_path), names)
    kw = dict(configs=names, root=str(tmp_path), reuse_generated=True, **GRID)
    ours = reproduce.reproduce_grid("MNIST", None, out_path=str(tmp_path / "ours.json"),
                                    device="cpu", **kw)
    theirs = jreproduce.reproduce_grid("MNIST", None, out_path=str(tmp_path / "theirs.json"),
                                       **kw)
    assert set(ours) == set(theirs)
    for key in theirs:
        if key != "rows":
            assert ours[key] == theirs[key], key
    _assert_rows_match(ours["rows"], theirs["rows"])
    assert ours["rows"][0]["gen_images"] == "gen_MNIST_A.npz"
    assert ours["rows"][0]["train_s"] is None  # nothing trained, no prior artifact
    on_disk = json.loads((tmp_path / "ours.json").read_text())
    assert on_disk["complete"] is True and on_disk["rows"] == ours["rows"]


def test_resume_refuses_another_recipe_and_keeps_prior_rows(tmp_path, monkeypatch):
    out = tmp_path / "grid.json"
    _write_gen(str(tmp_path), ["A", "B-0", "D-2N"])
    kw = dict(root=str(tmp_path), out_path=str(out), device="cpu", **GRID)
    first = reproduce.reproduce_grid("MNIST", None, configs=["A", "D-2N"],
                                     reuse_generated=True, **kw)
    prior = {r["config"]: r for r in first["rows"]}

    with pytest.raises(ValueError, match="refusing to mix rows"):
        reproduce.reproduce_grid("MNIST", None, configs=["A"], resume=True,
                                 **{**kw, "noise_steps": 20})

    # A narrower re-run with resume keeps A and D-2N and adds B-0, in the grid's order.
    monkeypatch.setattr(train_mod, "train", lambda *a, **k: pytest.fail("trained"))
    second = reproduce.reproduce_grid("MNIST", None, configs=["B-0"], resume=True,
                                      reuse_generated=True, **kw)
    assert [r["config"] for r in second["rows"]] == ["A", "B-0", "D-2N"]
    assert second["rows"][0] == prior["A"] and second["rows"][2] == prior["D-2N"]
    assert second["configs_total"] == 3 and second["complete"] is True


def _write_tree(root, n_per_class=4, size=8):
    rng = np.random.default_rng(9)
    for cls in ("c0", "c1"):
        os.makedirs(os.path.join(root, cls))
        for i in range(n_per_class):
            img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(root, cls, f"{i}.png"))


def test_tiny_grid_end_to_end_then_resume_trains_nothing(tmp_path, monkeypatch, capsys):
    tree = tmp_path / "tree"
    _write_tree(str(tree))
    out = tmp_path / "grid" / "grid.json"
    args = ["reproduce-grid", "--dataset", "CIFAR10", "--dataset-path", str(tree),
            "--configs", "A,D-2N", "--epochs", "1", "--batch-size", "4", "--image-size", "8",
            "--noise-steps", "10", "--gen-total", "4", "--gen-per-batch", "4",
            "--root", str(tmp_path / "root"), "--out", str(out), "--device", "cpu"]
    calls = []
    real_train = train_mod.train
    monkeypatch.setattr(train_mod, "train",
                        lambda *a, **k: calls.append(a[0].run_name) or real_train(*a, **k))
    assert cli.main(args) == 0
    printed = capsys.readouterr().out
    assert "| A |" in printed and "NOT comparable" in printed and f"wrote {out}" in printed
    result = json.loads(out.read_text())
    assert calls == ["grid_CIFAR10_A", "grid_CIFAR10_D-2N"]
    assert result["real_data"] is True and result["comparable_to_published"] is False
    assert result["complete"] is True and result["configs_done"] == 2
    for row in result["rows"]:
        assert np.isfinite(row["fid_raw"]) and np.isfinite(row["final_loss"])
        with np.load(out.parent / row["gen_images"]) as z:
            assert z["images"].shape == (4, 8, 8, 3) and z["images"].dtype == np.uint8

    calls.clear()
    assert cli.main([*args, "--resume"]) == 0
    assert calls == [] and json.loads(out.read_text())["rows"] == result["rows"]
    assert cli.main([*args, "--reuse-generated"]) == 0
    assert calls == []
    _assert_rows_match(json.loads(out.read_text())["rows"], result["rows"])
