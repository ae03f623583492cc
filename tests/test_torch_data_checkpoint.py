"""Port vs JAX package: data pipeline, weight conversion both ways,
checkpoints read across the two packages, and the port's CLI ``train`` →
``sample`` → ``train --resume`` on the CPU.

The data functions are integer and float64 numpy code copied from the JAX
package, so they are held bit-equal. Checkpoints hold f32 arrays that are
only transposed on the way: bit-equal too.
"""

import json
import math
import os
import types

import jax
import numpy as np
import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu import data as jdata
from aliasfree_diffusion_models_pytorch_tpu.config import FilterSettings as JFilters
from aliasfree_diffusion_models_pytorch_tpu.config import TrainConfig as JTrainConfig
from aliasfree_diffusion_models_pytorch_tpu.models.unet import UNet as JUNet
from aliasfree_diffusion_models_pytorch_tpu.utils import checkpoint as jckpt
from aliasfree_diffusion_models_pytorch_tpu_torch import cli
from aliasfree_diffusion_models_pytorch_tpu_torch import data as tdata
from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import checkpoint as tckpt
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import weights

FILTERS = dict(kernel_size=3, kaiser_beta=2.0, omega_c_down=math.pi / 2, omega_c_up=math.pi / 2)


@pytest.mark.parametrize("n,seed,epoch", [(1, 0, 0), (2, 5, 1), (37, 0, 0), (512, 42, 3)])
def test_splitmix64_permutation_bit_equal(n, seed, epoch):
    got = tdata.splitmix64_permutation(n, seed, epoch)
    np.testing.assert_array_equal(got, jdata.splitmix64_permutation(n, seed, epoch))
    assert sorted(got.tolist()) == list(range(n))


@pytest.mark.parametrize("kw", [dict(n=16, image_size=8, channels=1, seed=0),
                                dict(n=9, image_size=16, channels=3, seed=7)])
def test_synthetic_dataset_bit_equal(kw):
    got, ref = tdata.synthetic_dataset(**kw), jdata.synthetic_dataset(**kw)
    np.testing.assert_array_equal(got.images, ref.images)
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert got.images.dtype == np.float32 and len(got) == kw["n"]


@pytest.mark.parametrize("drop_last", [False, True])
def test_dataloader_epochs_bit_equal(drop_last):
    ds = tdata.synthetic_dataset(n=22, image_size=8, channels=3, seed=1)
    jds = jdata.ArrayDataset(ds.images, ds.labels)
    tl = tdata.Dataloader(ds, 4, drop_last=drop_last, seed=9)
    jl = jdata.Dataloader(jds, 4, drop_last=drop_last, seed=9)
    assert len(tl) == len(jl) == (5 if drop_last else 6)
    for _ in range(2):  # the second epoch reshuffles
        got, ref = list(tdata.PrefetchLoader(tl)), list(jl)
        assert len(got) == len(ref) == len(tl)
        for (gi, gl), (ri, rl) in zip(got, ref):
            np.testing.assert_array_equal(gi, ri)
            np.testing.assert_array_equal(gl, rl)


def test_prefetch_loader_reraises_loader_errors():
    def broken():
        yield 1
        raise RuntimeError("loader failed")

    with pytest.raises(RuntimeError, match="loader failed"):
        list(tdata.PrefetchLoader(broken()))


def test_mnist_csv_and_get_data(tmp_path):
    rng = np.random.default_rng(0)
    rows = np.concatenate([rng.integers(0, 10, (5, 1)), rng.integers(0, 256, (5, 784))], axis=1)
    path = tmp_path / "mnist.csv"
    header = ",".join(["label"] + [f"p{i}" for i in range(784)])
    np.savetxt(path, rows, fmt="%d", delimiter=",", header=header, comments="")
    got, ref = tdata.load_mnist_csv(str(path), 32), jdata.load_mnist_csv(str(path), 32)
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert got.images.shape == (5, 32, 32, 1)
    np.testing.assert_allclose(got.images, ref.images, atol=1e-6)  # f32 einsum order only
    dl, ds = tdata.get_data("MNIST", str(path), 32, 2)
    assert len(ds) == 5 and len(dl) == 3
    _, synth = tdata.get_data("CIFAR10", None, 16, 4, seed=3)
    np.testing.assert_array_equal(
        synth.images, jdata.synthetic_dataset(image_size=16, seed=3, channels=3).images)
    # any other dataset with a path is an image tree: one directory per class
    (tmp_path / "tree" / "c0").mkdir(parents=True)
    from PIL import Image
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(tmp_path / "tree" / "c0" / "0.png")
    _, tree = tdata.get_data("CIFAR10", str(tmp_path / "tree"), 32, 2)
    assert tree.images.shape == (1, 32, 32, 3) and float(tree.images.max()) == -1.0


def _jax_params(variant=3, num_classes=4):
    jmodel = JUNet(c_in=3, c_out=3, image_size=8, base_width=8, variant=variant,
                   num_classes=num_classes, time_dim=32,
                   filters=None if variant == 0 else JFilters(**FILTERS))
    return jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(variant), batch=1))


@pytest.mark.parametrize("variant", [0, 3, 4])
def test_params_to_jax_inverts_params_from_jax(variant):
    params = _jax_params(variant)
    back = weights.params_to_jax(weights.params_from_jax(params))
    flat, flat_back = weights._flatten(params["params"]), weights._flatten(back)
    assert set(flat) == set(flat_back)
    assert any(k.endswith("embedding") for k in flat)
    for key, value in flat.items():
        assert flat_back[key].dtype == np.float32
        np.testing.assert_array_equal(flat_back[key], value, err_msg=key)


def test_port_checkpoint_restored_by_jax_package(tmp_path):
    params = _jax_params()
    ema = jax.tree.map(lambda a: a * 0.5, params)
    path = str(tmp_path / "models" / "run" / "ckpt_MNIST_3")
    written = tckpt.save_checkpoint(path, weights.params_from_jax(params),
                                    weights.params_from_jax(ema), step=17)
    assert written == path + ".npz" and os.listdir(os.path.dirname(path)) == ["ckpt_MNIST_3.npz"]
    template = {"params": params, "ema_params": ema, "step": np.int32(0)}
    for restored in (jckpt.restore_checkpoint(path, template), jckpt.restore_checkpoint(path)):
        assert int(restored["step"]) == 17
        for field, tree in (("params", params), ("ema_params", ema)):
            got, ref = weights._flatten(restored[field]), weights._flatten(tree)
            assert set(got) == set(ref)
            for key in ref:
                np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_jax_checkpoint_restored_by_port(tmp_path):
    params = _jax_params()
    ema = jax.tree.map(lambda a: a + 1.0, params)
    state = types.SimpleNamespace(params=params, ema_params=ema, step=np.int32(5))
    path = str(tmp_path / "ckpt_MNIST_3")
    jckpt.save_checkpoint(path, state, backend="npz")
    restored = tckpt.restore_checkpoint(path)
    assert restored["step"] == 5
    for field, tree in (("params", params), ("ema_params", ema)):
        expect = weights.params_from_jax(tree)
        assert set(restored[field]) == set(expect)
        for key, value in expect.items():
            assert torch.equal(restored[field][key], value), key


def test_train_config_matches_jax_defaults_and_validation():
    jcfg, tcfg = JTrainConfig(), TrainConfig()
    # every field, the mesh fields included
    assert vars(tcfg) == vars(jcfg)
    assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())
    for root_fn in ("model_dir", "checkpoint_path", "runs_dir", "results_dir"):
        assert getattr(tcfg, root_fn)("r") == getattr(jcfg, root_fn)("r")
    for bad in (dict(lr_schedule="linear"), dict(grad_accum=0), dict(grad_clip=-1.0),
                dict(lr_min_ratio=1.5), dict(warmup_steps=-1), dict(label_dropout=0.1),
                dict(batch_size=0), dict(lr_total_steps=0)):
        with pytest.raises(ValueError):
            TrainConfig(**bad)
        with pytest.raises(ValueError):
            JTrainConfig(**bad)
    assert TrainConfig(variant=3, filters=FilterSettings()).filters.kernel_size == 3


MODEL = ["--variant", "3", "--image-size", "8", "--image-channels", "3", "--noise-steps", "6",
         "--compute-dtype", "float32", "--device", "cpu", "--dataset", "CIFAR10", "--f-kernel",
         "3", "--f-beta", "2"]
TINY = [*MODEL, "--base-width", "8", "--batch-size", "128", "--image-gen-per-epoch", "2"]


def test_cli_train_sample_resume_on_cpu(tmp_path, capsys):
    root = str(tmp_path)
    assert cli.main(["train", *TINY, "--root", root, "--epochs", "2"]) == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["final_loss"]
    assert np.isfinite(final)
    run = "DDPM_Uncondtional_CIFAR10_3"
    ckpt = tmp_path / "models" / run / "ckpt_CIFAR10_3.npz"
    assert ckpt.exists() and (tmp_path / "results" / run / "1.jpg").exists()
    stored = json.loads((tmp_path / "models" / run / "config.json").read_text())
    assert stored["base_width"] == 8 and stored["batch_size"] == 128
    lines = [json.loads(l) for l in (tmp_path / "runs" / run / "metrics.jsonl").read_text().splitlines()]
    assert lines[0]["run_header"] == run and lines[0]["resumed_step"] == 0
    first = tckpt.restore_checkpoint(str(ckpt))
    assert first["step"] == 8  # 512 synthetic images / 128 = 4 steps an epoch, 2 epochs
    # the JAX package reads the run's checkpoint too
    assert int(jckpt.restore_checkpoint(str(ckpt)[:-4])["step"]) == 8

    # sample serves the checkpoint; the width comes from config.json, not the flag
    out = str(tmp_path / "s.png")
    args = cli.build_parser().parse_args(
        ["sample", *MODEL, "--root", root, "--n", "3", "--out", out])
    assert args.base_width is None
    images = cli.run_sample(args)
    assert images.shape == (3, 8, 8, 3) and os.path.exists(out)

    # resume goes on from step 8 with the restored weights
    assert cli.main(["train", *TINY, "--root", root, "--epochs", "1", "--resume",
                     "--use-ema", "--grad-accum", "2", "--grad-clip", "1.0",
                     "--lr-schedule", "warmup_cosine", "--warmup-steps", "1"]) == 0
    second = tckpt.restore_checkpoint(str(ckpt))
    assert second["step"] == 12
    lines = [json.loads(l) for l in (tmp_path / "runs" / run / "metrics.jsonl").read_text().splitlines()]
    assert [l["resumed_step"] for l in lines if "run_header" in l] == [0, 8]
    moved = max((second["params"][k] - v).abs().max().item() for k, v in first["params"].items())
    assert 0 < moved < 12 * 3e-4  # went on from the restored weights, not from a fresh init
    assert any(not torch.equal(second["ema_params"][k], v) for k, v in first["ema_params"].items())
