"""The params-dict round trip and the implementation report, against the
JAX package.

``FilterSettings.from_params`` / ``to_dict`` and ``TrainConfig.from_params``
read the reference ``Train.ipynb`` params dict (the dict of
``tests/test_io_eval_config.py``) into the same fields as the JAX package's.
``impl_report()`` carries the JAX report's keys where the port has the
choice, with the JAX values, and the port's own; it builds nothing; its
``impl.*`` lines end the settings dump, and a CPU ``train`` run writes it into
its ``metrics.jsonl`` header.
"""

import dataclasses
import json
import math
import os
import subprocess

import pytest
import torch

from aliasfree_diffusion_models_pytorch_tpu import config as jconfig
from aliasfree_diffusion_models_pytorch_tpu import impl_flags as jimpl
from aliasfree_diffusion_models_pytorch_tpu_torch import cli, impl_flags
from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels, native

PARAMS = {
    "unet_v": 3, "epochs": 100, "batchsize": 16, "image_size": 32,
    "image_channels": 1, "device": "cuda", "lr": 3e-4, "noise_steps": 1000,
    "image_gen_per_epoch": 8, "f_kernel": 3, "f_beta": 2.0,
    "f_down": math.pi / 2, "f_up": math.pi / 2, "gen_per_batch": 200,
    "gen_total": 2000, "seed": 42, "collage_n_per_image": 400,
    "collage_n": 2000, "dataset": "MNIST", "dataset_dir": "data/x.csv",
    "save_trining": True,
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several worker processes at once; two threads each keep
    their OpenMP barriers from spinning against each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


SHARED_KEYS = ("gelu", "resample_impl", "fg_impl_perf", "fg_impl_parity", "native_loader")
PORT_KEYS = ("attention", "attention_plans", "kernel_lib", "deterministic", "tf32",
             "cuda_graphs", "distributed")


def test_filter_settings_from_params_and_to_dict_match_jax():
    assert FilterSettings.from_params({"f_kernel": None}) is None
    for extra in ({}, {"f_normalize": False, "f_beta": None}):
        params = {**PARAMS, **extra}
        ours = FilterSettings.from_params(params)
        theirs = jconfig.FilterSettings.from_params(params)
        assert ours.to_dict() == theirs.to_dict() == dataclasses.asdict(ours)


@pytest.mark.parametrize("unet_v,f_kernel", [(3, 3), (0, None)])
def test_train_config_from_params_matches_jax(unet_v, f_kernel):
    params = {**PARAMS, "unet_v": unet_v, "f_kernel": f_kernel}
    ours, theirs = TrainConfig.from_params(params), jconfig.TrainConfig.from_params(params)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.run_name == f"DDPM_Uncondtional_MNIST_{unet_v}"  # the reference's typo
    assert ours.save_training is True  # read from save_trining [sic]
    assert (ours.mesh_shape, ours.mesh_axes) == ((1,), ("data",))
    assert ours.checkpoint_path(".") == theirs.checkpoint_path(".")


@pytest.mark.parametrize("mode", [None, "exact", "poly13"])
def test_impl_report_keys_and_shared_values(monkeypatch, mode):
    if mode is None:
        monkeypatch.delenv("AFDM_GELU", raising=False)
    else:
        monkeypatch.setenv("AFDM_GELU", mode)
    monkeypatch.delenv("AFDM_FG_IMPL", raising=False)
    ours, theirs = impl_flags.impl_report(), jimpl.impl_report()
    assert list(ours) == [*SHARED_KEYS, *PORT_KEYS]
    for key in SHARED_KEYS[:-1]:  # each package reports its own C++ loader
        assert ours[key] == theirs[key], key
    assert ours["gelu"] == (mode or "auto(bf16:poly15,f32:exact)")
    assert ours["native_loader"] == native.native_status()
    assert ours["kernel_lib"] == {n: kernels.library_path(n).name.split("-")[1][:16]
                                  for n in kernels.SOURCES}
    assert ours["distributed"] == {"world_size": 1, "backend": None, "mesh": {"data": 1}}
    assert ours["deterministic"] is torch.are_deterministic_algorithms_enabled()
    assert not any(k.startswith("flash") for k in ours)  # the TPU gate knobs do not act here
    monkeypatch.setenv("AFDM_FG_IMPL", "conv")
    assert impl_flags.impl_report()["fg_impl_perf"] == jimpl.impl_report()["fg_impl_perf"]


def test_rendering_the_report_builds_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError(f"a build was started: {args[:1]}")

    for name in ("Popen", "run", "check_call", "check_output"):
        monkeypatch.setattr(subprocess, name, refuse)
    monkeypatch.setattr(kernels, "build", refuse)
    monkeypatch.setattr(native, "_build", refuse)
    report = impl_flags.impl_report(graphs=False)
    assert report["cuda_graphs"] is False
    text = TrainConfig(variant=3, filters=FilterSettings()).settings_text()
    assert "impl.gelu: " in text


def test_settings_text_ends_with_the_impl_lines(monkeypatch):
    monkeypatch.setenv("AFDM_GELU", "poly13")
    lines = TrainConfig().settings_text().splitlines()
    impl = [line for line in lines if line.startswith("impl.")]
    assert lines[-len(impl):] == impl
    assert [line.split(":")[0] for line in impl] == [f"impl.{k}" for k in (*SHARED_KEYS,
                                                                            *PORT_KEYS)]
    assert "impl.gelu: poly13" in impl
    assert impl_flags.impl_report_text().splitlines() == impl


def test_train_run_header_carries_impl(tmp_path, monkeypatch):
    monkeypatch.setenv("AFDM_GELU", "exact")
    root = str(tmp_path)
    # the synthetic set's 512 images in four steps
    assert cli.main(["train", "--device", "cpu", "--image-size", "8", "--base-width", "8",
                     "--batch-size", "128", "--epochs", "1", "--noise-steps", "10",
                     "--image-gen-per-epoch", "0", "--root", root]) == 0
    config = cli.config_from_args(cli.build_parser().parse_args(["train"]))
    with open(os.path.join(config.runs_dir(root), "metrics.jsonl")) as f:
        header = json.loads(f.readline())
    assert header["run_header"] == config.run_name
    impl = header["impl"]
    assert impl["gelu"] == "exact" and impl["cuda_graphs"] is False
    assert impl["distributed"]["world_size"] == 1
    assert set(impl) == {*SHARED_KEYS, *PORT_KEYS}
