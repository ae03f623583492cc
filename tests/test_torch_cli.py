"""The port's CLI on the CPU: ``summary``, ``sample`` from a JAX npz
checkpoint in a run directory (width recovered from its ``config.json``)
and from seeded random weights, the flags of ``reproduce-grid``,
``--profile-dir`` and ``--checkpoint-opt-state``, and a profiled ``train``."""

import json
import os
import types

import numpy as np
from jax import random
from PIL import Image

from aliasfree_diffusion_models_pytorch_tpu.models.unet import UNet as JUNet
from aliasfree_diffusion_models_pytorch_tpu.utils.checkpoint import save_checkpoint
from aliasfree_diffusion_models_pytorch_tpu_torch import cli

TINY = ["--variant", "0", "--image-size", "8", "--image-channels", "3", "--noise-steps", "6",
        "--compute-dtype", "float32", "--device", "cpu", "--dataset", "CIFAR10"]


def test_summary(capsys):
    assert cli.main(["summary", "--variant", "3", "--image-size", "16", "--image-channels", "3"]) == 0
    out = capsys.readouterr().out
    assert "Config D" in out and "sa6" in out and "total" in out


def test_sample_from_jax_checkpoint_in_run_dir(tmp_path):
    jmodel = JUNet(c_in=3, c_out=3, image_size=8, base_width=4, variant=0)
    params = jmodel.init_params(random.key(0), batch=1)
    state = types.SimpleNamespace(params=params, ema_params=params, step=np.int32(1))
    run_dir = tmp_path / "models" / "DDPM_Uncondtional_CIFAR10_0"
    save_checkpoint(str(run_dir / "ckpt_CIFAR10_0"), state, backend="npz")
    (run_dir / "config.json").write_text(json.dumps({"base_width": 4}))
    out = tmp_path / "grid.png"
    args = cli.build_parser().parse_args(
        ["sample", *TINY, "--root", str(tmp_path), "--n", "3", "--out", str(out)])
    final = cli.run_sample(args)
    assert final.shape == (3, 8, 8, 3) and final.dtype == np.uint8
    assert Image.open(out).size == (2 + 3 * 10, 12)  # make_grid geometry, padding 2


def test_sample_random_weights_ddim_rotation_and_cfg(tmp_path):
    out = str(tmp_path / "s.png")
    assert cli.main(["sample", *TINY, "--random-weights", "--n", "2", "--out", out,
                     "--ddim-steps", "3", "--theta", "45"]) == 0
    assert os.path.exists(out)
    args = cli.build_parser().parse_args(
        ["sample", *TINY, "--random-weights", "--n", "2", "--out", out, "--ddim-steps", "3",
         "--num-classes", "4", "--label", "1", "--cfg-scale", "3.0"])
    assert cli.run_sample(args).shape == (2, 8, 8, 3)


def test_reproduce_grid_flags_are_the_jax_clis():
    args = cli.build_parser().parse_args(["reproduce-grid"])
    expect = dict(dataset="MNIST", dataset_path=None, inception_weights=None, configs=None,
                  epochs=100, batch_size=16, seed=42, gen_total=2000, gen_per_batch=200,
                  image_size=32, image_channels=None, noise_steps=1000, root=".",
                  out="sample_results/reproduced_grid.json", resume=False,
                  reuse_checkpoints=False, reuse_generated=False, device="cuda")
    assert vars(args) == {"cmd": "reproduce-grid", **expect}
    args = cli.build_parser().parse_args(
        ["reproduce-grid", "--configs", "A,D-2N", "--dataset", "CIFAR10", "--resume",
         "--reuse-generated", "--device", "cpu", "--image-channels", "3"])
    assert (args.configs, args.dataset, args.resume, args.reuse_generated, args.device,
            args.image_channels) == ("A,D-2N", "CIFAR10", True, True, "cpu", 3)


def test_profile_dir_and_opt_state_flags_on_train_run_and_sweep():
    for cmd in ("train", "run", "sweep"):
        args = cli.build_parser().parse_args([cmd])
        assert args.profile_dir is None and args.checkpoint_opt_state is False
        args = cli.build_parser().parse_args(
            [cmd, "--profile-dir", "/tmp/p", "--checkpoint-opt-state"])
        assert args.profile_dir == "/tmp/p"
        assert cli.config_from_args(args).checkpoint_opt_state is True
    # sample takes the flag, as in the JAX CLI, and reads it not
    assert cli.build_parser().parse_args(["sample"]).profile_dir is None


def test_train_writes_a_profiler_trace_of_steps_10_to_19(tmp_path):
    prof = tmp_path / "prof"
    assert cli.main(["train", *TINY, "--base-width", "4", "--batch-size", "16", "--epochs", "1",
                     "--image-gen-per-epoch", "0", "--root", str(tmp_path),
                     "--profile-dir", str(prof)]) == 0
    trace = prof / "trace_DDPM_Uncondtional_CIFAR10_0.json"
    events = json.loads(trace.read_text())["traceEvents"]
    # the window holds ten of the 32 steps: ten optimizer updates
    assert sum(e.get("name") == "Optimizer.step#AdamW.step" for e in events) == 10
    header = json.loads((tmp_path / "runs" / "DDPM_Uncondtional_CIFAR10_0" / "metrics.jsonl")
                        .read_text().splitlines()[0])
    # the loader's status is part of the implementation report, as in the JAX header
    assert header["impl"]["native_loader"] in ("loaded", "not built (builds on first data use)")
