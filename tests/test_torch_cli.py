"""The port's CLI on the CPU: ``summary``, and ``sample`` from a JAX npz
checkpoint in a run directory (width recovered from its ``config.json``)
and from seeded random weights."""

import json
import os
import types

import numpy as np
from jax import random
from PIL import Image

from aliasfree_diffusion_models_pytorch_tpu.models.unet import UNet as JUNet
from aliasfree_diffusion_models_pytorch_tpu.utils.checkpoint import save_checkpoint
from aliasfree_diffusion_models_pytorch_tpu_torch import cli

TINY = ["--variant", "0", "--image-size", "8", "--noise-steps", "6", "--compute-dtype",
        "float32", "--device", "cpu", "--dataset", "CIFAR10"]


def test_summary(capsys):
    assert cli.main(["summary", "--variant", "3", "--image-size", "16"]) == 0
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
