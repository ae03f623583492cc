"""Command-line interface of the port: ``sample`` and ``summary``.

    python -m aliasfree_diffusion_models_pytorch_tpu_torch sample --n 16 --out samples.png
    python -m aliasfree_diffusion_models_pytorch_tpu_torch sample --ddim-steps 50 --theta 90
    python -m aliasfree_diffusion_models_pytorch_tpu_torch summary --variant 3

The model and sampler flags are the JAX CLI's (``cli.py:_add_common``); the
defaults are the serving configuration: Config D (variant 3) at 32 px, three
channels, bf16. Weights come from the run's JAX ``.npz`` checkpoint
(``models/<run_name>/ckpt_<dataset>_<variant>.npz`` under ``--root``) or,
with ``--random-weights``, from a seeded torch-default initialisation.
``--device`` picks the card (default ``cuda``) or ``cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys

import numpy as np
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--variant", type=int, default=3, help="UNet variant 0-4 (Configs A-D + v4)")
    p.add_argument("--dataset", default="MNIST", help="names the run directory")
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--base-width", type=int, default=None,
                   help="base channel width override (default: image-size); multiple of 4")
    p.add_argument("--image-channels", type=int, default=3)
    p.add_argument("--noise-steps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--f-kernel", type=int, default=None, help="filter kernel size (enables filters)")
    p.add_argument("--f-beta", type=float, default=None, help="Kaiser beta")
    p.add_argument("--f-down", type=float, default=None, help="omega_c_down (default pi/2)")
    p.add_argument("--f-up", type=float, default=None, help="omega_c_up (default pi/2)")
    p.add_argument("--no-normalize-filters", action="store_true",
                   help="expose the README's non-normalized kernel configs")
    p.add_argument("--compute-dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--use-ema", action="store_true", help="sample with the EMA weights")
    p.add_argument("--root", default=".", help="artifact root directory")
    p.add_argument("--num-classes", type=int, default=None, help="class-conditional model")
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")


def config_from_args(args) -> TrainConfig:
    filters = None
    if args.f_kernel is not None or args.variant != 0:
        filters = FilterSettings(
            kernel_size=args.f_kernel if args.f_kernel is not None else 3,
            kaiser_beta=args.f_beta,
            omega_c_down=args.f_down if args.f_down is not None else math.pi / 2,
            omega_c_up=args.f_up if args.f_up is not None else math.pi / 2,
            normalize=not args.no_normalize_filters,
        )
    return TrainConfig(
        run_name=f"DDPM_Uncondtional_{args.dataset}_{args.variant}",
        image_size=args.image_size,
        base_width=args.base_width,
        image_channels=args.image_channels,
        noise_steps=args.noise_steps,
        variant=args.variant,
        dataset=args.dataset,
        seed=args.seed,
        filters=filters,
        compute_dtype=args.compute_dtype,
        use_ema=args.use_ema,
        num_classes=args.num_classes,
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="aliasfree-diffusion-torch",
        description="Alias-free diffusion sampling on PyTorch/CUDA",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    sample = sub.add_parser("sample", help="generate images")
    summary = sub.add_parser("summary", help="model inspection: param count + per-layer shapes")
    for p in (sample, summary):
        _add_common(p)
    sample.add_argument("--n", type=int, default=16)
    sample.add_argument("--out", default="samples.png")
    sample.add_argument("--ddim-steps", type=int, default=None,
                        help="use the DDIM sampler with this many steps (default: DDPM)")
    sample.add_argument("--ddim-eta", type=float, default=0.0)
    sample.add_argument("--theta", type=float, default=None,
                        help="Config-E rotation: total angle in degrees, spread over the steps")
    sample.add_argument("--label", type=int, default=None,
                        help="conditional sampling: generate this class (needs --num-classes)")
    sample.add_argument("--cfg-scale", type=float, default=None,
                        help="classifier-free guidance scale (needs --label)")
    sample.add_argument("--random-weights", action="store_true",
                        help="torch-default weights drawn from --seed instead of a checkpoint")
    return parser


def _recover_base_width(config: TrainConfig, root: str) -> TrainConfig:
    """The checkpoint's weights fix the width: take ``base_width`` from the
    ``config.json`` the JAX trainer keeps beside the checkpoint, if any."""
    cfg_path = os.path.join(config.model_dir(root), "config.json")
    if not os.path.exists(cfg_path):
        return config
    with open(cfg_path) as f:
        stored = json.load(f)
    if "base_width" not in stored:
        return config
    width = stored["base_width"]
    return dataclasses.replace(config, base_width=None if width is None else int(width))


def run_sample(args) -> np.ndarray:
    """The ``sample`` subcommand: returns the final uint8 (n, H, W, C) batch
    and writes its grid to ``args.out``."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
    from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import build_model
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils.io import save_image_grid
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import (
        init_params,
        load_jax_npz,
    )

    config = config_from_args(args)
    if args.random_weights:
        state = init_params(config, config.seed)
    else:
        config = _recover_base_width(config, args.root)
        state = load_jax_npz(config.checkpoint_path(args.root), ema=config.use_ema)
    device = torch.device(args.device)
    model = build_model(config, device=device, state_dict=state)
    d = Diffusion(noise_steps=config.noise_steps, img_size=config.image_size, device=device)
    generator = torch.Generator(device=device).manual_seed(config.seed)
    cond = dict(labels=args.label, cfg_scale=args.cfg_scale, theta=args.theta)
    if args.ddim_steps:
        final = d.sample_ddim(model, n=args.n, image_channels=config.image_channels,
                              generator=generator, steps=args.ddim_steps, eta=args.ddim_eta,
                              **cond)
    else:
        final, _ = d.sample(model, n=args.n, image_channels=config.image_channels,
                            generator=generator, **cond)
    final = final.cpu().numpy()
    save_image_grid(final, args.out)
    return final


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "summary":
        from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import (
            build_model,
            model_summary,
        )

        print(model_summary(build_model(config_from_args(args), device="cpu")))
        return 0
    if args.cmd == "sample":
        run_sample(args)
        print(f"wrote {args.out}")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
