"""Command-line interface of the port: ``train``, ``sample`` and ``summary``.

    python -m aliasfree_diffusion_models_pytorch_tpu_torch train --epochs 100 --batch-size 256
    python -m aliasfree_diffusion_models_pytorch_tpu_torch sample --n 16 --out samples.png
    python -m aliasfree_diffusion_models_pytorch_tpu_torch sample --ddim-steps 50 --theta 90
    python -m aliasfree_diffusion_models_pytorch_tpu_torch summary --variant 3

The flags are the JAX CLI's (``cli.py:_add_common``); the model defaults are
Config D (variant 3) at 32 px, three channels, bf16. ``train`` writes the
run's ``.npz`` checkpoint (``models/<run_name>/ckpt_<dataset>_<variant>.npz``
under ``--root``), in the JAX package's layout; with no ``--dataset-path`` it
trains on the synthetic dataset. ``sample`` reads that checkpoint (or one
written by the JAX package) or, with ``--random-weights``, draws a seeded
torch-default initialisation. ``--device`` picks the card (default ``cuda``)
or ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
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


def _add_train(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset-path", default=None,
                   help="MNIST CSV file; absent -> the synthetic dataset")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--resume", action="store_true",
                   help="resume from the run checkpoint if present")
    p.add_argument("--image-gen-per-epoch", type=int, default=4)
    p.add_argument("--gen-per-batch", type=int, default=200)
    p.add_argument("--gen-total", type=int, default=2000)
    p.add_argument("--label-dropout", type=float, default=0.0,
                   help="CFG training: per-sample label-drop probability (~0.1)")
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "warmup_cosine"],
                   help="constant (reference) | linear warmup + cosine decay")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="linear-warmup optimizer updates (warmup_cosine only)")
    p.add_argument("--lr-min-ratio", type=float, default=0.0,
                   help="cosine floor as a fraction of peak lr")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="micro-batches averaged per optimizer update "
                        "(effective batch = k * batch-size)")
    p.add_argument("--grad-clip", type=float, default=None,
                   help="global-norm gradient clipping threshold")


# TrainConfig field -> argparse attribute of the train subcommand
_TRAIN_FIELDS = {
    "epochs": "epochs", "batch_size": "batch_size", "dataset_path": "dataset_path",
    "lr": "lr", "image_gen_n": "image_gen_per_epoch", "gen_per_batch": "gen_per_batch",
    "gen_total": "gen_total", "label_dropout": "label_dropout",
    "lr_schedule": "lr_schedule", "warmup_steps": "warmup_steps",
    "lr_min_ratio": "lr_min_ratio", "grad_accum": "grad_accum", "grad_clip": "grad_clip",
}


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
        # the train subcommand's flags; the other subcommands keep the defaults
        **{field: getattr(args, flag) for field, flag in _TRAIN_FIELDS.items()
           if hasattr(args, flag)},
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="aliasfree-diffusion-torch",
        description="Alias-free diffusion training and sampling on PyTorch/CUDA",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    train = sub.add_parser("train", help="training only")
    sample = sub.add_parser("sample", help="generate images")
    summary = sub.add_parser("summary", help="model inspection: param count + per-layer shapes")
    for p in (train, sample, summary):
        _add_common(p)
    _add_train(train)
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


def run_sample(args) -> np.ndarray:
    """The ``sample`` subcommand: returns the final uint8 (n, H, W, C) batch
    and writes its grid to ``args.out``."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
    from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import build_model
    from aliasfree_diffusion_models_pytorch_tpu_torch.train import recover_base_width
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils.io import save_image_grid
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import (
        init_params,
        load_jax_npz,
    )

    config = config_from_args(args)
    if args.random_weights:
        state = init_params(config, config.seed)
    else:
        config = recover_base_width(config, args.root)
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


def run_train(args) -> list[float]:
    """The ``train`` subcommand: returns the per-epoch mean losses."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.data import get_data
    from aliasfree_diffusion_models_pytorch_tpu_torch.train import train

    config = config_from_args(args)
    dl, _ = get_data(
        config.dataset, config.dataset_path, config.image_size, config.batch_size,
        image_channels=config.image_channels, seed=config.seed, synthetic_fallback=True,
    )
    return train(config, dl, root=args.root, device=args.device, resume=args.resume)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # train narrates its progress through logging.info; the root stays at WARNING.
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s",
                        datefmt="%H:%M:%S")
    logging.getLogger().setLevel(logging.WARNING)
    logging.getLogger(__package__).setLevel(logging.INFO)
    if args.cmd == "summary":
        from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import (
            build_model,
            model_summary,
        )

        # On the meta device: shapes and counts only, no weights are allocated.
        print(model_summary(build_model(config_from_args(args), device="meta")))
        return 0
    if args.cmd == "train":
        losses = run_train(args)
        print(json.dumps({"final_loss": losses[-1] if losses else None}))
        return 0
    if args.cmd == "sample":
        run_sample(args)
        print(f"wrote {args.out}")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
