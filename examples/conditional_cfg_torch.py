"""Class-conditional training + classifier-free guidance on the PyTorch port.

The port's counterpart of ``examples/conditional_cfg.py``, call for call:
train with ``num_classes`` + ``label_dropout``, then sample every class,
guided (one batch-doubled forward a step). It runs on an NVIDIA GPU
(``--device cuda``, the default, with no fallback to the CPU) or, when asked,
on the CPU. The synthetic dataset's classes are frequency bands, so the
generated classes are visually distinct stripes. The flags' defaults are the
JAX script's values; the others cut the run down:

    python examples/conditional_cfg_torch.py
    python examples/conditional_cfg_torch.py --device cpu --root /tmp/c --epochs 1 \\
        --noise-steps 10 --ddim-steps 5 --image-size 8 --batch-size 4 --per-class 1

``main`` returns what the run made: the epoch losses, the uint8 images and
the paths it wrote.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.data import Dataloader, synthetic_dataset
from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
from aliasfree_diffusion_models_pytorch_tpu_torch.tasks import _load_model_params
from aliasfree_diffusion_models_pytorch_tpu_torch.train import train
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.io import save_image_grid

CLASSES = 10


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Conditional training and CFG on the PyTorch port.")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--root", default="/tmp/cond_example",
                   help="the run's root: checkpoint, metrics and classes.png")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--noise-steps", type=int, default=1000)
    p.add_argument("--ddim-steps", type=int, default=50)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--per-class", type=int, default=4,
                   help="images sampled per class, one row of the grid per class")
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(
        run_name="DDPM_conditional_example",
        epochs=args.epochs, batch_size=args.batch_size, image_size=args.image_size,
        image_channels=1, dataset="synth", dataset_path=None,
        lr=3e-4, noise_steps=args.noise_steps, variant=3, filters=FilterSettings(),
        seed=42, gen_total=0,
        num_classes=CLASSES, label_dropout=0.1,  # the CFG training recipe
    )


def sample_stage(config: TrainConfig, model, device, per_class: int, ddim_steps: int,
                 noise_fn=None) -> np.ndarray:
    """Guided DDIM on ``model``, ``per_class`` images of every class in class
    order, as uint8 NHWC: eps = eps_u + s·(eps_c − eps_u) at s = 3, from a
    generator seeded 0, or from ``noise_fn`` (``Diffusion.sample_ddim``'s
    handed-in noise) where one is given."""
    d = Diffusion(noise_steps=config.noise_steps, img_size=config.image_size, device=device)
    labels = np.repeat(np.arange(CLASSES, dtype=np.int32), per_class)
    imgs = d.sample_ddim(
        model, n=len(labels), image_channels=1,
        generator=torch.Generator(device=device).manual_seed(0), steps=ddim_steps,
        labels=labels, cfg_scale=3.0, noise_fn=noise_fn,
    )
    return imgs.cpu().numpy()


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("conditional_cfg_torch: no CUDA device (--device cpu runs on the CPU)")
    config = build_config(args)

    dl = Dataloader(synthetic_dataset(n=512, image_size=args.image_size, channels=1, seed=7),
                    batch_size=args.batch_size, seed=42, drop_last=True)
    losses = train(config, dl, root=args.root, device=device, sample_each_epoch=False)

    model = _load_model_params(config, args.root, device)
    imgs = sample_stage(config, model, device, args.per_class, args.ddim_steps)
    grid = os.path.join(args.root, "classes.png")
    save_image_grid(imgs, grid, nrow=args.per_class)
    print(f"wrote {grid} (rows = classes 0..{CLASSES - 1})")
    return {"losses": losses, "images": imgs, "grid": grid,
            "checkpoint": config.checkpoint_path(args.root) + ".npz"}


if __name__ == "__main__":
    main()
