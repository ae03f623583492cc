"""Quickstart on the PyTorch port: train Config D, sample (DDPM + DDIM + rotated), evaluate.

The port's counterpart of ``examples/quickstart.py``, call for call: the same
``TrainConfig`` fields and call arguments. It runs on an NVIDIA GPU
(``--device cuda``, the default, with no fallback to the CPU) or, when asked,
on the CPU; synthetic data is used when no dataset path is given. The flags'
defaults are the JAX script's values; the others cut the run down:

    python examples/quickstart_torch.py
    python examples/quickstart_torch.py --device cpu --epochs 1 --noise-steps 10 \\
        --ddim-steps 5 --image-size 8 --batch-size 4

Where the JAX script draws its three samplers from one key, this one reseeds
one ``torch.Generator`` to ``config.seed`` before each call, so all three
start from the same state. ``main`` returns what the run made: the epoch
losses, the uint8 samples, the metric dict and the paths it wrote.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.data import get_data
from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
from aliasfree_diffusion_models_pytorch_tpu_torch.eval import RandomFeatures, calculate_metrics
from aliasfree_diffusion_models_pytorch_tpu_torch.tasks import _load_model_params
from aliasfree_diffusion_models_pytorch_tpu_torch.train import train
from aliasfree_diffusion_models_pytorch_tpu_torch.utils.io import save_image_grid

GRID = "quickstart_samples.png"  # in the working directory, as the JAX script writes it


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Quickstart on the PyTorch port.")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--root", default=".", help="the run's root: checkpoint and metrics")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--noise-steps", type=int, default=1000)
    p.add_argument("--ddim-steps", type=int, default=50)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--n", type=int, default=8,
                   help="images a DDPM and a DDIM call sample; the rotated call samples half")
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(
        run_name="DDPM_Uncondtional_quickstart_3",
        epochs=args.epochs, batch_size=args.batch_size, image_size=args.image_size,
        image_channels=1, dataset="quickstart", dataset_path=None,  # synthetic fallback
        lr=3e-4, noise_steps=args.noise_steps, variant=3, filters=FilterSettings(),
        seed=42, gen_total=0, compute_dtype="float32",
    )


def sample_stage(config: TrainConfig, model, device, n: int, ddim_steps: int,
                 noise_fn=None) -> dict[str, np.ndarray]:
    """The JAX script's three samplers on ``model``: DDPM at ``n``, DDIM at
    ``n``, Config-E DDPM at ``n // 2`` with θ = 45°, as uint8 NHWC arrays.
    Each starts from a generator reseeded to ``config.seed``, or from
    ``noise_fn`` (``Diffusion.sample``'s handed-in noise) where one is given."""
    d = Diffusion(noise_steps=config.noise_steps, img_size=config.image_size, device=device)
    generator = torch.Generator(device=device)
    final, _ = d.sample(model, n=n, image_channels=1,
                        generator=generator.manual_seed(config.seed), noise_fn=noise_fn)
    fast = d.sample_ddim(model, n=n, image_channels=1,
                         generator=generator.manual_seed(config.seed), steps=ddim_steps,
                         noise_fn=noise_fn)
    rotated, _ = d.sample(model, n=n // 2, image_channels=1,
                          generator=generator.manual_seed(config.seed), theta=45.0,
                          noise_fn=noise_fn)
    return {"final": final.cpu().numpy(), "fast": fast.cpu().numpy(),
            "rotated": rotated.cpu().numpy()}


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quickstart_torch: no CUDA device (--device cpu runs on the CPU)")
    config = build_config(args)

    dataloader, dataset = get_data(
        config.dataset, config.dataset_path, config.image_size, config.batch_size,
        image_channels=config.image_channels, seed=config.seed, synthetic_fallback=True,
    )
    losses = train(config, dataloader, root=args.root, device=device, sample_each_epoch=False)
    print(f"losses: {[round(l, 3) for l in losses]}")

    model = _load_model_params(config, args.root, device)
    samples = sample_stage(config, model, device, args.n, args.ddim_steps)
    save_image_grid(samples["final"], GRID)

    m = calculate_metrics(
        samples["final"],
        np.clip((dataset.images[:256] + 1) / 2 * 255, 0, 255).astype(np.uint8),
        RandomFeatures(device=str(device)),
    )
    print({k: round(v, 3) if isinstance(v, float) else v for k, v in m.items()})
    return {"losses": losses, "samples": samples, "metrics": m,
            "checkpoint": config.checkpoint_path(args.root) + ".npz", "grid": GRID}


if __name__ == "__main__":
    main()
