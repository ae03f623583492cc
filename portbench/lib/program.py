"""What the harness takes from the program: its configuration object, its
kernels' launch counters and its record of the implementation choices.

Drivers import the program's entry points themselves; this module holds the
parts they share. Nothing is imported before a function is called.
"""

from __future__ import annotations

PACKAGE = "aliasfree_diffusion_models_pytorch_tpu_torch"


def train_config(cfg: dict, run_name: str, **fields):
    """The program's ``TrainConfig`` for a configuration file, with ``fields``
    (batch size, epochs, seed) from the mix and the run."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig

    f = cfg["filters"]
    return TrainConfig(
        run_name=run_name, dataset="CIFAR10", image_size=cfg["image_size"],
        image_channels=cfg["image_channels"], base_width=cfg["base_width"],
        time_dim=cfg["time_dim"], variant=cfg["variant"],
        filters=None if f is None else FilterSettings(**f),
        noise_steps=cfg["noise_steps"], beta_start=cfg["beta_start"], beta_end=cfg["beta_end"],
        lr=cfg["lr"], compute_dtype=cfg["compute_dtype"], use_ema=cfg["use_ema"],
        ema_beta=cfg["ema_beta"], grad_clip=cfg["grad_clip"], image_gen_n=0, **fields)


def launches() -> dict:
    """Launches of each hand-written kernel's wrapper so far (graph replays
    included: ``utils/kernels.py:COUNTED``)."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels

    return {w.__name__: w.launches for w in kernels.COUNTED}


def impl_text() -> str:
    from aliasfree_diffusion_models_pytorch_tpu_torch.impl_flags import impl_report_text

    return impl_report_text().replace("\n", " | ")
