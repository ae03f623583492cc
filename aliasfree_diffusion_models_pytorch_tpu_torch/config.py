"""Typed configuration objects (the port's own copy).

Mirrors ``aliasfree_diffusion_models_pytorch_tpu/config.py``: the fields of
:class:`FilterSettings`, and the model, sampler and checkpoint-path fields of
``TrainConfig``, with the same defaults and validation. Training-only fields
(optimizer, data, evaluation) arrive with the training slice.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class FilterSettings:
    """Low-pass filter design knobs for the alias-free ops.

    Mirrors the reference ``f_settings`` dict: ``kernel_size``, ``kaiser_beta``,
    ``omega_c_down``, ``omega_c_up``; ``normalize`` exposes the README's
    non-normalized kernel family.
    """

    kernel_size: int = 3
    kaiser_beta: float | None = 2.0
    omega_c_down: float = math.pi / 2
    omega_c_up: float = math.pi / 2
    normalize: bool = True

    def __post_init__(self) -> None:
        if self.kernel_size < 1:
            raise ValueError(f"kernel_size must be >= 1, got {self.kernel_size}")
        for name in ("omega_c_down", "omega_c_up"):
            w = getattr(self, name)
            if not (0.0 < w <= math.pi + 1e-9):
                raise ValueError(f"{name} must be in (0, pi], got {w}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Model, sampler and checkpoint-path fields of the JAX ``TrainConfig``.

    Same names, defaults and validation, so a run directory written by the
    JAX package resolves to the same checkpoint path here.
    """

    run_name: str = "DDPM_Uncondtional_MNIST_0"  # typo preserved for artifact-path parity
    image_size: int = 32
    image_channels: int = 3
    noise_steps: int = 1000
    variant: int = 0
    dataset: str = "MNIST"
    seed: int = 42
    filters: FilterSettings | None = None
    beta_start: float = 1e-4
    beta_end: float = 0.02
    compute_dtype: str = "float32"  # "bfloat16" for the tensor-core path
    use_ema: bool = False
    time_dim: int = 256
    base_width: int | None = None
    num_classes: int | None = None

    def __post_init__(self) -> None:
        if not 0 <= self.variant <= 4:
            raise ValueError("variant value must be between 0 and 4")
        if self.variant != 0 and self.filters is None:
            raise ValueError("f_settings is empty")  # reference error string
        if self.image_size % 8 != 0:
            raise ValueError(
                f"image_size must be divisible by 8 (3 down stages), got {self.image_size}"
            )
        if self.base_width is not None and (
            self.base_width < 4 or self.base_width % 4 != 0
        ):
            raise ValueError(
                f"base_width must be a positive multiple of 4 (4-head "
                f"attention), got {self.base_width}"
            )
        if self.noise_steps < 2:
            raise ValueError("noise_steps must be >= 2")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be 'float32' or 'bfloat16', got {self.compute_dtype!r}"
            )

    # Artifact paths — the JAX package's (and the reference's) scheme.
    def model_dir(self, root: str = ".") -> str:
        return f"{root}/models/{self.run_name}"

    def checkpoint_path(self, root: str = ".") -> str:
        return f"{self.model_dir(root)}/ckpt_{self.dataset}_{self.variant}"
