"""Typed configuration objects (the port's own copy).

Mirrors ``aliasfree_diffusion_models_pytorch_tpu/config.py``: the fields of
:class:`FilterSettings` and of ``TrainConfig`` (model, sampler, data,
optimizer, EMA, artifact paths) with the same defaults and validation. Not
carried over: the mesh fields (``mesh_shape``, ``mesh_axes``), which wait for
multi-GPU training, and ``checkpoint_opt_state``, which waits for optimizer
state in checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
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
    """Experiment configuration: the JAX ``TrainConfig``'s fields.

    Same names, defaults and validation, so a run directory written by the
    JAX package resolves to the same artifact paths here, and the
    ``config.json`` either trainer writes is read by the other.
    """

    run_name: str = "DDPM_Uncondtional_MNIST_0"  # typo preserved for artifact-path parity
    epochs: int = 100
    batch_size: int = 16
    image_size: int = 32
    image_channels: int = 3
    dataset_path: str | None = None
    lr: float = 3e-4
    noise_steps: int = 1000
    image_gen_n: int = 4  # images in the per-epoch sample grid

    variant: int = 0
    dataset: str = "MNIST"
    seed: int = 42
    filters: FilterSettings | None = None
    gen_per_batch: int = 200
    gen_total: int = 2000
    collage_n_per_image: int = 400
    collage_n: int = 2000
    save_training: bool = False

    beta_start: float = 1e-4
    beta_end: float = 0.02

    compute_dtype: str = "float32"  # "bfloat16" for the tensor-core path
    use_ema: bool = False
    ema_beta: float = 0.995
    time_dim: int = 256
    base_width: int | None = None
    num_classes: int | None = None
    # CFG training: per-sample probability of dropping the label embedding.
    label_dropout: float = 0.0
    # Opt-in optimizer knobs; the defaults are plain AdamW(lr): constant lr,
    # no clipping, one batch per update.
    lr_schedule: str = "constant"  # "constant" | "warmup_cosine"
    warmup_steps: int = 0  # linear-warmup updates (warmup_cosine only)
    lr_min_ratio: float = 0.0  # cosine floor as a fraction of the peak lr
    # Cosine horizon in optimizer updates. None: train() derives it
    # (epochs x steps per epoch / grad_accum).
    lr_total_steps: int | None = None
    grad_accum: int = 1  # micro-batches averaged per optimizer update
    grad_clip: float | None = None  # global-norm clip of the averaged gradient

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
        if self.batch_size < 1 or self.epochs < 0:
            raise ValueError("batch_size must be >= 1 and epochs >= 0")
        if self.noise_steps < 2:
            raise ValueError("noise_steps must be >= 2")
        if not 0.0 <= self.label_dropout < 1.0:
            raise ValueError(
                f"label_dropout must be in [0, 1), got {self.label_dropout}"
            )
        if self.label_dropout > 0.0 and self.num_classes is None:
            raise ValueError("label_dropout requires num_classes")
        if self.lr_schedule not in ("constant", "warmup_cosine"):
            raise ValueError(
                f"lr_schedule must be 'constant' or 'warmup_cosine', "
                f"got {self.lr_schedule!r}"
            )
        if self.warmup_steps < 0:
            raise ValueError(f"warmup_steps must be >= 0, got {self.warmup_steps}")
        if not 0.0 <= self.lr_min_ratio <= 1.0:
            raise ValueError(
                f"lr_min_ratio must be in [0, 1], got {self.lr_min_ratio}"
            )
        if self.lr_total_steps is not None and self.lr_total_steps < 1:
            raise ValueError(
                f"lr_total_steps must be >= 1, got {self.lr_total_steps}"
            )
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {self.grad_accum}")
        if self.grad_clip is not None and self.grad_clip <= 0.0:
            raise ValueError(f"grad_clip must be > 0, got {self.grad_clip}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be 'float32' or 'bfloat16', got {self.compute_dtype!r}"
            )

    # Artifact paths — the JAX package's (and the reference's) scheme.
    def model_dir(self, root: str = ".") -> str:
        return f"{root}/models/{self.run_name}"

    def checkpoint_path(self, root: str = ".") -> str:
        return f"{self.model_dir(root)}/ckpt_{self.dataset}_{self.variant}"

    def runs_dir(self, root: str = ".") -> str:
        return f"{root}/runs/{self.run_name}"

    def results_dir(self, root: str = ".") -> str:
        return f"{root}/results/{self.run_name}"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    def settings_text(self) -> str:
        """Human-readable settings dump, one ``key: value`` per line: the
        ``settings_{dataset}_{variant}.txt`` snapshot that ``ddpm_run``
        writes. (The JAX package appends its implementation switches; the
        port has none.)"""
        d = dataclasses.asdict(self)
        f = d.pop("filters", None)
        lines = [f"{k}: {v}" for k, v in d.items()]
        filter_keys = ("kernel_size", "kaiser_beta", "omega_c_down", "omega_c_up")
        if f is not None:
            lines += [f"{k}: {v}" for k, v in f.items()]
        else:
            lines += [f"{k}: None" for k in filter_keys]
        return "\n".join(lines)
