"""Alias-Free Diffusion Models — PyTorch/CUDA port.

The PyTorch counterpart of ``aliasfree_diffusion_models_pytorch_tpu`` (the
JAX package, which stays the numerical reference). Module layout and names
follow the JAX package so each counterpart is easy to find; the port imports
nothing from it.

The port carries the serving path (Config A-D/v4 UNet forward, DDPM/DDIM
sampling with CFG, Config-E rotation and shift), the training path (AdamW
with f32 masters, EMA, the optimizer knobs, ``.npz`` checkpoints) and the
study path (``tasks.ddpm_run``, the Config-E sweeps, IS/FID/KID in ``eval``,
the kernel micro-probes), all behind ``cli``. Its hand-written device kernels
are seven CUDA sources: the flash-attention forward and backward
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``, wrapped by
``ops/flash_attention.py``), the filtered GELU's and the plain bf16 GELU's
kernel pairs (``csrc/filtered_gelu.cu``, ``csrc/plain_gelu.cu``, wrapped by
``ops/resample.py``), the attention block's LayerNorm pair
(``csrc/layer_norm.cu``, ``ops/layer_norm.py``) and the two probe kernels
(``csrc/exp_chain.cu``, ``csrc/qk_rowsum.cu``, ``ops/probes.py``). The op
modules reach them through one seam, ``utils/kernels.py``: it builds and
loads the libraries, declares, launches and error-checks each one's C entry
point (``csrc/entry.cuh``), counts launches and reads the card's SM count.
Data-parallel and FSDP training over torch.distributed live in
``parallel/`` and ``train.py``; ``impl_flags`` records a run's
implementation choices.
"""

__version__ = "0.1.0"
