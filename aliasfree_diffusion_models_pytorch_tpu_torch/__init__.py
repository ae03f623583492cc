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
are the flash-attention forward and backward (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``, wrapped by ``ops/flash_attention.py``) and the two
probe kernels (``csrc/exp_chain.cu``, ``csrc/qk_rowsum.cu``, wrapped by
``ops/probes.py``).
"""

__version__ = "0.1.0"
