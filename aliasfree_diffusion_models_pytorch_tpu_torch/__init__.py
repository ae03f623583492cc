"""Alias-Free Diffusion Models — PyTorch/CUDA port.

The PyTorch counterpart of ``aliasfree_diffusion_models_pytorch_tpu`` (the
JAX package, which stays the numerical reference). Module layout and names
follow the JAX package so each counterpart is easy to find; the port imports
nothing from it.

This slice carries the serving path: Config A-D/v4 UNet forward, DDPM/DDIM
sampling with CFG, Config-E rotation and shift, and the ``sample``/``summary``
CLI. The one hand-written device kernel on that path is the flash-attention
forward (``csrc/flash_fwd.cu``, wrapped by ``ops/flash_attention.py``).
"""

__version__ = "0.1.0"
