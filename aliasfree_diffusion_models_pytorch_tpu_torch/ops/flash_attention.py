"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``aliasfree_diffusion_models_pytorch_tpu/ops/flash_attention.py``
(``attention_reference`` :65-75, ``_fwd_kernel`` :126-163, ``_flash_fwd``
:395-444, ``flash_mha`` :506-516). Sampling never differentiates, so only the
forward is ported here, in the TPU kernel's "fold" mode:

    logits = q·kᵀ·scale (f32);  m = max_j logits;  p = exp(logits − m);
    Σ = Σ_j p;  out = (p cast to the input dtype)·v, accumulated in f32, / Σ

and its "stats" mode, which also returns m and Σ as (B·H, 1, S) f32 arrays
for the backward of the training slice.

* :func:`attention_reference` is the plain PyTorch version of those steps.
  The CPU takes it; on the card it is only the yardstick the kernel is
  checked against.
* :func:`flash_attention_fwd` is the wrapper: a CPU tensor takes the plain
  version, a CUDA tensor launches ``csrc/flash_fwd.cu`` or raises. Its
  ``launches`` attribute counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels

__all__ = ["attention_reference", "flash_attention_fwd", "HEAD_DIMS"]

HEAD_DIMS = (8, 16, 32, 64)  # the kernel's template instantiations
_DTYPES = (torch.float32, torch.bfloat16)


def _default_scale(q: torch.Tensor, scale) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def attention_reference(q, k, v, scale=None, with_stats=False):
    """softmax(q·kᵀ·scale)·v per (batch, head), (B, H, S, D) layout, in the
    kernel's steps: f32 logits and softmax, p cast to the input dtype before
    the PV product, the division by Σ after it.

    With ``with_stats`` returns ``(out, m, Σ)``, m and Σ as (B·H, 1, S) f32.
    """
    b, h, s, _ = q.shape
    scale = _default_scale(q, scale)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    ssum = p.sum(dim=-1, keepdim=True)
    out = (torch.matmul(p.to(q.dtype).float(), v.float()) / ssum).to(q.dtype)
    if not with_stats:
        return out
    return out, m.reshape(b * h, 1, s), ssum.reshape(b * h, 1, s)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = kernels.load("flash_fwd")
    vp = ctypes.c_void_p
    lib.afdm_flash_fwd.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_float, ctypes.c_int, vp]
    lib.afdm_flash_fwd.restype = ctypes.c_int
    lib.afdm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.afdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v) -> None:
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, S, D) tensors, got shape {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} must match q in shape, dtype and device: "
                f"{tuple(t.shape)} {t.dtype} {t.device} vs "
                f"{tuple(q.shape)} {q.dtype} {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_fwd takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    if q.shape[0] * q.shape[1] < 1 or q.shape[2] < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention_fwd(q, k, v, scale=None, with_stats=False):
    """Attention forward on (B, H, S, D) q, k, v (f32 or bf16).

    CPU tensors take :func:`attention_reference`. CUDA tensors launch the
    hand-written kernel on the current stream; anything it cannot take
    raises. Returns ``out``, or ``(out, m, Σ)`` with ``with_stats``.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale, with_stats)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cpu or cuda, got {q.device}")
    _check(q, k, v)
    b, h, s, d = q.shape
    scale = _default_scale(q, scale)
    out = torch.empty_like(q)
    m = ssum = None
    if with_stats:
        m = torch.empty((b * h, 1, s), dtype=torch.float32, device=q.device)
        ssum = torch.empty_like(m)
    lib = _lib()
    with torch.cuda.device(q.device):  # a no-op when q is on the current device
        err = lib.afdm_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            m.data_ptr() if with_stats else None,
            ssum.data_ptr() if with_stats else None,
            b * h, s, d, scale, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_fwd launch failed: {lib.afdm_cuda_error_string(err).decode()}")
    flash_attention_fwd.launches += 1
    return (out, m, ssum) if with_stats else out


flash_attention_fwd.launches = 0
