"""Where the reference rounds.

``F32`` rounds nothing: the reference proper, float32 with TF32 off
(:func:`exact_float32`). ``FP8`` is the control of the comparison that
decides ``correct``: the same reference holding in fp8 what the program
holds in bfloat16, every activation and the operands of every convolution,
linear layer and attention product (e4m3, one scale a tensor from its
largest entry, as fp8 training scales them), and rounding the gradients that
flow back through them to e5m2 the same way. The configurations state
bfloat16, and fp8 is the precision below it.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


class F32:
    name = "f32"

    @staticmethod
    def operand(x: torch.Tensor) -> torch.Tensor:
        return x


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class FP8:
    name = "fp8"

    @staticmethod
    def operand(x: torch.Tensor) -> torch.Tensor:
        return _Fp8Operand.apply(x)


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32, restored afterwards (the program's own
    settings stay as they were for its runs)."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
