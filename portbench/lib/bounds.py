"""The least time a kernel's work can take on one H100, from its shapes.

Frozen from ``chip_smoke.py`` (its peaks and ``attention_times``,
``attention_bwd_times``, ``fg_ops``, ``fg_times`` and ``bound``), so that a
later change to the program cannot move the yardstick. A bound is the larger
of the bytes time (each input read once, each output written once, at the
memory rate) and the operations time (matrix products at the tensor-core
peak, float32 instructions at the FMA rate, one exp per (query, key) pair at
the special-function rate). It counts the operation's work, not a design's.

Peaks (NVIDIA's data sheet, H100 SXM, dense, at the full 700 W): memory
3.35 TB/s; bf16 tensor cores 989 TFLOP/s; float32 outside the tensor cores
67 TFLOP/s, which is 33.5 T FMA instructions a second (132 SMs × 128 lanes at
1.98 GHz); the special-function units an eighth of that, 4.19 T/s.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
MATMUL_FLOPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
FMA_PER_S = MATMUL_FLOPS_PER_S["float32"] / 2
EXP_PER_S = FMA_PER_S / 8
BYTES = {"bfloat16": 2, "float32": 4}
# The chip's dense bf16 tensor-core peak, by a part of torch.cuda.get_device_name().
PEAK_BF16_FLOPS = {"H100": 989e12}


def peak_bf16(device_name: str) -> float | None:
    for tag, flops in PEAK_BF16_FLOPS.items():
        if tag in device_name:
            return flops
    return None


def attention_fwd(bh: int, s: int, d: int, dtype: str = "bfloat16",
                  stats: bool = False) -> tuple[float, float]:
    """(bytes s, operations s) of one forward: q, k, v read and the output
    written (and, with ``stats``, the two f32 row statistics a training
    forward keeps for its backward); QK and PV at the peak and one exp a pair."""
    nbytes = 4 * bh * s * d * BYTES[dtype] + (2 * bh * s * 4 if stats else 0)
    t_ops = max(4 * bh * s * s * d / MATMUL_FLOPS_PER_S[dtype], bh * s * s / EXP_PER_S)
    return nbytes / HBM_BYTES_PER_S, t_ops


def attention_bwd(bh: int, s: int, d: int, dtype: str = "bfloat16") -> tuple[float, float]:
    """(bytes s, operations s) of one backward: q, k, v, out, g and the two
    statistics read, dQ, dK, dV written; the five products (10·S²·D a head)
    at the peak and one exp a pair."""
    nbytes = 8 * bh * s * d * BYTES[dtype] + 2 * bh * s * 4
    t_ops = max(10 * bh * s * s * d / MATMUL_FLOPS_PER_S[dtype], bh * s * s / EXP_PER_S)
    return nbytes / HBM_BYTES_PER_S, t_ops


# The filtered GELU's float32 instructions an output element at k taps a side:
# the forward forms the four phases of the 2× upsample from k² products, one
# GELU a phase at a fixed cost of 12 instructions (clamp, square, seven Horner
# steps and two more: the cost is the GELU's, whatever form a kernel takes),
# and the k² taps of the 2× down FIR: 2k² + 48. The backward adds the k² taps
# of the cotangent and the GELU's derivative, 4 more a phase: 3k² + 64.
GELU_OPS = 12


def fg_ops(k: int, backward: bool) -> int:
    return 3 * k * k + 64 if backward else 2 * k * k + 4 * GELU_OPS


def fg(numel: int, k: int, backward: bool, dtype: str = "bfloat16") -> tuple[float, float]:
    """(bytes s, operations s) of one call on ``numel`` elements: x (and the
    cotangent) read and the result written; :func:`fg_ops` an output."""
    nbytes = (3 if backward else 2) * numel * BYTES[dtype]
    return nbytes / HBM_BYTES_PER_S, numel * fg_ops(k, backward) / FMA_PER_S


def bound(times: list[tuple[float, float]]) -> float:
    """Least seconds of calls run one after another: each call's slower side."""
    return sum(max(b, o) for b, o in times)
