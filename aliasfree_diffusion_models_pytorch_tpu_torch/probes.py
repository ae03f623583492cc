"""The two card-side micro-probes: what does exp cost, and what does the
matrix unit charge for QKᵀ at head dim 8?

Counterparts of the JAX package's ``benchmarks/exp_micro.py`` and
``benchmarks/attn_headpack.py``, which asked the same of a TPU. Both drive
the hand-written kernels of ``ops/probes.py`` and print the JAX probes' lines:

* :func:`run_exp_micro` — every op of ``ops.probes.OPS`` chained 16 times over
  a (64, 1024, 1024) f32 array of softmax-like inputs (``−|N(0,1)|·5``); per
  op the time of one pass, and the cost of one application read off the slope
  against ``copy``; before that the accuracy line of ``fastexp2`` against
  float64 ``exp`` on [−80, 0].
* :func:`run_attn_headpack` — ``qk_rowsum`` at (a) 1024 heads of (1024, 8),
  (b) the same heads packed four at a time into block-diagonal (4096, 32)
  operands, (c) 1024 heads of (1024, 128); the port's ``flash_mha`` forward
  and forward+backward at (256, 4, 1024, 8) for context; the two ratios and
  the verdict.

On the card the times are device times between CUDA events. ``small=True``
shrinks the arrays to what a CPU runs through the plain versions in seconds;
on the CPU the times are host-clock times of those plain versions and say
nothing about the card (the result names its ``device`` and ``timer``).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.ops import probes as kp
from aliasfree_diffusion_models_pytorch_tpu_torch.ops.flash_attention import flash_mha

CHAIN = 16
WARMUP = 1  # launches before the timed ones, per op or shape


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def _timeit(fn, iters: int, device: torch.device) -> float:
    """ms per call after ``WARMUP`` calls: CUDA events on the card, the host
    clock on the CPU."""
    for _ in range(WARMUP):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def fastexp2_max_rel_err(device) -> float:
    """Max relative error of one ``fastexp2`` application against float64
    ``exp`` on 100001 points of [−80, 0] (the kernel on the card, through a
    ``chain=1, subtract=False`` launch; the plain version on the CPU)."""
    xs = torch.from_numpy(np.linspace(-80, 0, 100001).astype(np.float32)).to(device)
    got = kp.exp_chain(xs, "fastexp2", chain=1, subtract=False).cpu().numpy().astype(np.float64)
    ref = np.exp(xs.cpu().numpy().astype(np.float64))
    return float(np.max(np.abs(got - ref) / np.maximum(ref, 1e-300)))


def run_exp_micro(iters: int = 50, device="cuda", small: bool = False) -> dict:
    """Time every op's 16-application chain; returns the result dict."""
    device = torch.device(device)
    b, s = (2, 64) if small else (64, 1024)
    print(f"device={_device_name(device)}", flush=True)
    rng = np.random.default_rng(0)
    # softmax-like domain: logits − max <= 0
    x = torch.from_numpy((-np.abs(rng.standard_normal((b, s, s))) * 5).astype(np.float32))
    x = x.to(device)

    rel = fastexp2_max_rel_err(device)
    print(f"fastexp2 max_rel_err vs exp on [-80, 0]: {rel:.2e}", flush=True)

    ms = {}
    for op in kp.OPS:
        ms[op] = _timeit(lambda: kp.exp_chain(x, op, CHAIN), iters, device)
        print(f"{op:10s} {ms[op]:7.3f} ms  (chain={CHAIN})", flush=True)
    # The JAX probe's reading: one pass is bound by memory (the copy row), the
    # chain makes arithmetic dominate, and an application's cost is the slope
    # against copy. A card overlaps memory traffic with arithmetic, so there
    # the slope is the op's cost above what the traffic hides; ms / (chain ·
    # elements) is its cost with nothing hidden.
    per_app_ns = {op: (ms[op] - ms["copy"]) * 1e6 / (CHAIN * x.numel()) for op in kp.OPS}
    return {
        "device": _device_name(device),
        "timer": "cuda events" if device.type == "cuda" else "host clock, plain versions",
        "shape": [b, s, s], "chain": CHAIN, "iters": iters,
        "fastexp2_max_rel_err": rel,
        "ms": ms,
        "per_application_ns_per_element": per_app_ns,
    }


def run_attn_headpack(iters: int = 20, device="cuda", out: str | None = None,
                      small: bool = False) -> dict:
    """Time the three QKᵀ structures and the attention kernels at the sa6
    shape; returns (and with ``out`` writes) the JAX probe's row dict."""
    device = torch.device(device)
    b, h, s, d = (2, 4, 128, 8) if small else (256, 4, 1024, 8)
    bh = b * h
    print(f"device={_device_name(device)}", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    rows: dict = {"shape": {"B": b, "H": h, "S": s, "D": d}, "iters": iters,
                  "device": _device_name(device),
                  "timer": "cuda events" if device.type == "cuda"
                  else "host clock, plain versions"}

    # (a) per-head baseline: B·H separate (S, 8) heads.
    k8, qt8 = randn(bh, s, d), randn(bh, d, s)
    rows["perhead_d8_ms"] = _timeit(lambda: kp.qk_rowsum(k8, qt8), iters, device)
    print(f"per-head D=8   (BH={bh} x {s}x{s}): {rows['perhead_d8_ms']:.3f} ms", flush=True)

    # (b) block-diagonal head-packing: each batch entry's H heads as one
    # (H·S, H·D) operand pair → one (4S, 4S) logits block; 16x the products,
    # the off-diagonal ones cross-head garbage a packed kernel would mask.
    kpk, qtpk = kp.block_diagonal_pack(k8, qt8, h)
    rows["blockdiag_hd32_ms"] = _timeit(lambda: kp.qk_rowsum(kpk, qtpk), iters, device)
    print(f"block-diag HD={h * d} (B={b} x {h * s}x{h * s}): "
          f"{rows['blockdiag_hd32_ms']:.3f} ms", flush=True)
    del kpk, qtpk

    # (c) contraction-depth control: D=128, the same (S, S) outputs as (a).
    k128, qt128 = randn(bh, s, 128), randn(bh, 128, s)
    rows["perhead_d128_ms"] = _timeit(lambda: kp.qk_rowsum(k128, qt128), iters, device)
    print(f"per-head D=128 (BH={bh} x {s}x{s}): {rows['perhead_d128_ms']:.3f} ms", flush=True)
    del k128, qt128

    # Context: the attention kernels at the sa6 shape.
    q4, k4, v4 = (randn(b, h, s, d).requires_grad_() for _ in range(3))

    def fwd():
        with torch.no_grad():
            return flash_mha(q4, k4, v4)

    def fwdbwd():
        loss = (flash_mha(q4, k4, v4).float() ** 2).sum()
        return torch.autograd.grad(loss, (q4, k4, v4))

    rows["flash_fwd_ms"] = _timeit(fwd, iters, device)
    rows["flash_fwdbwd_ms"] = _timeit(fwdbwd, iters, device)
    print(f"flash fwd {rows['flash_fwd_ms']:.3f} ms, "
          f"fwd+bwd {rows['flash_fwdbwd_ms']:.3f} ms", flush=True)

    ratio = rows["blockdiag_hd32_ms"] / rows["perhead_d8_ms"]
    depth = rows["perhead_d128_ms"] / rows["perhead_d8_ms"]
    rows["packed_over_perhead"] = round(ratio, 2)
    rows["d128_over_d8"] = round(depth, 2)
    rows["verdict"] = "REJECT head-packing" if ratio > 1.1 else "ACCEPT head-packing"
    print(json.dumps(rows), flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"wrote {out}", flush=True)
    return rows
