#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

Run from the root of a checkout:  python3 chip_smoke.py

1. names the card (``nvidia-smi`` name and power limit, torch's device name);
2. builds every hand-written kernel from ``csrc/`` with nvcc (sm_90a), all
   sources at once (``flash_fwd``, ``flash_bwd``, ``exp_chain``,
   ``qk_rowsum``), and prints the build seconds and each kernel's registers
   and spill bytes from ptxas; the bf16 attention kernels must spill nothing;
3. holds each kernel against its plain PyTorch version on the card, in bf16
   (the tensor-core kernels) and f32 (the CUDA-core kernels), with and
   without softmax stats, and times kernel, plain version and the one-call
   PyTorch yardstick (``scaled_dot_product_attention`` and its backward,
   never called by the port) beside the reckoned bound; a timed kernel's
   profile must hold every kernel of every call (three ``flash_bwd*`` kernels
   a bf16 backward call, two an f32 one) or is taken again:
   the forward at every shape of the sampling path (Config D, image 32, base
   width 32: the six attention blocks at n=16 and at the CFG-doubled n=32);
   the backward at every shape of the training path (the same six blocks at
   batch 256, the six blocks of the 64-px step at batch 32, S up to 4096, and
   S=16384 of a 128-px step at batch 2), with the stats-mode forward that
   feeds it checked at the same shapes; then the two probe kernels:
   ``exp_chain`` at the probe's full (64, 1024, 1024) array for every op
   (chain 16, and a single application), with each op's bound, its cost per
   application off the slope against ``copy`` and the ``fastexp2`` accuracy
   line; ``qk_rowsum`` at the probe's three shapes, with the ``bmm`` + ``sum``
   yardstick, the two ratios and the verdict;
4. runs the full-width Config-D UNet forward (n=16) in f32 on the card
   against the same weights on the CPU (TF32 off), and in bf16, counting 6
   kernel launches per forward; DDIM-5 on the card against the CPU with the
   same injected noise; then one f32 train step on the card against the CPU
   (same weights, batch, t and noise): loss and every parameter's gradient,
   6 forward and 6 backward launches;
5. drives the sampling path through the CLI's ``sample`` entry point:
   1000-step DDPM at n=16 in bf16 (5994 launches), DDIM-50, DDIM-50 with θ=90
   (Config E) and a conditional DDIM-20 with CFG 3.0;
6. drives the training path through the CLI's ``train`` entry point: Config D
   at batch 256 in bf16 on the synthetic dataset, 10 steps (60 forward and 60
   backward launches, falling loss, a checkpoint), ``sample`` from that
   checkpoint, and a short run with EMA, accumulation, clipping and the
   warmup-cosine schedule — every launch counter set to 0 just before each
   run and read just after;
7. times the steady-state train step (batch 256 at 32 px, then batch 32 at
   64 px, which sends S=4096 through the backward): ms per step, images per
   second, kernels per step and device busy share from torch.profiler, peak
   memory;
8. drives the study path through the CLI in a scratch ``--root``: ``probe
   exp`` and ``probe headpack``; ``run`` (the whole ``ddpm_run`` pipeline at
   batch 256, 200 noise steps, 32 generated PNGs); ``rotate`` and ``shift``
   from its checkpoint (every member of a sweep starts from the same noise);
   ``eval`` of the generated PNGs against exported training PNGs on the card
   and on the CPU; one Inception-v3 forward at batch 16 with seeded random
   weights, card against CPU;
9. prints one JSON line of every ported kernel, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the ``ok``
line. Without a CUDA device it fails at once. Nothing here imports JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

OUT_DIR = os.path.join("build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet, dense): memory 3.35 TB/s; bf16 tensor
# cores 989 TFLOP/s; f32 outside the tensor cores 67 TFLOP/s, which is 33.5 T
# FMA instructions a second: 132 SMs x 128 lanes at the boost clock, 1.98 GHz.
# The special-function units give 16 results per SM and clock where the FMA
# pipes give 128, so their peak at the same clock is an eighth of that,
# 4.19 T/s. (The FlashAttention-3 paper's 3.9 T/s is the same unit at a lower
# clock; a bound has to take both peaks at one clock.) The bounds of
# flash_fwd and flash_bwd use the same constant for their exp term.
HBM_BYTES_PER_S = 3.35e12
MATMUL_FLOPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
FMA_PER_S = MATMUL_FLOPS_PER_S[torch.float32] / 2  # f32 instructions: 2 FLOPs per FMA
EXP_PER_S = FMA_PER_S / 8

# (block, S, C) of the six attention blocks at image 32, base width 32.
ATTN_SHAPES = [("sa1", 256, 64), ("sa2", 64, 128), ("sa3", 16, 128),
               ("sa4", 64, 64), ("sa5", 256, 32), ("sa6", 1024, 32)]
HEADS = 4
# Kernel vs plain version: max |difference| of a tensor, as a share of that
# tensor's largest |entry| in the plain version. With standard-normal inputs
# the outputs and gradients shrink like 1/sqrt(S) (std about 0.4 at S=16, 0.05
# at S=1024, 0.013 at S=16384), so one absolute limit would be loose by orders
# of magnitude at the long sequences; a relative one is as tight at every S.
#  f32: both sum the same f32 products, in another order, over up to S terms
#  (the forward rescales its sums once per 32-key tile, 512 times at S=16384),
#  and __expf stands against torch.exp (2 ulp) → 2e-5 of the largest entry;
#  bf16: kernel and plain version round p (and dS) to bf16 from f32 values
#  that differ in the last bits (the forward's online softmax rounds against
#  its running max), so single terms round one bf16 ulp apart, and both round
#  the result to bf16. One bf16 ulp is at most 2^-7 of the entry it belongs
#  to, so 2^-6 of the largest entry allows two ulps there and no more.
REL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0**-6}
M_ATOL = 1e-5   # row max of identical f32 logits, summation order only
SUM_RTOL = 1e-4  # Σ rescaled once per 32-key tile: a few f32 roundings per tile

# Kernels one call of the backward wrapper runs, by input dtype
# (csrc/flash_bwd.cu): bf16 a pre-pass, the tensor-core pass over every
# (query, key) pair and dQ's cast; f32 the dQ and the dK/dV kernels of the
# first port. torch.profiler must show all of them for every timed call.
BWD_KERNELS = {torch.bfloat16: 3, torch.float32: 2}

# The 64-px train step (image 64, base width 64, batch 32): (block, S, C).
ATTN_SHAPES_64 = [("sa1", 1024, 128), ("sa2", 256, 256), ("sa3", 64, 256),
                  ("sa4", 256, 128), ("sa5", 1024, 64), ("sa6", 4096, 64)]
# The longest sequence the JAX package trains (image 128, base width 128):
# checked against the plain version at batch 2; no train step runs it here.
ATTN_SHAPES_128 = [("sa6", 16384, 128)]
# The plain backward holds about six S×S f32 arrays per (batch, head): it is
# compared, and timed, at the largest batch that keeps one of them under this.
PLAIN_SS_BYTES = 5 * 2**30


# The exp probe (benchmarks/exp_micro.py): array, chain length, and per op the
# least work of ONE application on this run's data as (special-function
# results, f32 instructions on the FMA pipes), the subtract of the chain
# included. exp/exp2/__expf: one ex2; tanh and logistic: an ex2 and a
# reciprocal; erf: beyond |x| = 0.93, where the chain sits after its first
# application, a polynomial and one ex2; fastexp2: multiply, round, subtract,
# three FMAs, the scale and the chain's subtract, no special function.
EXP_SHAPE = (64, 1024, 1024)
EXP_CHAIN = 16
EXP_OP_WORK = {"copy": (0, 1), "mul2": (0, 1), "poly4": (0, 5), "exp": (1, 2), "exp2": (1, 1),
               "fastexp2": (0, 8), "tanh": (2, 2), "erf": (1, 8), "rsqrt1p": (1, 2),
               "logistic": (2, 3), "exp_fast": (1, 2)}
# Kernel vs plain version of a chain: max |difference| over the finite entries
# as a share of the tensor's own largest |entry|, the port's f32 rule of 2e-5
# unless stated. Every op(acc) is of order 1 before the chain subtracts 1, so
# each application rounds by ulps of 1 (6e-8) whatever the size the chain
# ends at, and the ops whose chains end small get a limit of their own:
#  exp, exp_fast: the chain creeps towards the fixed point 0 of e^x − 1 and
#   ends at 0.11, errors neither grow nor shrink there, sixteen roundings and
#   sixteen times __expf's 2 ulp against torch.exp add up to 2e-6 → 1e-4;
#  exp2: 2^x − 1 contracts by ln 2 per application and ends at 1.9e-3, the
#   damped roundings add up to 2e-7 → 1e-3;
#  fastexp2: its polynomial jumps by 5.5e-5 of its value where x·log2e
#   crosses a half-integer (p(0.5) against 2·p(−0.5)), and an input one ulp
#   apart (FMA in the kernel, two roundings in the plain version) lands on the
#   other side of such a jump for a few of the 2^26 elements; a few jumps on
#   a chain that ends at 0.11 → 1e-3.
# A kernel that applied its op 15 times is off by 5% (exp), 45% (exp2).
# Two chains end where no share can be taken. rsqrt1p − 1 converges
# quadratically to exactly 0, where kernel and plain version must be equal:
# it is held at chain 16 without the subtract as well, where it ends at 0.786.
# poly4 overflows to −inf on every element after three applications: the
# kernel must give −inf there too, and its finite values are held at chain 1.
EXP_REL_TOL = {op: 2e-5 for op in EXP_OP_WORK} | {
    "exp": 1e-4, "exp_fast": 1e-4, "exp2": 1e-3, "fastexp2": 1e-3}
# One application ends at order 1 for every op: the f32 rule, and for fastexp2
# one jump of its polynomial.
EXP_REL_TOL_ONE = {op: 2e-5 for op in EXP_OP_WORK} | {"fastexp2": 1e-4}

# The head-packing probe (benchmarks/attn_headpack.py): (n, s, d) as launched.
# (b) is (a)'s 1024 heads packed four at a time into block-diagonal operands.
QK_SHAPES = {"perhead_d8": (1024, 1024, 8), "blockdiag_hd32": (256, 4096, 32),
             "perhead_d128": (1024, 1024, 128)}
QK_HEADS = 4
# f32 sums of 1024-4096 x d exact bf16 products, in another order (and, on the
# tensor cores, through their own adder tree): a share of the largest entry.
QK_REL_TOL = 2e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def kernel_label(mangled: str) -> str:
    """``flash_bwd_mma_kernel<8>`` from the mangled name ptxas prints: the
    length-prefixed identifier that ends in ``_kernel`` (the anonymous
    namespace before it carries a hash with digits of its own), then its
    integer, bool and float template arguments."""
    import re

    for m in re.finditer(r"\d+(?=[A-Za-z_])", mangled):
        digits = m.group()
        for i in range(len(digits)):  # the length is some suffix of the digit run
            n = int(digits[i:])
            name = mangled[m.end():m.end() + n]
            if len(name) == n and name.endswith("_kernel"):
                t = re.match(r"I((?:L[a-z]\d+E|f)+)E", mangled[m.end() + n:])
                if t is None:
                    return name
                args = ["float" if a == "" else a for a in re.findall(r"L[a-z](\d+)E|f", t.group(1))]
                return f"{name}<{', '.join(args)}>"
    return mangled[:60]


def ptxas_report(log_text: str) -> list[dict]:
    """Registers and spill bytes of every kernel in an ``nvcc -Xptxas -v`` log."""
    import re

    entries, current = {}, None
    for line in log_text.splitlines():
        if m := re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line):
            current = m.group(1)
        elif current and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            entries.setdefault(current, {})["spill"] = (int(m.group(1)), int(m.group(2)))
        elif current and (m := re.search(r"Used (\d+) registers", line)):
            entries.setdefault(current, {})["registers"] = int(m.group(1))
    return [dict(kernel=kernel_label(name), registers=e.get("registers", -1),
                 spill_stores=e.get("spill", (0, 0))[0], spill_loads=e.get("spill", (0, 0))[1])
            for name, e in entries.items() if "registers" in e]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Wall time per call between CUDA events: device time plus any gap the
    host leaves while it prepares the next launch."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Every trace that came back without the kernels it had to hold: what was
# expected and what the trace held (printed in the kernel line).
PROFILER_SHORTFALLS: list[dict] = []


def device_events(run, expect: dict | None = None) -> tuple[list[tuple[str, float]], float]:
    """Runs ``run()`` under torch.profiler: the (name, µs) of every kernel and
    copy on the card, and the host's seconds around the run. With ``expect``
    ({substring of a kernel name: events}) the trace must hold exactly that
    many events whose name contains each key. A trace now and then comes back
    with no device events at all, or (the question of PERF.md §7) perhaps
    short of some kernels; either is recorded and the run profiled again, and
    a third such trace fails."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # Device events without the spans of user annotations (the optimizer's
        # ``Optimizer.step#AdamW.step`` shows on the device timeline too):
        # those are ranges over kernels, not kernels.
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        counts = {key: sum(key in name for name, _ in events) for key in (expect or {})}
        if events and counts == (expect or {}):
            return events, wall
        PROFILER_SHORTFALLS.append(dict(expected=expect or "any", got=counts, events=len(events)))
        log(f"  (torch.profiler trace held {len(events)} device events, {counts} against "
            f"{expect or 'any'}; profiling again)")
    raise AssertionError(f"torch.profiler: three traces without the expected kernels {expect}")


def device_ms(fn, iters: int = 20, per_call: dict | None = None) -> float:
    """Device time per call: the summed durations of the kernels (and copies)
    that ``iters`` calls ran, from torch.profiler's CUDA trace. ``per_call``
    ({substring of a kernel name: kernels per call}) makes the trace hold
    each named kernel of every call (see :func:`device_events`)."""
    fn()
    expect = {key: n * iters for key, n in per_call.items()} if per_call else None
    events, _ = device_events(lambda: [fn() for _ in range(iters)], expect)
    return sum(us for _, us in events) / iters / 1e3


def errors(got, ref) -> tuple[float, float]:
    """(max |got − ref|, the same as a share of max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / ref.float().abs().max().item()


def attention_times(bh: int, s: int, d: int, dtype) -> tuple[float, float]:
    """(bytes ms, operations ms) of one forward: each input read once and each
    output written once at the memory rate; QK+PV matmul FLOPs at the dtype's
    peak and one exp per (query, key) at the exp rate, the slower of the two."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = 4 * bh * s * d * elt
    t_ops = max(4 * bh * s * s * d / MATMUL_FLOPS_PER_S[dtype], bh * s * s / EXP_PER_S)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * t_ops


def bound(times: list[tuple[float, float]]) -> tuple[float, str]:
    """Least time of calls run one after another, and what bounds it."""
    t_bytes = sum(b for b, _ in times)
    t_ops = sum(o for _, o in times)
    return sum(max(b, o) for b, o in times), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels(fa) -> dict:
    """Kernel vs plain version at every main-path shape; timings."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    max_rel = dict(max_err)
    rows = []
    for n in (16, 32):  # 32: the CFG-doubled batch
        for block, s, c in ATTN_SHAPES:
            d = c // HEADS
            scale = 1.0 / math.sqrt(d)
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v = (torch.randn((n, HEADS, s, d), generator=g, device="cuda").to(dtype)
                           for _ in range(3))
                out = fa.flash_attention_fwd(q, k, v, scale)
                ref, ref_m, ref_s = fa.attention_reference(q, k, v, scale, with_stats=True)
                out_s, m, ssum = fa.flash_attention_fwd(q, k, v, scale, with_stats=True)
                torch.cuda.synchronize()
                err, rel = max(errors(out, ref), errors(out_s, ref))
                m_err = (m - ref_m).abs().max().item()
                s_rel = ((ssum - ref_s).abs() / ref_s).max().item()
                tag = f"{block} n={n} S={s} D={d} {str(dtype)[6:]}"
                check(rel <= REL_TOL[dtype],
                      f"{tag}: out err {err} is {rel} of max |out| > {REL_TOL[dtype]}")
                check(m_err <= M_ATOL, f"{tag}: stats m err {m_err}")
                check(s_rel <= SUM_RTOL, f"{tag}: stats sum rel err {s_rel}")
                max_err[dtype] = max(max_err[dtype], err)
                max_rel[dtype] = max(max_rel[dtype], rel)
                row = dict(block=block, n=n, bh=n * HEADS, s=s, d=d, dtype=str(dtype)[6:],
                           max_abs_err=err, max_rel_err=rel)
                calls = {"": lambda: fa.flash_attention_fwd(q, k, v, scale),
                         "plain_": lambda: fa.attention_reference(q, k, v, scale),
                         "library_": lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)}
                for key, fn in calls.items():
                    per_call = {"flash_fwd": 1} if key == "" else None
                    row[f"{key}ms"] = device_ms(fn, per_call=per_call)
                    row[f"{key}call_ms"] = call_ms(fn)
                row["bound_ms"], row["bound_by"] = bound([attention_times(n * HEADS, s, d, dtype)])
                rows.append(row)
                log(f"  {tag:<28} err {err:.1e} ({rel:.1e} of max)  device us:"
                    f" kernel {row['ms'] * 1e3:7.1f} plain {row['plain_ms'] * 1e3:7.1f} sdpa {row['library_ms'] * 1e3:7.1f}"
                    f" bound {row['bound_ms'] * 1e3:6.2f} ({row['bound_by']}) | per call us:"
                    f" kernel {row['call_ms'] * 1e3:6.1f} plain {row['plain_call_ms'] * 1e3:6.1f}"
                    f" sdpa {row['library_call_ms'] * 1e3:6.1f}")
    return dict(rows=rows, max_err=max_err, max_rel=max_rel)


def attention_bwd_times(bh: int, s: int, d: int, dtype) -> tuple[float, float]:
    """(bytes ms, operations ms) of one backward: q, k, v, out, g and the two
    stats read once, dQ, dK, dV written once at the memory rate; the five
    products (10·S²·D FLOPs per head) at the dtype's peak and one exp per
    (query, key) at the exp rate, the slower of the two. It counts the work,
    not the design: a backward that takes two exps per pair is held to one."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = 8 * bh * s * d * elt + 2 * bh * s * 4
    t_ops = max(10 * bh * s * s * d / MATMUL_FLOPS_PER_S[dtype], bh * s * s / EXP_PER_S)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * t_ops


def phase_bwd_kernel(fa) -> dict:
    """Backward kernel vs plain version at every training shape; timings."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    max_rel = dict(max_err)
    rows = []
    for px, n, shapes in ((32, 256, ATTN_SHAPES), (64, 32, ATTN_SHAPES_64),
                          (128, 2, ATTN_SHAPES_128)):
        for block, s, c in shapes:
            d = c // HEADS
            scale = 1.0 / math.sqrt(d)
            # batch of the comparison with the plain version (see PLAIN_SS_BYTES)
            n_plain = max(1, min(n, PLAIN_SS_BYTES // (HEADS * s * s * 4)))
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v, g = (torch.randn((n, HEADS, s, d), generator=gen, device="cuda")
                              .to(dtype) for _ in range(4))
                out, m, ssum = fa.flash_attention_fwd(q, k, v, scale, with_stats=True)
                small = [t[:n_plain].contiguous() for t in (q, k, v, out, g)]
                stats = [t[:n_plain * HEADS].contiguous() for t in (m, ssum)]
                qs, ks, vs, os_, gs = small
                # the stats-mode forward that feeds the backward, at this shape
                ref_o, ref_m, ref_s = fa.attention_reference(qs, ks, vs, scale, with_stats=True)
                fwd_err, fwd_rel = errors(os_, ref_o)
                check(fwd_rel <= REL_TOL[dtype], f"{px}px {block} S={s} {dtype}: forward err "
                      f"{fwd_err} is {fwd_rel} of max |out| > {REL_TOL[dtype]}")
                check((stats[0] - ref_m).abs().max().item() <= M_ATOL
                      and ((stats[1] - ref_s).abs() / ref_s).max().item() <= SUM_RTOL,
                      f"{px}px {block} S={s}: forward stats")
                del ref_o, ref_m, ref_s
                ref = fa.attention_backward_reference(qs, ks, vs, os_, *stats, gs, scale)
                got = fa.flash_attention_bwd(qs, ks, vs, os_, *stats, gs, scale)
                # without stats, and with a cotangent that is not contiguous
                g_t = gs.transpose(2, 3).contiguous().transpose(2, 3)
                got_ns = fa.flash_attention_bwd(qs, ks, vs, os_, None, None, g_t, scale)
                torch.cuda.synchronize()
                both = [max(errors(a, r), errors(b, r)) for a, b, r in zip(got, got_ns, ref)]
                errs, rels = [e for e, _ in both], [r for _, r in both]
                tag = f"{px}px {block} n={n} S={s} D={d} {str(dtype)[6:]}"
                for name, err, rel in zip(("dq", "dk", "dv"), errs, rels):
                    check(rel <= REL_TOL[dtype], f"{tag}: {name} err {err} is {rel} of "
                          f"max |{name}| > {REL_TOL[dtype]}")
                check(all(bool(torch.isfinite(a).all()) for a in got), f"{tag}: finite")
                max_err[dtype] = max(max_err[dtype], *errs)
                max_rel[dtype] = max(max_rel[dtype], *rels)
                del ref, got, got_ns
                row = dict(px=px, block=block, n=n, bh=n * HEADS, s=s, d=d,
                           dtype=str(dtype)[6:], max_abs_err=max(errs),
                           err_dq=errs[0], err_dk=errs[1], err_dv=errs[2],
                           rel_dq=rels[0], rel_dk=rels[1], rel_dv=rels[2],
                           fwd_err=fwd_err, fwd_rel=fwd_rel, plain_bh=n_plain * HEADS)
                qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
                sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
                calls = {
                    "": lambda: fa.flash_attention_bwd(q, k, v, out, m, ssum, g, scale),
                    "plain_": lambda: fa.attention_backward_reference(
                        qs, ks, vs, os_, *stats, gs, scale),
                    "library_": lambda: torch.autograd.grad(
                        sdpa_out, (qg, kg, vg), g, retain_graph=True),
                }
                for key, fn in calls.items():
                    per_call = {"flash_bwd": BWD_KERNELS[dtype]} if key == "" else None
                    row[f"{key}ms"] = device_ms(fn, iters=5, per_call=per_call)
                    row[f"{key}call_ms"] = call_ms(fn, iters=10, warmup=1)
                row["bound_ms"], row["bound_by"] = bound(
                    [attention_bwd_times(n * HEADS, s, d, dtype)])
                rows.append(row)
                log(f"  {tag:<34} err dq {errs[0]:.1e} dk {errs[1]:.1e} dv {errs[2]:.1e}"
                    f" (of max: {rels[0]:.1e} {rels[1]:.1e} {rels[2]:.1e}; fwd {fwd_rel:.1e})"
                    f"  device us: kernel {row['ms'] * 1e3:8.1f} (per call, CUDA events:"
                    f" {row['call_ms'] * 1e3:8.1f})"
                    f" plain(bh={row['plain_bh']}) {row['plain_ms'] * 1e3:8.1f}"
                    f" sdpa-bwd {row['library_ms'] * 1e3:8.1f}"
                    f" bound {row['bound_ms'] * 1e3:7.2f} ({row['bound_by']})")
                del sdpa_out, qg, kg, vg, q, k, v, g, out, m, ssum, small, stats
            torch.cuda.empty_cache()
    return dict(rows=rows, max_err=max_err, max_rel=max_rel)


def chain_errors(got, ref) -> tuple[float, float, float]:
    """(max |got − ref| over the entries where ref is finite, the same as a
    share of the largest finite |ref|, share of finite entries). Where ref is
    not finite (poly4 overflows to −inf), got must equal it; where ref is 0
    throughout (rsqrt1p's chain), any difference is an infinite share."""
    finite = torch.isfinite(ref)
    check(bool(((got == ref) | (torch.isnan(got) & torch.isnan(ref)))[~finite].all()),
          "non-finite entries differ")
    if not bool(finite.any()):
        return 0.0, 0.0, 0.0
    err = (got[finite] - ref[finite]).abs().max().item()
    largest = ref[finite].abs().max().item()
    rel = err / largest if largest > 0 else (0.0 if err == 0 else math.inf)
    return err, rel, finite.float().mean().item()


def phase_exp_chain(kp, probes) -> dict:
    """exp_chain vs its plain version at the probe's full array, every op."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    # softmax-like domain: logits − max <= 0 (exp_micro.py:53)
    x = -torch.randn(EXP_SHAPE, generator=gen, device="cuda").abs() * 5
    n = x.numel()
    bytes_ms = 1e3 * 2 * n * 4 / HBM_BYTES_PER_S
    rows = []
    for op in kp.OPS:
        got = kp.exp_chain(x, op, EXP_CHAIN)
        ref = kp.exp_chain_plain(x, op, EXP_CHAIN)
        torch.cuda.synchronize()
        err, rel, finite = chain_errors(got, ref)
        # one application through the runtime-loop instantiation, on a slice
        err1, rel1, _ = chain_errors(kp.exp_chain(x[:4], op, 1), kp.exp_chain_plain(x[:4], op, 1))
        del got, ref
        held = [("chain 16", err, rel, EXP_REL_TOL[op]), ("chain 1", err1, rel1, EXP_REL_TOL_ONE[op])]
        if op == "rsqrt1p":  # its chain ends at 0: the unrolled chain without the subtract too
            err_ns, rel_ns, _ = chain_errors(
                kp.exp_chain(x, op, EXP_CHAIN, subtract=False),
                kp.exp_chain_plain(x, op, EXP_CHAIN, subtract=False))
            held.append(("chain 16 without the subtract", err_ns, rel_ns, EXP_REL_TOL[op]))
            log(f"  rsqrt1p chain 16 without the subtract: err {err_ns:.1e} "
                f"({rel_ns:.1e} of max |ref|)")
        for name, e, r, tol in held:
            check(r <= tol, f"exp_chain {op} {name}: err {e} is {r} of max |ref| > {tol}")
        sfu, fma = EXP_OP_WORK[op]
        ops_ms = 1e3 * n * EXP_CHAIN * max(sfu / EXP_PER_S, fma / FMA_PER_S)
        row = dict(op=op, shape=list(EXP_SHAPE), chain=EXP_CHAIN, max_abs_err=err,
                   max_rel_err=rel, max_rel_err_chain1=rel1, rel_tol=EXP_REL_TOL[op],
                   finite_share=finite,
                   ms=device_ms(lambda: kp.exp_chain(x, op, EXP_CHAIN), iters=20),
                   plain_ms=device_ms(lambda: kp.exp_chain_plain(x, op, EXP_CHAIN), iters=3),
                   library_ms=device_ms(lambda: x.clone(), iters=20) if op == "copy" else None,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        rows.append(row)
    copy_ms = rows[0]["ms"]
    for row in rows:
        # the probe's reading: cost of one application off the slope against copy
        row["per_application_ps"] = (row["ms"] - copy_ms) * 1e9 / (EXP_CHAIN * n)
        row["applications_per_s"] = EXP_CHAIN * n / row["ms"] * 1e3
        log(f"  {row['op']:9s} err {row['max_abs_err']:.1e} ({row['max_rel_err']:.1e} of "
            f"max |ref|, limit {row['rel_tol']:.0e}; one application {row['max_rel_err_chain1']:.1e}; "
            f"finite {row['finite_share']:.3f})  device ms: kernel {row['ms']:.4f} "
            f"plain {row['plain_ms']:8.3f} bound {row['bound_ms']:.4f} ({row['bound_by']})"
            f"  {row['applications_per_s'] / 1e12:.2f} T applications/s; per application "
            f"above copy: {row['per_application_ps']:.3f} ps"
            + (f"  x.clone() {row['library_ms']:.4f}" if row["library_ms"] else ""))
    # The compiler must not fold a chain. At chain 16 poly4 hides behind the
    # memory traffic, so it is timed at chain 64 too (the runtime-loop
    # instantiation): its five instructions per application must cost more
    # than mul2's one, and four times the applications more than the 16.
    poly64 = device_ms(lambda: kp.exp_chain(x, "poly4", 64), iters=10)
    mul64 = device_ms(lambda: kp.exp_chain(x, "mul2", 64), iters=10)
    ms = {r["op"]: r["ms"] for r in rows}
    log(f"  chain 64: poly4 {poly64:.4f} ms, mul2 {mul64:.4f} ms ({poly64 / mul64:.2f}x; "
        f"{poly64 / ms['poly4']:.2f}x of poly4 at chain 16); chain 16: poly4 / mul2 "
        f"{ms['poly4'] / ms['mul2']:.3f}, exp / copy {ms['exp'] / ms['copy']:.3f}")
    check(poly64 > 1.3 * mul64 and poly64 > 2.0 * ms["poly4"],
          f"poly4 at chain 64 ({poly64} ms) against mul2's ({mul64} ms) and its own at "
          f"chain 16 ({ms['poly4']} ms): the chain was folded")
    check(ms["exp"] > 1.2 * ms["copy"], "exp's chain costs no more than copy's")
    del x
    torch.cuda.empty_cache()
    rel = probes.fastexp2_max_rel_err("cuda")
    log(f"  fastexp2 max_rel_err vs exp on [-80, 0]: {rel:.2e}")
    check(rel < 1e-3, f"fastexp2 accuracy {rel}")
    return dict(rows=rows, fastexp2_max_rel_err=rel, poly4_chain64_ms=poly64,
                mul2_chain64_ms=mul64)


def phase_qk_rowsum(kp) -> dict:
    """qk_rowsum vs its plain version at the probe's three shapes."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    k8 = qt8 = None
    for name, (n, s, d) in QK_SHAPES.items():
        if name == "blockdiag_hd32":
            k, qt = kp.block_diagonal_pack(k8, qt8, QK_HEADS)
            check(tuple(k.shape) == (n, s, d), f"packed shape {tuple(k.shape)}")
        else:
            k = torch.randn((n, s, d), generator=gen, device="cuda").to(torch.bfloat16)
            qt = torch.randn((n, d, s), generator=gen, device="cuda").to(torch.bfloat16)
            if name == "perhead_d8":
                k8, qt8 = k, qt
        ref = kp.qk_rowsum_plain(k, qt)
        row = dict(shape=name, n=n, s=s, d=d, rel_tol=QK_REL_TOL)
        if name == "blockdiag_hd32":
            # the diagonal blocks hold the heads' own logits: same sums as (a)
            per_head = kp.qk_rowsum_plain(k8, qt8).reshape(n, 1, s)
            check(errors(ref, per_head)[1] <= QK_REL_TOL, "packed operands against per-head sums")
        got = kp.qk_rowsum(k, qt)
        torch.cuda.synchronize()
        row["max_abs_err"], row["max_rel_err"] = errors(got, ref)
        check(row["max_rel_err"] <= QK_REL_TOL, f"qk_rowsum {name}: err {row['max_abs_err']} is "
              f"{row['max_rel_err']} of max |out| > {QK_REL_TOL}")
        row["ms"] = device_ms(lambda: kp.qk_rowsum(k, qt), iters=20)
        del ref, got
        # The one-call yardstick writes the s x s logits to device memory, so it
        # walks n in chunks that keep them under 1 GiB in bf16 (as the plain
        # version does in f32): the time is the sum over the chunks.
        chunk = max(1, min(n, 2**30 // (2 * s * s)))

        def library():
            return [torch.bmm(k[i:i + chunk], qt[i:i + chunk]).sum(1, dtype=torch.float32)
                    for i in range(0, n, chunk)]

        row["plain_ms"] = device_ms(lambda: kp.qk_rowsum_plain(k, qt), iters=2)
        row["library_ms"] = device_ms(library, iters=3)
        row["library_chunk"] = chunk
        row["flops"] = 2.0 * n * s * s * d
        row["bytes"] = 2 * n * s * d * 2 + n * s * 4
        bytes_ms = 1e3 * row["bytes"] / HBM_BYTES_PER_S
        ops_ms = 1e3 * row["flops"] / MATMUL_FLOPS_PER_S[torch.bfloat16]
        row["bound_ms"], row["bound_by"] = max(bytes_ms, ops_ms), (
            "bytes" if bytes_ms >= ops_ms else "operations")
        rows.append(row)
        log(f"  {name:15s} (n={n}, s={s}, d={d}) err {row['max_abs_err']:.1e} "
            f"({row['max_rel_err']:.1e} of max)  device ms: kernel {row['ms']:.4f} "
            f"({row['flops'] / row['ms'] / 1e9:.1f} TFLOP/s) "
            f"plain {row['plain_ms']:.3f} bmm+sum(chunks of {chunk}) {row['library_ms']:.3f} "
            f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
        del k, qt
        torch.cuda.empty_cache()
    ms = {r["shape"]: r["ms"] for r in rows}
    ratio = ms["blockdiag_hd32"] / ms["perhead_d8"]
    depth = ms["perhead_d128"] / ms["perhead_d8"]
    verdict = "REJECT head-packing" if ratio > 1.1 else "ACCEPT head-packing"
    log(f"  packed_over_perhead {ratio:.2f}, d128_over_d8 {depth:.2f}: {verdict}")
    return dict(rows=rows, packed_over_perhead=ratio, d128_over_d8=depth, verdict=verdict)


def phase_unet(fa, weights, unet_mod, config) -> None:
    """Full-width Config-D forward: f32 card vs CPU, bf16 finite, 6 launches each."""
    import dataclasses

    f32 = dataclasses.replace(config, compute_dtype="float32")
    sd = weights.init_params(config, 0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((16, 32, 32, 3)).astype(np.float32))
    t = torch.from_numpy(rng.integers(1, 1000, 16))
    cpu = unet_mod.build_model(f32, device="cpu", state_dict=sd)
    gpu = unet_mod.build_model(f32, device="cuda", state_dict=sd)
    bf16 = unet_mod.build_model(config, device="cuda", state_dict=sd)
    with torch.inference_mode():
        ref = cpu(x, t)
        before = fa.flash_attention_fwd.launches
        out = gpu(x.cuda(), t.cuda()).cpu()
        check(fa.flash_attention_fwd.launches - before == 6, "f32 forward: 6 launches")
        err = (out - ref).abs().max().item()
        log(f"  f32 forward card vs cpu: max abs err {err:.2e} (atol 1e-3)")
        check(err <= 1e-3, f"f32 UNet forward err {err}")
        before = fa.flash_attention_fwd.launches
        outb = bf16(x.cuda(), t.cuda()).cpu()
        check(fa.flash_attention_fwd.launches - before == 6, "bf16 forward: 6 launches")
        check(bool(torch.isfinite(outb).all()) and outb.shape == (16, 32, 32, 3), "bf16 forward")
        log(f"  bf16 forward finite; max |bf16 - f32 cpu| {(outb - ref).abs().max().item():.3e}")
        xc, tc = x.cuda(), t.cuda()
        for name, model in (("bf16", bf16), ("f32", gpu)):
            ms = call_ms(lambda: model(xc, tc), iters=20)
            log(f"  {name} forward n=16: {ms:.3f} ms per forward (CUDA events); profiler, "
                f"one forward: {json.dumps(profile_forward(model, xc, tc))}")

    # Sampler on the card vs the CPU, same weights and injected noise.
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion

    draws = [rng.standard_normal((2, 32, 32, 3)).astype(np.float32) for _ in range(6)]
    outs = []
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        d = Diffusion(noise_steps=1000, img_size=32, device=dev)
        outs.append(d.sample_ddim(model, 2, 3, steps=5, eta=1.0,
                                  noise_fn=lambda shape, step: torch.from_numpy(draws[step]))
                    .cpu().numpy().astype(np.int16))
    diff = np.abs(outs[0] - outs[1])
    log(f"  DDIM-5 card vs cpu (uint8): max diff {diff.max()}, share differing {np.mean(diff > 0):.4f}")
    check(diff.max() <= 1 and np.mean(diff > 0) <= 0.02, "DDIM-5 card vs cpu")


def phase_train_step_vs_cpu(fa, weights, config) -> None:
    """One f32 train step at full width (n=16): the card against the CPU with
    the same weights, batch, timesteps and noise."""
    import dataclasses

    from aliasfree_diffusion_models_pytorch_tpu_torch import train as train_mod
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion

    f32 = dataclasses.replace(config, compute_dtype="float32", batch_size=16)
    sd = weights.init_params(f32, 0)
    rng = np.random.default_rng(1)
    batch = torch.from_numpy(rng.uniform(-1, 1, (16, 32, 32, 3)).astype(np.float32))
    t = torch.from_numpy(rng.integers(1, 1000, 16))
    noise = torch.from_numpy(rng.standard_normal((16, 32, 32, 3)).astype(np.float32))
    results = {}
    for dev in ("cpu", "cuda"):
        model, state = train_mod.create_train_state(f32, device=dev, state_dict=sd)
        step = train_mod.make_train_step(
            model, f32, Diffusion(noise_steps=1000, img_size=32, device=dev))
        fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
        _, loss = step(state, batch.to(dev), t=t.to(dev), noise=noise.to(dev))
        if dev == "cuda":
            counts = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
            check(counts == (6, 6), f"f32 train step: launches {counts}, expected (6, 6)")
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        results[dev] = (float(loss), grads,
                        {n: p.detach().cpu() for n, p in state.params.items()})
    (loss_c, grads_c, params_c), (loss_g, grads_g, params_g) = results["cpu"], results["cuda"]
    check(abs(loss_c - loss_g) <= 1e-4 * abs(loss_c), f"f32 step loss {loss_g} vs cpu {loss_c}")
    # Gradients: f32 sums in another order through ~40 layers (cuDNN against
    # the CPU's convolutions): each tensor within 2e-3 of its own largest entry.
    worst, worst_name = 0.0, ""
    for name, gc in grads_c.items():
        rel = ((grads_g[name] - gc).abs().max() / gc.abs().max().clamp_min(1e-12)).item()
        if rel > worst:
            worst, worst_name = rel, name
    log(f"  f32 train step card vs cpu: loss {loss_g:.6f} vs {loss_c:.6f}; worst gradient "
        f"error {worst:.2e} of its tensor's max ({worst_name}; limit 2e-3); 6 + 6 launches")
    check(worst <= 2e-3, f"f32 step gradient {worst_name}: {worst}")
    # After AdamW's first update every parameter moved by at most lr (3e-4).
    moved = max((params_g[n] - sd[n]).abs().max().item() for n in params_g)
    check(0 < moved <= 3.1e-4, f"f32 step: parameters moved by {moved}")


def profile_forward(model, x, t) -> dict:
    """Device time by kernel family for one forward (torch.profiler)."""
    model(x, t)
    events, wall = device_events(lambda: model(x, t), {"flash_fwd": 6})
    total = sum(us for _, us in events)
    attn = sum(us for name, us in events if "flash_fwd" in name)
    return {"wall_ms": round(wall * 1e3, 3), "device_busy_ms": round(total / 1e3, 3),
            "device_kernels": len(events), "flash_fwd_ms": round(attn / 1e3, 4)}


def phase_cli(fa, cli) -> list[dict]:
    os.makedirs(OUT_DIR, exist_ok=True)
    common = ["--variant", "3", "--image-size", "32", "--image-channels", "3",
              "--compute-dtype", "bfloat16", "--f-kernel", "3", "--f-beta", "2",
              "--n", "16", "--random-weights", "--seed", "0", "--device", "cuda"]
    runs = [
        ("ddpm1000", [], 6 * 999),
        ("ddim50", ["--ddim-steps", "50"], 6 * 50),
        ("ddim50_theta90", ["--ddim-steps", "50", "--theta", "90"], 6 * 50),
        ("ddim20_cfg3", ["--ddim-steps", "20", "--num-classes", "10", "--label", "3",
                         "--cfg-scale", "3.0"], 6 * 20),
    ]
    results = []
    for name, extra, expect in runs:
        args = cli.build_parser().parse_args(
            ["sample", *common, *extra, "--out", os.path.join(OUT_DIR, f"{name}.png")])
        torch.cuda.synchronize()
        fa.flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        final = cli.run_sample(args)
        wall = time.perf_counter() - t0
        launches = fa.flash_attention_fwd.launches
        log(f"  {name}: {wall:.2f} s wall, {launches} flash_fwd launches, "
            f"output {final.shape} {final.dtype}, pixel std {final.std():.1f}")
        check(launches == expect, f"{name}: {launches} launches, expected {expect}")
        check(final.shape == (16, 32, 32, 3) and final.dtype == np.uint8, f"{name}: output")
        check(final.std() > 0, f"{name}: constant output")
        results.append(dict(run=name, wall_s=wall, launches=launches))
    return results


TRAIN_FLAGS = ["--variant", "3", "--image-size", "32", "--batch-size", "256",
               "--image-channels", "3", "--compute-dtype", "bfloat16", "--f-kernel", "3",
               "--f-beta", "2", "--dataset", "CIFAR10", "--image-gen-per-epoch", "0",
               "--device", "cuda"]


def phase_cli_train(fa, cli) -> list[dict]:
    """The training path through the CLI: train, sample from its checkpoint,
    and a short run with every opt-in optimizer knob."""
    import shutil

    root = os.path.join(OUT_DIR, "train_root")
    shutil.rmtree(root, ignore_errors=True)
    results = []

    def counted(name, fn, expect):
        torch.cuda.synchronize()
        fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
        check(counts == expect, f"{name}: launches (fwd, bwd) {counts}, expected {expect}")
        results.append(dict(run=name, wall_s=wall, fwd_launches=counts[0],
                            bwd_launches=counts[1],
                            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))
        return value, wall

    # 512 synthetic images at batch 256: 2 steps an epoch, 10 steps.
    args = cli.build_parser().parse_args(["train", *TRAIN_FLAGS, "--epochs", "5", "--root", root])
    losses, wall = counted("train_10_steps", lambda: cli.run_train(args), (60, 60))
    log(f"  train 10 steps at batch 256: {wall:.2f} s wall (first steps included), epoch mean "
        f"losses {[round(x, 4) for x in losses]}, 60 + 60 launches, "
        f"peak memory {results[-1]['peak_mem_gb']:.2f} GB")
    check(len(losses) == 5 and all(math.isfinite(x) for x in losses), f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    ckpt = os.path.join(root, "models", "DDPM_Uncondtional_CIFAR10_3", "ckpt_CIFAR10_3.npz")
    check(os.path.exists(ckpt), f"no checkpoint at {ckpt}")
    results[-1]["epoch_losses"] = losses

    sample_args = cli.build_parser().parse_args(
        ["sample", "--variant", "3", "--image-size", "32", "--image-channels", "3",
         "--compute-dtype", "bfloat16", "--f-kernel", "3", "--f-beta", "2", "--dataset",
         "CIFAR10", "--device", "cuda", "--ddim-steps", "20", "--n", "16", "--root", root,
         "--out", os.path.join(OUT_DIR, "trained_ddim20.png")])
    final, wall = counted("sample_trained_ddim20", lambda: cli.run_sample(sample_args), (120, 0))
    log(f"  sample from the trained checkpoint, DDIM-20: {wall:.2f} s, pixel std {final.std():.1f}")
    check(final.shape == (16, 32, 32, 3) and final.dtype == np.uint8 and final.std() > 0,
          "sample from the trained checkpoint")

    # Every opt-in knob: 2 epochs = 4 micro-batches = 2 updates (lr 0, then lr).
    knob_root = os.path.join(OUT_DIR, "train_knobs_root")
    shutil.rmtree(knob_root, ignore_errors=True)
    args = cli.build_parser().parse_args(
        ["train", *TRAIN_FLAGS, "--epochs", "2", "--root", knob_root, "--use-ema",
         "--grad-accum", "2", "--grad-clip", "1.0", "--lr-schedule", "warmup_cosine",
         "--warmup-steps", "1"])
    losses, wall = counted("train_knobs_4_steps", lambda: cli.run_train(args), (24, 24))
    log(f"  train with EMA, accumulation 2, clip 1.0, warmup-cosine: {wall:.2f} s, "
        f"losses {[round(x, 4) for x in losses]}")
    check(all(math.isfinite(x) for x in losses), f"knob run losses {losses}")
    return results


STUDY_MODEL_FLAGS = ["--variant", "3", "--image-size", "32", "--image-channels", "3",
                     "--compute-dtype", "bfloat16", "--f-kernel", "3", "--f-beta", "2",
                     "--dataset", "CIFAR10", "--device", "cuda", "--noise-steps", "200"]
STUDY_PROBE_ITERS = {"exp": 20, "headpack": 10}
# Metric dicts of `eval` on the card against the CPU: the features agree to
# f32 rounding (three convolutions with TF32 off), and the metrics are float64
# functions of them; 32 samples in 256 dimensions leave both covariances
# singular, so the matrix square root may amplify that rounding somewhat.
# The absolute floor is for the KID's spread, which is 0 up to float64 noise
# when every subset is the whole set.
EVAL_RTOL, EVAL_ATOL = 1e-5, 1e-9
# Inception features and logits on the card (TF32 off) against the CPU: f32
# sums in another order through 94 convolutions, as a share of the largest entry.
INCEPTION_REL_TOL = 1e-5


def phase_study(fa, kp, cli) -> dict:
    """The study path through the CLI: probes, run, rotate, shift, eval, and
    one Inception forward."""
    import shutil

    from aliasfree_diffusion_models_pytorch_tpu_torch import eval_inception, probes, tasks
    from aliasfree_diffusion_models_pytorch_tpu_torch.data import get_data
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
    from aliasfree_diffusion_models_pytorch_tpu_torch.eval import full_float32
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils.io import save_dataset_images

    root = os.path.join(OUT_DIR, "study_root")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    parse = cli.build_parser().parse_args
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd, kp.exp_chain, kp.qk_rowsum)
    results: dict = {}

    def counted(name, fn):
        """Runs fn with every launch counter set to 0 just before; returns its
        value and records (fwd, bwd, exp_chain, qk_rowsum) launches and wall."""
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results[name] = dict(wall_s=wall, launches=[c.launches for c in counters])
        return value, results[name]["launches"], wall

    # probes: each op or shape launches its kernel WARMUP + iters times
    iters = STUDY_PROBE_ITERS["exp"]
    exp_res, counts, wall = counted("probe_exp", lambda: cli.run_probe(parse(
        ["probe", "exp", "--iters", str(iters), "--out", os.path.join(root, "exp_micro.json")])))
    expect = len(kp.OPS) * (probes.WARMUP + iters) + 1  # + the accuracy line's launch
    check(counts == [0, 0, expect, 0], f"probe exp: launches {counts}, expected exp_chain {expect}")
    check(set(exp_res["ms"]) == set(kp.OPS) and exp_res["fastexp2_max_rel_err"] < 1e-3,
          "probe exp result")
    log(f"  probe exp: {wall:.2f} s, {expect} exp_chain launches")
    iters = STUDY_PROBE_ITERS["headpack"]
    head_res, counts, wall = counted("probe_headpack", lambda: cli.run_probe(parse(
        ["probe", "headpack", "--iters", str(iters),
         "--out", os.path.join(root, "attn_headpack.json")])))
    per = probes.WARMUP + iters
    # flash forward: the forward timing and the forward of forward+backward
    check(counts == [2 * per, per, 0, 3 * per], f"probe headpack: launches {counts}, expected "
          f"{[2 * per, per, 0, 3 * per]}")
    for key in ("perhead_d8_ms", "blockdiag_hd32_ms", "perhead_d128_ms", "flash_fwd_ms",
                "flash_fwdbwd_ms", "packed_over_perhead", "d128_over_d8", "verdict"):
        check(key in head_res, f"probe headpack: no {key}")
    log(f"  probe headpack: {wall:.2f} s, {3 * per} qk_rowsum launches, verdict {head_res['verdict']}")

    # run: 512 synthetic images at batch 256 = 2 train steps; 200 noise steps.
    res, counts, wall = counted("run", lambda: cli.run_ddpm(parse(
        ["run", *STUDY_MODEL_FLAGS, "--batch-size", "256", "--image-gen-per-epoch", "0",
         "--epochs", "1", "--gen-total", "32", "--gen-per-batch", "16", "--root", root])))
    sampler = 6 * 199
    # smoke forward + 2 train steps + (six-image demo, revert, two generation chunks)
    check(counts == [6 + 12 + 4 * sampler, 12, 0, 0], f"run: launches {counts}, expected "
          f"{[6 + 12 + 4 * sampler, 12, 0, 0]}")
    for key in ("settings_path", "loss_csv"):
        check(os.path.exists(res[key]), f"run: no {res[key]}")
    check(os.path.exists(res["checkpoint"] + ".npz"), "run: no checkpoint")
    pngs = [f for f in os.listdir(res["gen_dir"]) if f.endswith(".png")]
    check(len(pngs) == 32, f"run: {len(pngs)} generated PNGs, expected 32")
    check(os.path.exists(res["gen_dir"] + "_collage_0.png"), "run: no collage")
    check(len(res["loss_all"]) == 1 and math.isfinite(res["loss_all"][0]), "run: loss")
    log(f"  run: {wall:.2f} s, loss {res['loss_all'][0]:.4f}, launches fwd {counts[0]} bwd "
        f"{counts[1]}, 32 PNGs in {res['gen_dir']}")

    # rotate and shift: every member of a sweep must start from the same noise
    # and cost the same launches. A spy on the samplers' noise source records
    # each member's initial latent and the launch count at that moment.
    firsts: list[tuple[torch.Tensor, int]] = []
    plain_noise = Diffusion._noise

    def spy(self, shape, step, generator, noise_fn):
        out = plain_noise(self, shape, step, generator, noise_fn)
        if step == 0:
            firsts.append((out.clone(), fa.flash_attention_fwd.launches))
        return out

    sweep_path = os.path.join(root, "rotation_sweep.npz")
    sweeps = {
        "rotate": lambda: cli.run_rotate(parse(
            ["rotate", *STUDY_MODEL_FLAGS, "--root", root, "--thetas=-90:90:3",
             "--out", os.path.join(root, "rotation"), "--save-sweep", sweep_path])),
        "shift": lambda: cli.run_shift(parse(
            ["shift", *STUDY_MODEL_FLAGS, "--root", root, "--shifts=-8,0,8",
             "--out", os.path.join(root, "shift_sweep.png")])),
    }
    for name, fn in sweeps.items():
        firsts.clear()
        Diffusion._noise = spy
        try:
            value, counts, wall = counted(name, fn)
        finally:
            Diffusion._noise = plain_noise
        check(counts == [3 * sampler, 0, 0, 0], f"{name}: launches {counts}")
        check(len(firsts) == 3, f"{name}: {len(firsts)} samplings, expected 3")
        check(all(torch.equal(firsts[0][0], f) for f, _ in firsts[1:]),
              f"{name}: the members did not start from the same noise")
        starts = [c for _, c in firsts] + [counts[0]]
        per_member = [b - a for a, b in zip(starts, starts[1:])]
        check(per_member == [sampler] * 3, f"{name}: launches per member {per_member}")
        log(f"  {name}: {wall:.2f} s, {counts[0]} launches, {per_member} per member, "
            f"same initial noise for all three")
        if name == "rotate":
            check(os.path.exists(value), f"rotate: no {value}")
            sweep = tasks.load_rotation_sweep(sweep_path)
            check(sweep["finals"].shape == (3, 1, 32, 32, 3)
                  and sweep["finals"].dtype == np.uint8, f"sweep finals {sweep['finals'].shape}")
            check(not np.array_equal(sweep["finals"][0], sweep["finals"][2]),
                  "rotate: -90 and +90 gave the same image")
        else:
            check(len(value) == 3 and value[0].shape == (4, 32, 32, 3), "shift outputs")
            check(os.path.exists(os.path.join(root, "shift_sweep.png")), "no shift_sweep.png")

    # eval: the 32 generated PNGs against 32 exported training PNGs.
    _, dataset = get_data("CIFAR10", None, 32, 256, image_channels=3, seed=42)
    orig_dir = os.path.join(root, "images", "original", "CIFAR10")
    save_dataset_images(orig_dir, dataset.images[:32])
    metrics = {}
    for dev in ("cuda", "cpu"):
        metrics[dev], _, wall = counted(f"eval_{dev}", lambda: cli.run_eval(parse(
            ["eval", res["gen_dir"], orig_dir, "--device", dev,
             "--save", os.path.join(root, f"eval_{dev}.txt")])))
        log(f"  eval --device {dev}: {wall:.2f} s, {json.dumps(metrics[dev])}")
    check(list(metrics["cuda"]) == list(metrics["cpu"]), "eval: keys differ")
    check(metrics["cuda"]["feature_space"] == "random-conv-v2", "eval: feature space")
    worst = 0.0
    for key, a in metrics["cuda"].items():
        if isinstance(a, float):
            b = metrics["cpu"][key]
            check(math.isfinite(a), f"eval: {key} = {a}")
            check(abs(a - b) <= EVAL_ATOL + EVAL_RTOL * max(abs(a), abs(b)),
                  f"eval: {key} card {a} vs cpu {b}")
            worst = max(worst, abs(a - b) / max(abs(a), abs(b), 1e-30)
                        if abs(a - b) > EVAL_ATOL else 0.0)
    log(f"  eval card vs cpu: worst relative difference {worst:.2e} (limit {EVAL_RTOL})")
    results["eval_metrics"] = metrics["cuda"]
    results["eval_worst_rel"] = worst

    # One Inception-v3 forward at batch 16, seeded random weights, f32.
    params = eval_inception.params_from_state_dict(eval_inception.random_state_dict(0))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-1, 1, (16, 3, 299, 299)).astype(np.float32))
    with torch.inference_mode(), full_float32():
        t0 = time.perf_counter()
        ref = eval_inception.inception_forward(params, x)
        cpu_s = time.perf_counter() - t0
        on_card = {m: {leaf: t.cuda() for leaf, t in leaves.items()} for m, leaves in params.items()}
        x_card = x.cuda()
        got = eval_inception.inception_forward(on_card, x_card)
        torch.cuda.synchronize()
        card_ms = call_ms(lambda: eval_inception.inception_forward(on_card, x_card), iters=5)
    rels = []
    for name, g, r in zip(("features", "logits"), got, ref):
        check(tuple(g.shape) == ((16, 2048) if name == "features" else (16, 1008)), name)
        err, rel = errors(g.cpu(), r)
        check(rel <= INCEPTION_REL_TOL, f"inception {name}: err {err} is {rel} of max")
        rels.append(rel)
    log(f"  inception forward, batch 16, f32: card vs cpu features {rels[0]:.1e} logits "
        f"{rels[1]:.1e} of max (limit {INCEPTION_REL_TOL}); card {card_ms:.1f} ms per forward "
        f"(CUDA events), cpu {cpu_s:.1f} s")
    results["inception"] = dict(rel_features=rels[0], rel_logits=rels[1], card_ms=card_ms)
    results["probe_exp_result"] = exp_res
    results["probe_headpack_result"] = head_res
    return results


def profile_step(step, state, batch) -> dict:
    """Device time and kernel count of one train step (torch.profiler)."""
    events, wall = device_events(lambda: step(state, batch)[1].item(),
                                 {"flash_fwd": 6, "flash_bwd": 6 * BWD_KERNELS[torch.bfloat16]})
    busy = {"total": 0.0, "flash_fwd": 0.0, "flash_bwd": 0.0}
    by_name: dict[str, list] = {}  # kernel name -> [device us, launches]
    for name, us in events:
        busy["total"] += us
        entry = by_name.setdefault(name, [0.0, 0])
        entry[0] += us
        entry[1] += 1
        for key in ("flash_fwd", "flash_bwd"):
            if key in name:
                busy[key] += us
    kernels = len(events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"profiled_wall_ms": round(wall * 1e3, 3),
            "device_busy_ms": round(busy["total"] / 1e3, 3), "device_kernels": kernels,
            "flash_fwd_ms": round(busy["flash_fwd"] / 1e3, 4),
            "flash_bwd_ms": round(busy["flash_bwd"] / 1e3, 4),
            "top_kernels": [{"name": name[:100], "ms": round(us / 1e3, 3), "launches": count}
                            for name, (us, count) in top]}


def phase_step_time(fa, config) -> list[dict]:
    """Steady-state train step on one fixed batch: 32 px at batch 256, then
    64 px (base width 64) at batch 32. A ``.item()`` closes the timed region."""
    import dataclasses

    from aliasfree_diffusion_models_pytorch_tpu_torch import train as train_mod
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion

    results = []
    for px, n, warm, timed in ((32, 256, 3, 10), (64, 32, 2, 5)):
        cfg = dataclasses.replace(config, image_size=px, batch_size=n, run_name=f"bench{px}")
        model, state = train_mod.create_train_state(cfg, device="cuda")
        step_fn = train_mod.make_train_step(
            model, cfg, Diffusion(noise_steps=1000, img_size=px, device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        step = lambda st, b: step_fn(st, b, gen)  # noqa: E731
        rng = np.random.default_rng(0)
        batch = torch.from_numpy(rng.standard_normal((n, px, px, 3)).astype(np.float32)).cuda()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(warm):
            state, loss = step(state, batch)
        loss.item()
        fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
        t0 = time.perf_counter()
        for _ in range(timed):
            state, loss = step(state, batch)
        final_loss = loss.item()  # waits for the device inside the timed region
        step_ms = (time.perf_counter() - t0) / timed * 1e3
        counts = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
        check(counts == (6 * timed, 6 * timed), f"{px}px steps: launches {counts}")
        check(math.isfinite(final_loss), f"{px}px step loss {final_loss}")
        prof = profile_step(step, state, batch)
        row = dict(px=px, batch=n, step_ms=step_ms, imgs_per_s=n / step_ms * 1e3,
                   idle_share=1.0 - prof["device_busy_ms"] / step_ms,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   final_loss=final_loss, **prof)
        results.append(row)
        log(f"  {px}px batch {n} bf16: {step_ms:.2f} ms per step, {row['imgs_per_s']:.1f} "
            f"images/s, device busy {prof['device_busy_ms']:.2f} ms "
            f"(idle share {row['idle_share']:.2f}), {prof['device_kernels']} kernels per step, "
            f"flash_fwd {prof['flash_fwd_ms']:.3f} ms + flash_bwd {prof['flash_bwd_ms']:.3f} ms "
            f"per step, peak memory {row['peak_mem_gb']:.2f} GB")
        for k in prof["top_kernels"]:
            log(f"    {k['ms']:8.3f} ms {k['launches']:5d}x  {k['name']}")
        del model, state, step_fn, step, batch
        torch.cuda.empty_cache()
    return results


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — needs a CUDA GPU")
    from aliasfree_diffusion_models_pytorch_tpu_torch import cli, probes
    from aliasfree_diffusion_models_pytorch_tpu_torch.models import unet as unet_mod
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops import flash_attention as fa
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops import probes as kp
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels, weights

    # Every f32 comparison below runs in full f32 on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card (nvidia-smi name, power.limit): {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device 0: {kind}; "
        f"count {torch.cuda.device_count()}")

    log("[1] build")
    t_build = time.perf_counter()
    for name in kernels.SOURCES:
        stale = kernels.library_path(name)
        if stale.exists():
            stale.unlink()  # prove the build from this checkout's sources
    ptxas = []
    for r in kernels.build():
        log(f"  {r.name}: {r.seconds:.1f} s -> {r.path}")
        for entry in ptxas_report(r.log):
            ptxas.append(dict(library=r.name, **entry))
            log(f"    {entry['kernel']:<36} {entry['registers']:3d} registers, spill stores "
                f"{entry['spill_stores']} B, loads {entry['spill_loads']} B")
    # The bf16 attention kernels (everything of flash_fwd / flash_bwd but the
    # f32 CUDA-core kernels of the first port, `<float, D>`) keep every value
    # in registers.
    spilled = [e["kernel"] for e in ptxas if e["library"].startswith("flash_")
               and "float" not in e["kernel"] and e["spill_stores"] + e["spill_loads"]]
    check(not spilled, f"bf16 attention kernels spill: {spilled}")

    log(f"  [build: {time.perf_counter() - t_build:.1f} s]")
    t_phase = time.perf_counter()

    def done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        log(f"  [{name}: {now - t_phase:.1f} s]")
        t_phase = now

    log("[2] forward kernel vs plain version at the sampling-path shapes")
    kres = phase_kernels(fa)
    done("forward kernel")
    log("[2b] backward kernel vs plain version at the training-path shapes")
    bres = phase_bwd_kernel(fa)
    done("backward kernel")
    log("[2c] exp_chain vs plain version, every op at the probe's full array")
    eres = phase_exp_chain(kp, probes)
    done("exp_chain kernel")
    log("[2d] qk_rowsum vs plain version at the probe's three shapes")
    qres = phase_qk_rowsum(kp)
    done("qk_rowsum kernel")

    config = cli.config_from_args(cli.build_parser().parse_args(
        ["sample", "--variant", "3", "--image-size", "32", "--image-channels", "3",
         "--compute-dtype", "bfloat16", "--f-kernel", "3", "--f-beta", "2"]))
    log("[3] full-width Config-D UNet forward and sampler, card vs cpu")
    phase_unet(fa, weights, unet_mod, config)
    done("unet card vs cpu")
    log("[3b] full-width f32 train step, card vs cpu")
    phase_train_step_vs_cpu(fa, weights, config)
    done("train step card vs cpu")

    log("[4] main path: CLI sample")
    runs = phase_cli(fa, cli)
    done("cli sample")
    log("[5] main path: CLI train, sample from its checkpoint, optimizer knobs")
    train_runs = phase_cli_train(fa, cli)
    done("cli train")
    log("[6] steady-state train step")
    step_rows = phase_step_time(fa, config)
    done("step time")
    log("[7] study path: CLI probe, run, rotate, shift, eval; Inception forward")
    study = phase_study(fa, kp, cli)
    done("study path")

    main_rows = [r for r in kres["rows"] if r["n"] == 16 and r["dtype"] == "bfloat16"]
    main_bound, main_bound_by = bound(
        [attention_times(r["bh"], r["s"], r["d"], torch.bfloat16) for r in main_rows])
    bwd_rows = [r for r in bres["rows"] if r["px"] == 32 and r["dtype"] == "bfloat16"]
    bwd_bound, bwd_bound_by = bound(
        [attention_bwd_times(r["bh"], r["s"], r["d"], torch.bfloat16) for r in bwd_rows])
    kernels_line = {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "aliasfree_diffusion_models_pytorch_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "aliasfree_diffusion_models_pytorch_tpu/ops/flash_attention.py:126",
        "launches": runs[0]["launches"],
        "max_abs_err": max(kres["max_err"].values()),
        # times: the six attention calls of one bf16 Config-D forward at n=16
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": main_bound,
        "bound_by": main_bound_by,
        "library_ms": sum(r["library_ms"] for r in main_rows),
        "max_abs_err_by_dtype": {str(k)[6:]: v for k, v in kres["max_err"].items()},
        # largest error of a check as a share of its tensor's largest entry,
        # and the limit it was held to
        "max_rel_err_by_dtype": {str(k)[6:]: v for k, v in kres["max_rel"].items()},
        "rel_tol_by_dtype": {str(k)[6:]: v for k, v in REL_TOL.items()},
        "kernels_per_launch": 1,
        "ptxas": [e for e in ptxas if e["library"] == "flash_fwd"],
        "shapes": kres["rows"],
        "main_path_runs": runs,
        "train_path_launches": train_runs[0]["fwd_launches"],
    }, {
        "name": "flash_bwd",
        "route": "cuda",
        "source": "aliasfree_diffusion_models_pytorch_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "aliasfree_diffusion_models_pytorch_tpu/ops/flash_attention.py:166 "
                    "(_bwd_kernel) and :269 (_bwd_kernel_strips)",
        "launches": train_runs[0]["bwd_launches"],
        "max_abs_err": max(bres["max_err"].values()),
        # times: the six attention backward calls of one bf16 Config-D train
        # step at batch 256 (plain version at the batch its row names)
        "ms": sum(r["ms"] for r in bwd_rows),
        "plain_ms": sum(r["plain_ms"] for r in bwd_rows),
        "bound_ms": bwd_bound,
        "bound_by": bwd_bound_by,
        "library_ms": sum(r["library_ms"] for r in bwd_rows),
        "max_abs_err_by_dtype": {str(k)[6:]: v for k, v in bres["max_err"].items()},
        "max_rel_err_by_dtype": {str(k)[6:]: v for k, v in bres["max_rel"].items()},
        "rel_tol_by_dtype": {str(k)[6:]: v for k, v in REL_TOL.items()},
        # "launches" counts calls of the wrapper: a bf16 call runs three
        # __global__ kernels (pre-pass, tensor-core pass, dQ cast), an f32 call
        # two (dQ with δ, then dK/dV), and a profiler shows that many flash_bwd
        # events per call. A call without stats also adds 1 to flash_fwd's
        # count (the stats-mode forward that recomputes m and Σ).
        "kernels_per_launch": {str(k)[6:]: v for k, v in BWD_KERNELS.items()},
        "ptxas": [e for e in ptxas if e["library"] == "flash_bwd"],
        "shapes": bres["rows"],
        "main_path_runs": train_runs,
        "train_step": step_rows,
    }, {
        "name": "exp_chain",
        "route": "cuda",
        "source": "aliasfree_diffusion_models_pytorch_tpu_torch/csrc/exp_chain.cu",
        "replaces": "benchmarks/exp_micro.py:96",
        "launches": study["probe_exp"]["launches"][2],
        "max_abs_err": max(r["max_abs_err"] for r in eres["rows"]),
        # times: one pass of every op's 16-application chain over the probe's
        # array, summed over the eleven ops (what one iteration of `probe exp`
        # runs); no single PyTorch call computes a chained op
        "ms": sum(r["ms"] for r in eres["rows"]),
        "plain_ms": sum(r["plain_ms"] for r in eres["rows"]),
        "bound_ms": sum(r["bound_ms"] for r in eres["rows"]),
        "bound_by": "operations" if sum(r["bound_by"] == "operations" for r in eres["rows"])
                    > len(eres["rows"]) // 2 else "bytes",
        "library_ms": None,
        "max_rel_err": max(r["max_rel_err"] for r in eres["rows"]),
        "rel_tol_by_op": EXP_REL_TOL,
        "kernels_per_launch": 1,
        "shapes": eres["rows"],
        "fastexp2_max_rel_err": eres["fastexp2_max_rel_err"],
        "poly4_chain64_ms": eres["poly4_chain64_ms"],
        "mul2_chain64_ms": eres["mul2_chain64_ms"],
        "main_path_runs": {"probe_exp": study["probe_exp"],
                           "result": study["probe_exp_result"]},
    }, {
        "name": "qk_rowsum",
        "route": "cuda",
        "source": "aliasfree_diffusion_models_pytorch_tpu_torch/csrc/qk_rowsum.cu",
        "replaces": "benchmarks/attn_headpack.py:84",
        "launches": study["probe_headpack"]["launches"][3],
        "max_abs_err": max(r["max_abs_err"] for r in qres["rows"]),
        # times: the probe's three shapes, summed; the yardstick is bmm + sum
        # per chunk of n (see the rows)
        "ms": sum(r["ms"] for r in qres["rows"]),
        "plain_ms": sum(r["plain_ms"] for r in qres["rows"]),
        "bound_ms": sum(r["bound_ms"] for r in qres["rows"]),
        "bound_by": "operations" if sum(1e3 * r["flops"] / MATMUL_FLOPS_PER_S[torch.bfloat16]
                                        for r in qres["rows"])
                    > sum(1e3 * r["bytes"] / HBM_BYTES_PER_S for r in qres["rows"]) else "bytes",
        "library_ms": sum(r["library_ms"] for r in qres["rows"]),
        "max_rel_err": max(r["max_rel_err"] for r in qres["rows"]),
        "rel_tol": QK_REL_TOL,
        "kernels_per_launch": 1,
        "shapes": qres["rows"],
        "packed_over_perhead": qres["packed_over_perhead"],
        "d128_over_d8": qres["d128_over_d8"],
        "verdict": qres["verdict"],
        "main_path_runs": {"probe_headpack": study["probe_headpack"],
                           "result": study["probe_headpack_result"]},
    }], "study_path": {k: v for k, v in study.items() if not k.startswith("probe_")},
        "profiler_shortfalls": PROFILER_SHORTFALLS}
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)  # the nvidia-smi line as it printed it
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
