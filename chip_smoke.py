#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

Run from the root of a checkout:  python3 chip_smoke.py

1. names the card (``nvidia-smi`` name and power limit, torch's device name);
2. builds every hand-written kernel from ``csrc/`` with nvcc (sm_90a), all
   sources at once (``flash_fwd``, ``flash_bwd``, ``exp_chain``,
   ``qk_rowsum``, ``filtered_gelu``, ``plain_gelu``, ``layer_norm``), and prints the build
   seconds and each kernel's registers and spill bytes from ptxas; every
   attention kernel, bf16 and f32 (every f32 instantiation must be listed),
   D = 128 included, both GELU pairs, the LayerNorm pair and ``qk_rowsum`` must
   spill nothing; every
   ``qk_rowsum`` instantiation must hold ``HGMMA`` and ``UTMALDG`` and no
   ``HMMA`` in its machine code (``cuobjdump -sass``), and start with the
   registers its ``setmaxnreg`` hand-over adds up to;
3. holds each kernel against its plain PyTorch version on the card, in bf16
   (the tensor-core kernels) and f32 (the FMA-pipe kernels: two f32 backward
   calls must be bit-equal at every shape), with and
   without softmax stats, and times kernel, plain version and the one-call
   PyTorch yardstick (``scaled_dot_product_attention`` and its backward,
   never called by the port, TF32 off, the kernels of its f32 calls named)
   beside the reckoned bound; a timed kernel's
   profile must hold every kernel of every call (three ``flash_bwd*`` kernels
   a bf16 backward call, two an f32 one) or is taken again:
   the forward at every shape of the sampling path (Config D, image 32, base
   width 32: the six attention blocks at n=16 and at the CFG-doubled n=32;
   image 128, base width 128: the six blocks at n=4, S up to 16384, D up to
   128, bf16, and f32 where D = 128 and at S=16384);
   the backward at every shape of the training path (the same six blocks at
   batch 256, the six blocks of the 64-px step at batch 32, S up to 4096, and
   the six of the 128-px step at base width 128 and batch 4: S up to 16384, D
   128 at sa2 and sa3, f32 too where D = 128 and at S=16384), with the
   stats-mode forward that feeds it checked at the same shapes; then the two
   probe kernels:
   ``exp_chain`` at the probe's full (64, 1024, 1024) array for every op
   (chain 16, and a single application), with each op's bound, its cost per
   application off the slope against ``copy`` and the ``fastexp2`` accuracy
   line; ``qk_rowsum`` at the probe's three shapes, with the ``bmm`` + ``sum``
   yardstick, TFLOP/s and the share of the bound (the time must not be under
   the bound), its plan with the FLOPs of the plan's wgmmas, the two ratios
   and the verdict; then the
   filtered-GELU pair (``csrc/filtered_gelu.cu``) at every distinct filtered-GELU shape of the
   bf16 train steps at 32 px (batch 256), 64 px (batch 32) and the two 128-px
   regimes, and of the 32-px sampling forward (n=16), bf16 and f32, forward
   and backward, against its plain version and the conv form (the bf16
   forward equal to the plain version element for element, with the
   instantiation the kernels launched at each shape), bf16 timed beside its
   bound, the plain version and the conv form, and summed per train step;
3b. holds the filtered-GELU pair against its plain version under each
   ``AFDM_GELU`` mode (unset: the degree-15 polynomial; ``poly13``; ``exact``:
   the erf form) at every shape of the 32-px bf16 step (forward equal element
   for element, backward within 2^-6 of its largest entry), times it per step
   in each mode, lists the registers and spills of each mode's
   instantiations, and runs the graphed 32-px step at batch 256 in the
   default mode and then under ``poly13``, which must capture graphs of its
   own;
3c. holds the plain GELU's pair (``csrc/plain_gelu.cu``) at every shape and
   layout of ``gelu_exact`` in the bf16 Config-A step at batch 256 (28
   calls: GroupNorm's NCHW outputs, the feed-forward's (n, S, C) tokens)
   bit-equal to the composed form and to autograd through it, times it
   forward and backward beside its bound and the composed form, summed per
   step, and checks its four instantiations spill nothing and the
   filtered-GELU pair's side-32 registers (118 / 125 at degree 15, 114 /
   126 at degree 13) did not move with the shared header ``csrc/gelu.cuh``;
3d. holds the attention block's LayerNorm pair (``csrc/layer_norm.cu``) at
   the twelve calls of the bf16 32-px train step at batch 256 (``ln`` on the
   block's NCHW map read channel-major, ``ff_ln`` on the residual sum in row
   order) against ``nn.LayerNorm`` (the tokens copied into row order first):
   y, dx, dw and db within one bf16 unit in the last place and a floor for
   values that cancel (``tests/test_torch_layer_norm.py``); times the pair
   per step beside its bound and that composed form, and the twelve forward
   calls of a sampling forward at n=200; the same in f32 (against float64)
   at the calls of the examples' step (32 px, batch 64) and of the 128-px
   step at base width 128 (batch 4, C up to 512); names the composed
   backward's kernels and GroupNorm's, and counts 12 launches a forward and
   12 + 12 an eager train step;
4. runs the full-width Config-D UNet forward (n=16) in f32 on the card
   against the same weights on the CPU (TF32 off), and in bf16, counting 6
   attention launches per forward and the filtered-GELU launches (the conv
   form's depthwise convs must be gone: 6 resampling convs left, against 6 +
   2 per filtered GELU with ``AFDM_FG_IMPL=conv``); DDIM-5 on the card against the CPU with the
   same injected noise; then one f32 train step on the card against the CPU
   (same weights, batch, t and noise): loss and every parameter's gradient,
   6 forward and 6 backward launches;
5. drives the sampling path through the CLI's ``sample`` entry point:
   1000-step DDPM at n=16 in bf16 (5994 launches, and the filtered GELU's per
   forward times 999), DDIM-50, DDIM-50 with θ=90 (Config E) and a
   conditional DDIM-20 with CFG 3.0 — on the card every sampler and train
   step below runs as CUDA graphs (``utils/graphs.py``), and the launch
   counters count the graphs' replays;
6. drives the training path through the CLI's ``train`` entry point: Config D
   at batch 256 in bf16 on the synthetic dataset, 10 steps (60 forward and 60
   backward launches, falling loss, a checkpoint), ``sample`` from that
   checkpoint, a short run with EMA, accumulation, clipping and the
   warmup-cosine schedule, and the two 128-px regimes of
   ``benchmarks/train128.py`` (base width 128 at batch 4, base width 32 at
   batch 8) on a seeded tree of 16 PNGs — every launch counter (attention and
   filtered GELU) set to 0 just before each run and read just after;
7. times the steady-state train step (batch 256 at 32 px, then batch 32 at
   64 px, which sends S=4096 through the backward, each with the filtered
   GELU's kernel pair and with ``AFDM_FG_IMPL=conv``; then the two 128-px
   regimes; then two f32 steps at 32 px: Config A, the JAX CLI's default
   model, at batch 256, and Config D at batch 64): ms per step, images per
   second, kernels per step and device busy share from torch.profiler,
   attention, filtered-GELU and LayerNorm ms per step (12 + 12 LayerNorm
   launches a step), peak memory;
7a. (phase 6a) runs ``python3 bench_torch.py`` as a child process on the
   kernels built above and prints its JSON line: it must exit 0 with
   bench.py's keys, finite numbers, the card's name, an MFU in (0, 1] at 32
   px and at 64 px, a step within 15% of phase 6's graphed 32-px bf16 step,
   and, on its stderr, 6 + 6 attention launches, phase 6's filtered-GELU
   launches, 6 + 6 plain-GELU and 12 + 12 LayerNorm launches for each of its
   30 timed steps;
7b. (phase 6b) holds the CUDA graphs against ``graphs=False``, in turns in
   one run: DDPM-1000, DDIM-50, a CFG DDIM-20 and a 200-step ``shift`` at
   n=16, 32 px, and the Config-E sampler at 128 px, bit-equal from the same
   generator with the same launch counts (12 LayerNorm launches a forward:
   11,988 in the DDPM-1000 call), each one replay's kernels in
   torch.profiler against what the counters add for it; the four steps of
   phase 6 and the grid's batch-16 step graphed, eager and eager again (ms
   per step, device busy, idle share, peak memory; the graphed run's and
   the two eager runs' mean bf16 parameter differences within 1% of the
   parameters' movement); the f32 step graphed and eager bit-equal over six
   steps under deterministic algorithms, and the capturable AdamW against
   the plain one;
7c. (phase 6c) starts torch.distributed over NCCL with this process as its
   only rank and runs the graphed 32-px Config-D bf16 step at batch 256 on a
   ``data`` mesh and on an ``fsdp`` mesh of size 1, in turns with the
   single-device step (ms per step, whether the graphs captured the
   collective, the first loss bit-equal, the parameters within ten times the
   difference of two single runs: dQ's atomics keep those from being
   bit-equal), the f32
   step on both meshes bit-equal to the single one over six steps under
   deterministic algorithms, the CLI ``train`` (its ``metrics.jsonl`` header's
   ``impl``, rank 0's checkpoint) and ``run`` (the ``impl.*`` lines of its
   settings file) under that process group, and ``sample`` with the JAX
   CLI's training flags (``--batch-size 16``);
8. drives the study path through the CLI in a scratch ``--root``: ``probe
   exp`` and ``probe headpack``; ``run`` (the whole ``ddpm_run`` pipeline at
   batch 256, 200 noise steps, 32 generated PNGs); ``rotate`` and ``shift``
   from its checkpoint (every member of a sweep starts from the same noise);
   ``eval`` of the generated PNGs against exported training PNGs on the card
   and on the CPU; one Inception-v3 forward at batch 16 with seeded random
   weights, card against CPU;
9. drives ``reproduce-grid`` through the CLI on a seeded 320-image tree of
   32x32 RGB PNGs (configs A and D-2N at full width, 1 epoch at batch 16 =
   20 steps, 100 noise steps, 32 generated images each), with the wall time
   and the launches of every training and sampler call (120 + 120 and 1188 +
   0 per config), then ``--resume`` (no training, no launch, the same rows)
   and ``--reuse-generated`` (the metrics recomputed equal); the grid's own
   D-2N training traced over its steps 10-19 (attention's share of the
   device time and of the wall); ``train`` on a 64-row MNIST CSV (the run
   header's ``impl.native_loader`` must read ``loaded``) and the loader's permutation
   and batch gather timed, C++ binding against numpy; exact resume in f32 with
   ``--checkpoint-opt-state`` (2 epochs against 1 + a resumed 1); ``train
   --profile-dir`` over 25 steps (the trace must name both kernels); the
   128-px gather rotation card against CPU and the Config-E sampler at 128
   px (theta 90, 50 noise steps, n=4, bf16, base width 128: 294 launches),
   wall and device time per step;
10. (phase 9) runs ``examples/quickstart_torch.py`` and
   ``examples/conditional_cfg_torch.py`` in this process, each ``main`` at
   the JAX script's full configuration (Config D, 32 px, f32, 5 epochs at
   batch 64, 1000 noise steps; DDPM-1000 and DDIM-50 at n=8 and Config E at
   n=4, then RandomFeatures metrics; CFG DDIM-50 at n=40) from a scratch
   working directory, with its wall time and its launches (240 + 240 in
   training, 5994 + 300 + 5994 and 300 in the samplers; the LayerNorm
   pair twice as many in f32; the filtered GELU's conv form in f32, no pair
   launch), its epoch losses, artifacts, metric
   keys and sample shapes checked;
11. (phase 9b) runs ``torchrun --nproc-per-node 1 -m
   aliasfree_diffusion_models_pytorch_tpu_torch train`` and ``run`` at a cut
   size as child processes under a time limit: each exits 0, with no
   ``destroy_process_group`` warning, and writes its run;
12. prints one JSON line of every ported kernel, the card line, and last
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
import warnings

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
#  (the forward rescales its sums once per key tile of 64, 32 at D = 128: 256
#  times at S=16384, and adds the eight lanes' shares of a row at the end; the
#  backward adds P/Σ and dS tile by tile), and __expf stands against
#  torch.exp (2 ulp) → 2e-5 of the largest entry;
#  bf16: kernel and plain version round p (and dS) to bf16 from f32 values
#  that differ in the last bits (the forward's online softmax rounds against
#  its running max), so single terms round one bf16 ulp apart, and both round
#  the result to bf16. One bf16 ulp is at most 2^-7 of the entry it belongs
#  to, so 2^-6 of the largest entry allows two ulps there and no more.
REL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0**-6}
M_ATOL = 1e-5   # row max of identical f32 logits, summation order only
SUM_RTOL = 1e-4  # Σ rescaled once per key tile (64, or 32 at D = 128): a few f32 roundings a tile

# The f32 kernels' instantiations (csrc/flash_fwd.cu, csrc/flash_bwd.cu), by
# ptxas's names: the forward <D, heads a block, RI, CJ> at every head depth
# with 1, 2 or 4 heads (1 at D = 128), at D <= 16 also with its small-grid
# tile; the dQ and dK/dV passes as micro-tiles at D >= 32 and one row a
# thread at D <= 32.
F32_FWD_TILES = {8: [(4, 8), (4, 4)], 16: [(4, 8), (2, 8)], 32: [(4, 8)], 64: [(4, 8)],
                 128: [(4, 4)]}
F32_INSTANTIATIONS = (
    {f"flash_fwd_f32_kernel<{d}, {h}, {ri}, {cj}>" for d, tiles in F32_FWD_TILES.items()
     for ri, cj in tiles for h in ((1,) if d == 128 else (1, 2, 4))}
    | {f"flash_bwd_{p}_f32_kernel<{d}>" for p in ("dq", "dkv") for d in (32, 64, 128)}
    | {f"flash_bwd_{p}_f32_rows_kernel<{d}>" for p in ("dq", "dkv") for d in (8, 16, 32)})

# Kernels one call of the backward wrapper runs, by input dtype
# (csrc/flash_bwd.cu): bf16 a pre-pass, the tensor-core pass over every
# (query, key) pair and dQ's cast; f32 the dQ pass (which also writes each
# query's m, 1/Σ and δ) and the dK/dV pass. torch.profiler must show all of
# them for every timed call.
BWD_KERNELS = {torch.bfloat16: 3, torch.float32: 2}

# The 64-px train step (image 64, base width 64, batch 32): (block, S, C).
ATTN_SHAPES_64 = [("sa1", 1024, 128), ("sa2", 256, 256), ("sa3", 64, 256),
                  ("sa4", 256, 128), ("sa5", 1024, 64), ("sa6", 4096, 64)]
# The UNet at image 128, base width 128: (block, S, C). The 128-px sampler
# (n=4, phase 8) and the reference-quirk-w128 train step of
# benchmarks/train128.py (batch 4) run these; sa2 and sa3 have 512 channels,
# a head depth of 128, and sa6 is the longest sequence the JAX package trains.
ATTN_SHAPES_128 = [("sa1", 4096, 256), ("sa2", 1024, 512), ("sa3", 256, 512),
                   ("sa4", 1024, 256), ("sa5", 4096, 128), ("sa6", 16384, 128)]
N_128 = 4
# The two 128-px regimes of benchmarks/train128.py: (name, base width, batch),
# variant 3, bf16.
TRAIN_128 = [("reference-quirk-w128", 128, 4), ("capacity-fixed-w32", 32, 8)]
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
    last length-prefixed identifier that ends in ``_kernel``, then its
    integer, bool and float template arguments. The anonymous namespace
    before it carries hashes of the source, whose digits can read as a
    length prefix too (``…_cu_36bca9c128flash_bwd_dq_f32_rows_kernel``), so
    the identifier that starts last wins."""
    import re

    label = mangled[:60]
    for m in re.finditer(r"\d+(?=[A-Za-z_])", mangled):
        digits = m.group()
        for i in range(len(digits)):  # the length is some suffix of the digit run
            n = int(digits[i:])
            name = mangled[m.end():m.end() + n]
            if len(name) == n and name.endswith("_kernel"):
                t = re.match(r"I((?:L[a-z]\d+E|f|13__nv_bfloat16)+)E", mangled[m.end() + n:])
                label = name
                if t is not None:
                    args = [a.group(1) or ("float" if a.group() == "f" else "bf16")
                            for a in re.finditer(r"L[a-z](\d+)E|f|13__nv_bfloat16", t.group(1))]
                    label = f"{name}<{', '.join(args)}>"
                break
    return label


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


# What every qk_rowsum instantiation's machine code must hold: Hopper's
# warpgroup MMA (HGMMA) and TMA tile loads (UTMALDG), and no mma.sync (HMMA).
QK_SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")


def sass_report(lib_path) -> dict:
    """{kernel label: {op: count}} for the ops of QK_SASS_OPS in every
    function of a built library, from ``cuobjdump -sass`` (the toolkit's,
    beside nvcc)."""
    import re

    from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels

    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    report = {}
    for m in re.finditer(r"Function : (\S+)(.*?)(?=Function : |\Z)", sass, re.S):
        report[kernel_label(m.group(1))] = {
            op: len(re.findall(rf"\b{op}\b", m.group(2))) for op in QK_SASS_OPS}
    return report


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
PROFILER_TRIES = 6


def device_events(run, expect: dict | None = None) -> tuple[list[tuple[str, float]], float]:
    """Runs ``run()`` under torch.profiler: the (name, µs) of every kernel and
    copy on the card, and the host's seconds around the run. With ``expect``
    ({substring of a kernel name: events}) the trace must hold exactly that
    many events whose name contains each key. A trace now and then comes back
    with no device events at all, or (the question of PERF.md §7) perhaps
    short of some kernels, at times several in a row; either is recorded and
    the run profiled again after a pause that grows by half a second each
    time, and a sixth such trace fails."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILER_TRIES):
        time.sleep(0.5 * attempt)
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
    raise AssertionError(f"torch.profiler: {PROFILER_TRIES} traces without the expected "
                         f"kernels {expect}")


def device_ms(fn, iters: int = 20, per_call: dict | None = None) -> float:
    """Device time per call: the summed durations of the kernels (and copies)
    that ``iters`` calls ran, from torch.profiler's CUDA trace. ``per_call``
    ({substring of a kernel name: kernels per call}) makes the trace hold
    each named kernel of every call (see :func:`device_events`)."""
    fn()
    expect = {key: n * iters for key, n in per_call.items()} if per_call else None
    events, _ = device_events(lambda: [fn() for _ in range(iters)], expect)
    return sum(us for _, us in events) / iters / 1e3


def kernel_names(fn) -> list[str]:
    """The distinct device kernels that one call of ``fn`` runs (torch.profiler):
    which backend a PyTorch call took."""
    fn()
    events, _ = device_events(fn)
    return sorted({name[:120] for name, _ in events})


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
                if dtype == torch.float32:
                    row["library_kernels"] = kernel_names(calls["library_"])
                    log(f"  {tag:<28} sdpa runs {row['library_kernels']}")
                rows.append(row)
                log(f"  {tag:<28} err {err:.1e} ({rel:.1e} of max)  device us:"
                    f" kernel {row['ms'] * 1e3:7.1f} plain {row['plain_ms'] * 1e3:7.1f} sdpa {row['library_ms'] * 1e3:7.1f}"
                    f" bound {row['bound_ms'] * 1e3:6.2f} ({row['bound_by']}) | per call us:"
                    f" kernel {row['call_ms'] * 1e3:6.1f} plain {row['plain_call_ms'] * 1e3:6.1f}"
                    f" sdpa {row['library_call_ms'] * 1e3:6.1f}")
    # The 128-px sampler's shapes: bf16 at every block, f32 too where D = 128
    # and at sa6 (S=16384). The plain version runs at the batch of
    # PLAIN_SS_BYTES (`plain_bh`).
    n = N_128
    for block, s, c in ATTN_SHAPES_128:
        d = c // HEADS
        scale = 1.0 / math.sqrt(d)
        n_plain = max(1, min(n, PLAIN_SS_BYTES // (HEADS * s * s * 4)))
        f32 = d == 128 or block == "sa6"
        for dtype in (torch.bfloat16, torch.float32) if f32 else (torch.bfloat16,):
            q, k, v = (torch.randn((n, HEADS, s, d), generator=g, device="cuda").to(dtype)
                       for _ in range(3))
            out_s, m, ssum = fa.flash_attention_fwd(q, k, v, scale, with_stats=True)
            out = fa.flash_attention_fwd(q, k, v, scale)
            qs, ks, vs = (t[:n_plain].contiguous() for t in (q, k, v))
            ref, ref_m, ref_s = fa.attention_reference(qs, ks, vs, scale, with_stats=True)
            torch.cuda.synchronize()
            err, rel = max(errors(out[:n_plain], ref), errors(out_s[:n_plain], ref))
            m_err = (m[:n_plain * HEADS] - ref_m).abs().max().item()
            s_rel = ((ssum[:n_plain * HEADS] - ref_s).abs() / ref_s).max().item()
            del ref, ref_m, ref_s, out_s, m, ssum
            tag = f"128px {block} n={n} S={s} D={d} {str(dtype)[6:]}"
            check(rel <= REL_TOL[dtype],
                  f"{tag}: out err {err} is {rel} of max |out| > {REL_TOL[dtype]}")
            check(m_err <= M_ATOL, f"{tag}: stats m err {m_err}")
            check(s_rel <= SUM_RTOL, f"{tag}: stats sum rel err {s_rel}")
            max_err[dtype] = max(max_err[dtype], err)
            max_rel[dtype] = max(max_rel[dtype], rel)
            row = dict(px=128, block=block, n=n, bh=n * HEADS, s=s, d=d, dtype=str(dtype)[6:],
                       max_abs_err=err, max_rel_err=rel, plain_bh=n_plain * HEADS)
            calls = {"": lambda: fa.flash_attention_fwd(q, k, v, scale),
                     "plain_": lambda: fa.attention_reference(qs, ks, vs, scale),
                     "library_": lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)}
            for key, fn in calls.items():
                per_call = {"flash_fwd": 1} if key == "" else None
                row[f"{key}ms"] = device_ms(fn, iters=5, per_call=per_call)
                row[f"{key}call_ms"] = call_ms(fn, iters=10, warmup=1)
            row["bound_ms"], row["bound_by"] = bound([attention_times(n * HEADS, s, d, dtype)])
            if dtype == torch.float32:
                row["library_kernels"] = kernel_names(calls["library_"])
                log(f"  {tag:<34} sdpa runs {row['library_kernels']}")
            rows.append(row)
            log(f"  {tag:<34} err {err:.1e} ({rel:.1e} of max)  device us:"
                f" kernel {row['ms'] * 1e3:8.1f} plain(bh={row['plain_bh']}) "
                f"{row['plain_ms'] * 1e3:8.1f} sdpa {row['library_ms'] * 1e3:8.1f}"
                f" bound {row['bound_ms'] * 1e3:7.2f} ({row['bound_by']})")
            del q, k, v, out, qs, ks, vs
        torch.cuda.empty_cache()
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
                          (128, N_128, ATTN_SHAPES_128)):
        for block, s, c in shapes:
            d = c // HEADS
            scale = 1.0 / math.sqrt(d)
            # batch of the comparison with the plain version (see PLAIN_SS_BYTES)
            n_plain = max(1, min(n, PLAIN_SS_BYTES // (HEADS * s * s * 4)))
            # at 128 px the f32 kernels run where D = 128 and at S=16384
            f32 = px < 128 or d == 128 or block == "sa6"
            for dtype in (torch.bfloat16, torch.float32) if f32 else (torch.bfloat16,):
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
                if dtype == torch.float32:
                    # deterministic: two calls on the whole batch give the same bits
                    first, again = (fa.flash_attention_bwd(q, k, v, out, m, ssum, g, scale)
                                    for _ in range(2))
                    torch.cuda.synchronize()
                    row["bit_equal_calls"] = all(torch.equal(a, b) for a, b in zip(first, again))
                    check(row["bit_equal_calls"], f"{tag}: two f32 backward calls differ")
                    del first, again
                    row["library_kernels"] = kernel_names(calls["library_"])
                    log(f"  {tag:<34} two backward calls bit-equal; sdpa-bwd runs "
                        f"{row['library_kernels']}")
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


# The filtered GELU (csrc/filtered_gelu.cu) at every distinct shape of the
# bf16 train steps: (image, base width, batch) of the 32-px and 64-px steps
# and the two 128-px regimes.
FG_STEPS = [(32, 32, 256), (64, 64, 32), (128, 128, N_128), (128, 32, 8)]
# ... and of the sampler's bf16 forward (image, base width, n), checked and
# timed like the steps' shapes but kept out of the per-step sums.
FG_SAMPLE = [(32, 32, 16)]
# Kernel vs plain version, max |difference| as a share of the largest entry:
# the forward repeats the plain version's rounded f32 products and sums in its
# order, so one bf16 ulp (2^-8) in bf16 and 1e-6 in f32 (erff against torch's
# erf, the GELU's f32 rounding); the backward sums in an order of its own and
# rounds dG and dP to bf16 from values a few f32 ulps apart: two bf16 ulps
# (2^-6), and 2e-5 in f32. Against the conv form (cuDNN's depthwise convs in
# another summation order, the same rounding points): 2^-6 in bf16, 1e-5 in f32.
FG_REL_TOL = {torch.bfloat16: (2.0**-8, 2.0**-6), torch.float32: (1e-6, 2e-5)}
FG_CONV_REL_TOL = {torch.bfloat16: 2.0**-6, torch.float32: 1e-5}
# f32 instructions per output of the least work (k = 3 taps a side): the
# forward forms four phases from k² products, four GELU polynomials (clamp,
# square, seven Horner FMAs, two more: about 12 each) and the k² down taps:
# 2k² + 48; the backward adds the k² taps of dG and the polynomial's
# derivative (about 4 more a phase): 3k² + 64.
def fg_ops(k: int, backward: bool) -> int:
    return 3 * k * k + 64 if backward else 2 * k * k + 48


def fg_step_shapes(unet_mod, blocks, config, px: int, width: int, batch: int) -> dict:
    """{(n, c, h, w): calls} of the filtered GELU in one forward of the bf16
    Config-D UNet at this image size, base width and batch (a spy on the
    blocks' ``filtered_gelu``; the backward calls the same shapes)."""
    import dataclasses

    cfg = dataclasses.replace(config, image_size=px, base_width=width, batch_size=batch)
    model = unet_mod.build_model(cfg, device="cuda")
    shapes: dict = {}
    real = blocks.filtered_gelu

    def spy(x, *a, **k):
        shapes[tuple(x.shape)] = shapes.get(tuple(x.shape), 0) + 1
        return real(x, *a, **k)

    blocks.filtered_gelu = spy
    try:
        with torch.no_grad():
            model(torch.zeros((batch, px, px, 3), device="cuda"),
                  torch.ones((batch,), dtype=torch.long, device="cuda"))
    finally:
        blocks.filtered_gelu = real
    del model
    torch.cuda.empty_cache()
    return shapes


def fg_times(numel: int, k: int, backward: bool) -> tuple[float, float]:
    """(bytes ms, operations ms) of one bf16 call: x (and g) read once and the
    result written once; fg_ops f32 instructions an output."""
    nbytes = (3 if backward else 2) * numel * 2
    ops = numel * fg_ops(k, backward)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FMA_PER_S


def phase_fg_kernel(rs, unet_mod, blocks, config) -> dict:
    """The filtered-GELU kernel pair against its plain version (bf16 and f32,
    forward and backward) and against the conv form, at every distinct
    filtered-GELU shape of the 32-, 64- and 128-px train steps and of the
    n = 16 sampling forward; bf16 timed with its bound, the plain version and
    the conv form."""
    k = config.filters.kernel_size
    up, down = (torch.from_numpy(t).cuda() for t in blocks.design_taps(config.filters))
    steps, sampling, distinct = {}, {}, {}
    for runs, prefix, size in ((steps, "b", FG_STEPS), (sampling, "sample_n", FG_SAMPLE)):
        for px, width, batch in size:
            name = f"{px}px_w{width}_{prefix}{batch}"
            shapes = fg_step_shapes(unet_mod, blocks, config, px, width, batch)
            runs[name] = [dict(shape=list(sh), calls=n) for sh, n in shapes.items()]
            for sh in shapes:
                distinct.setdefault(sh, name)
            log(f"  {px}px base width {width} batch {batch}: {sum(shapes.values())} "
                f"filtered-GELU calls a forward at {len(shapes)} shapes")
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, max_err = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    max_rel = dict(max_err)

    def conv_form(x, u, d):
        return rs.downsample2x(rs.gelu_exact(rs.upsample2x(x, u)), d)

    for shape, first in distinct.items():
        numel = math.prod(shape)
        for dtype in (torch.bfloat16, torch.float32):
            x = (2 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            u, d = up.to(dtype), down.to(dtype)
            y, dx = rs.filtered_gelu_fwd(x, u, d), rs.filtered_gelu_bwd(x, u, d, g)
            plan = rs.filtered_gelu_fwd.last_plan  # the plan the kernels launched
            check(rs.filtered_gelu_bwd.last_plan == plan, f"filtered_gelu {shape}: plans differ")
            xg = x.clone().requires_grad_()
            ref = rs.filtered_gelu_phases(xg, u, d)
            (ref_dx,) = torch.autograd.grad(ref, xg, g, retain_graph=True)
            xc = x.clone().requires_grad_()
            conv = conv_form(xc, u, d)
            (conv_dx,) = torch.autograd.grad(conv, xc, g, retain_graph=True)
            torch.cuda.synchronize()
            tag = f"{tuple(shape)} {str(dtype)[6:]}"
            # the bf16 forward repeats the plain version's arithmetic: equal element for element
            differ = int((y != ref).sum())
            if dtype == torch.bfloat16:
                log(f"  {tag:<28} {plan.instantiation} (strips of {plan.rows} x {plan.cols}, "
                    f"{plan.blocks} blocks): {differ} forward elements differ from the plain version")
                check(differ == 0, f"filtered_gelu {tag}: {differ} forward elements differ")
            fwd_tol, bwd_tol = FG_REL_TOL[dtype]
            errs = {}
            for name, a, r, tol in (("fwd", y, ref, fwd_tol), ("bwd", dx, ref_dx, bwd_tol),
                                    ("fwd_conv", y, conv, FG_CONV_REL_TOL[dtype]),
                                    ("bwd_conv", dx, conv_dx, FG_CONV_REL_TOL[dtype])):
                err, rel = errors(a, r)
                check(a.dtype == dtype and a.shape == r.shape and bool(torch.isfinite(a).all()),
                      f"filtered_gelu {tag} {name}: dtype, shape or finite")
                check(rel <= tol, f"filtered_gelu {tag} {name}: err {err} is {rel} of max > {tol}")
                errs[name] = (err, rel)
            max_err[dtype] = max(max_err[dtype], errs["fwd"][0], errs["bwd"][0])
            max_rel[dtype] = max(max_rel[dtype], errs["fwd"][1], errs["bwd"][1])
            row = dict(shape=list(shape), first_step=first, dtype=str(dtype)[6:],
                       instantiation=plan.instantiation, strip=[plan.rows, plan.cols],
                       fwd_differ=differ,
                       **{f"err_{n}": e for n, (e, _) in errs.items()},
                       **{f"rel_{n}": r for n, (_, r) in errs.items()})
            if dtype == torch.bfloat16:
                calls = {
                    "fwd_ms": (lambda: rs.filtered_gelu_fwd(x, u, d), {"filtered_gelu_fwd": 1}),
                    "bwd_ms": (lambda: rs.filtered_gelu_bwd(x, u, d, g), {"filtered_gelu_bwd": 1}),
                    "plain_fwd_ms": (lambda: rs.filtered_gelu_phases(x, u, d), None),
                    "plain_bwd_ms": (lambda: torch.autograd.grad(ref, xg, g, retain_graph=True),
                                     None),
                    "conv_fwd_ms": (lambda: conv_form(x, u, d), None),
                    "conv_bwd_ms": (lambda: torch.autograd.grad(conv, xc, g, retain_graph=True),
                                    None),
                }
                for key, (fn, per_call) in calls.items():
                    row[key] = device_ms(fn, iters=10 if per_call else 3, per_call=per_call)
                for key, bwd in (("fwd", False), ("bwd", True)):
                    row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = bound(
                        [fg_times(numel, k, bwd)])
                log(f"  {tag:<28} err of max: fwd {errs['fwd'][1]:.1e} bwd {errs['bwd'][1]:.1e}"
                    f" (vs conv form {errs['fwd_conv'][1]:.1e} {errs['bwd_conv'][1]:.1e})"
                    f"  device us fwd/bwd: kernel {row['fwd_ms'] * 1e3:8.1f} "
                    f"{row['bwd_ms'] * 1e3:8.1f} bound {row['fwd_bound_ms'] * 1e3:7.1f} "
                    f"{row['bwd_bound_ms'] * 1e3:7.1f} ({row['fwd_bound_by']}) plain "
                    f"{row['plain_fwd_ms'] * 1e3:8.1f} {row['plain_bwd_ms'] * 1e3:8.1f} conv form "
                    f"{row['conv_fwd_ms'] * 1e3:8.1f} {row['conv_bwd_ms'] * 1e3:8.1f}")
            else:
                log(f"  {tag:<28} err of max: fwd {errs['fwd'][1]:.1e} bwd {errs['bwd'][1]:.1e}"
                    f" (vs conv form {errs['fwd_conv'][1]:.1e} {errs['bwd_conv'][1]:.1e})")
            rows.append(row)
            del x, g, y, dx, xg, ref, ref_dx, xc, conv, conv_dx
        torch.cuda.empty_cache()
    # per bf16 train step: every call's forward and backward
    by_shape = {tuple(r["shape"]): r for r in rows if r["dtype"] == "bfloat16"}
    per_step = {}
    for name, shapes in steps.items():
        entries = [(by_shape[tuple(e["shape"])], e["calls"]) for e in shapes]
        t = {key: sum(n * r[key] for r, n in entries)
             for key in ("fwd_ms", "bwd_ms", "plain_fwd_ms", "plain_bwd_ms", "conv_fwd_ms",
                         "conv_bwd_ms")}
        times = [fg_times(math.prod(r["shape"]), k, bwd) for r, n in entries
                 for bwd in (False, True) for _ in range(n)]
        t["bound_ms"], t["bound_by"] = bound(times)
        t["calls"] = sum(n for _, n in entries)
        per_step[name] = t
        log(f"  per {name} step ({t['calls']} calls, forward + backward): kernel "
            f"{t['fwd_ms'] + t['bwd_ms']:.3f} ms, bound {t['bound_ms']:.3f} ({t['bound_by']}), "
            f"plain {t['plain_fwd_ms'] + t['plain_bwd_ms']:.3f}, conv form "
            f"{t['conv_fwd_ms'] + t['conv_bwd_ms']:.3f}")
    # per sampling forward: the forward kernel alone
    per_forward = {}
    for name, shapes in sampling.items():
        per_forward[name] = sum(e["calls"] * by_shape[tuple(e["shape"])]["fwd_ms"]
                                for e in shapes)
        log(f"  per {name} forward ({sum(e['calls'] for e in shapes)} calls): kernel "
            f"{per_forward[name]:.3f} ms")
    return dict(rows=rows, steps=steps, sampling=sampling, per_step=per_step,
                per_forward=per_forward, max_err=max_err, max_rel=max_rel)


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
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels

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
        # The logits are formed on the tensor cores, so the kernel takes at least the bound's
        # FLOPs at the card's peak; summing K over the keys first would run near the bytes time.
        check(row["ms"] >= row["bound_ms"], f"qk_rowsum {name}: {row['ms']} ms is under the "
              f"{row['bound_ms']} ms of its bound: the logits were not all formed")
        row["tflops"] = row["flops"] / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        # the plan's figures, not measured: its wgmmas' FLOPs (d = 8 padded to depth 16)
        plan = kp.qk_plan(n, s, d, kernels.sm_count(0))
        log(f"  {name:15s} (n={n}, s={s}, d={d}) err {row['max_abs_err']:.1e} "
            f"({row['max_rel_err']:.1e} of max)  device ms: kernel {row['ms']:.4f} "
            f"({row['tflops']:.1f} TFLOP/s of the bound's {row['flops']:.4g} FLOPs; "
            f"{row['share_of_bound']:.3f} of the bound) "
            f"plain {row['plain_ms']:.3f} bmm+sum(chunks of {chunk}) {row['library_ms']:.3f} "
            f"bound {row['bound_ms']:.4f} ({row['bound_by']})  plan: {plan.issued_flops:.4g} "
            f"FLOPs in its wgmmas ({plan.issued_flops / row['ms'] / 1e9:.1f} TFLOP/s), "
            f"{plan.keys_per_tile} keys a tile, N {plan.acc_keys}, {plan.stages} stages, "
            f"swizzle {plan.swizzle}, {plan.smem_bytes} B, {plan.grid} blocks over "
            f"{plan.items} items")
        del k, qt
        torch.cuda.empty_cache()
    ms = {r["shape"]: r["ms"] for r in rows}
    ratio = ms["blockdiag_hd32"] / ms["perhead_d8"]
    depth = ms["perhead_d128"] / ms["perhead_d8"]
    verdict = "REJECT head-packing" if ratio > 1.1 else "ACCEPT head-packing"
    log(f"  packed_over_perhead {ratio:.2f}, d128_over_d8 {depth:.2f}: {verdict}")
    return dict(rows=rows, packed_over_perhead=ratio, d128_over_d8=depth, verdict=verdict)


def phase_unet(fa, rs, weights, unet_mod, config) -> int:
    """Full-width Config-D forward: f32 card vs CPU, bf16 finite, 6 launches
    each; the bf16 forward's filtered GELUs through the kernel (no depthwise
    conv of the conv form left), whose launches per forward it returns."""
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
        before = fa.flash_attention_fwd.launches, rs.filtered_gelu_fwd.launches
        outb = bf16(x.cuda(), t.cuda()).cpu()
        check(fa.flash_attention_fwd.launches - before[0] == 6, "bf16 forward: 6 launches")
        fg = rs.filtered_gelu_fwd.launches - before[1]
        check(fg > 0, "bf16 forward: no filtered_gelu launch")
        check(bool(torch.isfinite(outb).all()) and outb.shape == (16, 32, 32, 3), "bf16 forward")
        log(f"  bf16 forward finite; max |bf16 - f32 cpu| {(outb - ref).abs().max().item():.3e}; "
            f"{fg} filtered_gelu launches")
        # The conv form's depthwise convs are gone for the filtered GELUs: only
        # the six resampling convs of Down and Up are left (a spy counts them).
        depthwise, plain_dw = [], rs._depthwise
        rs._depthwise = lambda *a: depthwise.append(1) or plain_dw(*a)
        try:
            bf16(x.cuda(), t.cuda())
            dw_phases = len(depthwise)
            os.environ["AFDM_FG_IMPL"] = "conv"
            outc = bf16(x.cuda(), t.cuda()).cpu()
        finally:
            rs._depthwise = plain_dw
            os.environ.pop("AFDM_FG_IMPL")
        dw_conv = len(depthwise) - dw_phases
        log(f"  depthwise convs a bf16 forward: {dw_phases} with the kernel, {dw_conv} with "
            f"AFDM_FG_IMPL=conv; max |kernel - conv form| {(outb - outc).abs().max().item():.3e}")
        check(dw_phases == 6 and dw_conv == 6 + 2 * fg, f"depthwise convs {dw_phases}, {dw_conv}")
        xc, tc = x.cuda(), t.cuda()
        profiles = {}
        for name, model in (("bf16", bf16), ("f32", gpu)):
            ms = call_ms(lambda: model(xc, tc), iters=20)
            expect = {"flash_fwd": 6, "filtered_gelu": fg if name == "bf16" else 0}
            profiles[name] = profile_forward(model, xc, tc, expect)
            log(f"  {name} forward n=16: {ms:.3f} ms per forward (CUDA events); profiler, "
                f"one forward: {json.dumps(profiles[name])}")
        os.environ["AFDM_FG_IMPL"] = "conv"
        try:
            profiles["conv"] = profile_forward(bf16, xc, tc, {"flash_fwd": 6, "filtered_gelu": 0})
        finally:
            os.environ.pop("AFDM_FG_IMPL")
        log(f"  bf16 forward n=16 with AFDM_FG_IMPL=conv, profiler: {json.dumps(profiles['conv'])}")
        # in the profile too: the filtered GELUs' depthwise kernels are gone
        check(profiles["bf16"]["depthwise_conv_kernels"] < profiles["conv"]["depthwise_conv_kernels"],
              f"depthwise conv kernels in the profile: {profiles['bf16']['depthwise_conv_kernels']} "
              f"with the kernel pair, {profiles['conv']['depthwise_conv_kernels']} with the conv form")

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
    return fg


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


def profile_forward(model, x, t, expect: dict) -> dict:
    """Device time by kernel family for one forward (torch.profiler)."""
    model(x, t)
    events, wall = device_events(lambda: model(x, t), expect)
    total = sum(us for _, us in events)
    fam = {key: sum(us for name, us in events if key in name) for key in expect}
    return {"wall_ms": round(wall * 1e3, 3), "device_busy_ms": round(total / 1e3, 3),
            "device_kernels": len(events),
            "depthwise_conv_kernels": sum("conv_depthwise2d" in name for name, _ in events),
            **{f"{key}_ms": round(us / 1e3, 4) for key, us in fam.items()}}


def phase_cli(fa, rs, cli, fg: int) -> list[dict]:
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
        fa.flash_attention_fwd.launches = rs.filtered_gelu_fwd.launches = 0
        t0 = time.perf_counter()
        final = cli.run_sample(args)
        wall = time.perf_counter() - t0
        launches, fg_launches = fa.flash_attention_fwd.launches, rs.filtered_gelu_fwd.launches
        log(f"  {name}: {wall:.2f} s wall, {launches} flash_fwd and {fg_launches} "
            f"filtered_gelu_fwd launches, output {final.shape} {final.dtype}, "
            f"pixel std {final.std():.1f}")
        check(launches == expect, f"{name}: {launches} launches, expected {expect}")
        check(fg_launches == expect // 6 * fg,
              f"{name}: {fg_launches} filtered_gelu launches, expected {expect // 6 * fg}")
        check(final.shape == (16, 32, 32, 3) and final.dtype == np.uint8, f"{name}: output")
        check(final.std() > 0, f"{name}: constant output")
        results.append(dict(run=name, wall_s=wall, launches=launches,
                            fg_fwd_launches=fg_launches))
    return results


TRAIN_FLAGS = ["--variant", "3", "--image-size", "32", "--batch-size", "256",
               "--image-channels", "3", "--compute-dtype", "bfloat16", "--f-kernel", "3",
               "--f-beta", "2", "--dataset", "CIFAR10", "--image-gen-per-epoch", "0",
               "--device", "cuda"]


def phase_cli_train(fa, rs, cli, fg: int) -> list[dict]:
    """The training path through the CLI: train, sample from its checkpoint,
    a short run with every opt-in optimizer knob, and the two 128-px regimes
    of benchmarks/train128.py. ``fg``: filtered-GELU calls per forward."""
    import shutil

    root = os.path.join(OUT_DIR, "train_root")
    shutil.rmtree(root, ignore_errors=True)
    results = []

    def counted(name, fn, expect, fg_expect):
        """Runs fn with every launch counter set to 0 just before; checks the
        attention launches (fwd, bwd) and the filtered-GELU ones (fwd, bwd;
        None: any equal nonzero pair)."""
        torch.cuda.synchronize()
        fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
        rs.filtered_gelu_fwd.launches = rs.filtered_gelu_bwd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
        fg_counts = (rs.filtered_gelu_fwd.launches, rs.filtered_gelu_bwd.launches)
        check(counts == expect, f"{name}: launches (fwd, bwd) {counts}, expected {expect}")
        if fg_expect is None:
            check(fg_counts[0] > 0 and fg_counts[0] == fg_counts[1],
                  f"{name}: filtered_gelu launches {fg_counts}")
        else:
            check(fg_counts == fg_expect,
                  f"{name}: filtered_gelu launches {fg_counts}, expected {fg_expect}")
        results.append(dict(run=name, wall_s=wall, fwd_launches=counts[0],
                            bwd_launches=counts[1], fg_fwd_launches=fg_counts[0],
                            fg_bwd_launches=fg_counts[1],
                            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))
        return value, wall

    # 512 synthetic images at batch 256: 2 steps an epoch, 10 steps.
    args = cli.build_parser().parse_args(["train", *TRAIN_FLAGS, "--epochs", "5", "--root", root])
    losses, wall = counted("train_10_steps", lambda: cli.run_train(args), (60, 60),
                           (10 * fg, 10 * fg))
    log(f"  train 10 steps at batch 256: {wall:.2f} s wall (first steps included), epoch mean "
        f"losses {[round(x, 4) for x in losses]}, 60 + 60 attention and {10 * fg} + {10 * fg} "
        f"filtered_gelu launches, peak memory {results[-1]['peak_mem_gb']:.2f} GB")
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
    final, wall = counted("sample_trained_ddim20", lambda: cli.run_sample(sample_args), (120, 0),
                          (20 * fg, 0))
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
    losses, wall = counted("train_knobs_4_steps", lambda: cli.run_train(args), (24, 24),
                           (4 * fg, 4 * fg))
    log(f"  train with EMA, accumulation 2, clip 1.0, warmup-cosine: {wall:.2f} s, "
        f"losses {[round(x, 4) for x in losses]}")
    check(all(math.isfinite(x) for x in losses), f"knob run losses {losses}")

    # The 128-px regimes on a seeded tree of 16 PNGs (resized to 128 by the
    # loader): 4 steps at batch 4, 2 at batch 8; sa2 and sa3 at D = 128 in the
    # reference-quirk-w128 regime.
    tree = os.path.join(OUT_DIR, "tree128")
    shutil.rmtree(tree, ignore_errors=True)
    write_image_tree(tree, 4, 4, seed=9)
    for name, width, batch in TRAIN_128:
        steps = 16 // batch
        args = cli.build_parser().parse_args(
            ["train", "--variant", "3", "--image-size", "128", "--base-width", str(width),
             "--batch-size", str(batch), "--image-channels", "3", "--compute-dtype", "bfloat16",
             "--f-kernel", "3", "--f-beta", "2", "--dataset", "CIFAR10", "--dataset-path", tree,
             "--epochs", "1", "--image-gen-per-epoch", "0", "--device", "cuda",
             "--root", os.path.join(OUT_DIR, f"train128_{name}")])
        losses, wall = counted(f"train_128px_{name}", lambda: cli.run_train(args),
                               (6 * steps, 6 * steps), None)
        r = results[-1]
        log(f"  train 128 px {name} (base width {width}, batch {batch}): {steps} steps in "
            f"{wall:.2f} s (first step included), epoch mean loss {losses[0]:.4f}, launches "
            f"attention {r['fwd_launches']} + {r['bwd_launches']}, filtered_gelu "
            f"{r['fg_fwd_launches']} + {r['fg_bwd_launches']}, peak memory {r['peak_mem_gb']:.2f} GB")
        check(len(losses) == 1 and math.isfinite(losses[0]), f"128-px {name} losses {losses}")
        r["epoch_losses"] = losses
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


GRID_FLAGS = ["--dataset", "CIFAR10", "--configs", "A,D-2N", "--epochs", "1",
              "--batch-size", "16", "--gen-total", "32", "--gen-per-batch", "16",
              "--noise-steps", "100", "--device", "cuda"]
GRID_TREE = (10, 32)  # class directories, 32x32 RGB PNGs in each: 320 images
# Exact resume on the card, as a share of each tensor's largest entry. AdamW
# divides by the root of the second moment, so a parameter whose true gradient
# is 0 (the key part of each attention's qkv bias: softmax ignores a shift of
# the keys) moves by about lr a step whatever the rounding noise in its
# gradient; noise that differs between runs (cuDNN's weight-gradient
# algorithms that add with atomics) then shows there at 3e-3 after 16 steps.
# The phase runs deterministic algorithms, and the runs must then agree.
RESUME_REL_TOL = 1e-5
ROTATE_ATOL = 1e-5  # f32 gather and prefilter, card (TF32 off) against the CPU


def write_image_tree(root: str, classes: int, per_class: int, seed: int) -> None:
    """A seeded CIFAR-like tree: one directory of 32x32 RGB PNGs per class."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for c in range(classes):
        d = os.path.join(root, f"class_{c}")
        os.makedirs(d)
        for i in range(per_class):
            # smooth blobs: a random 4x4 pattern upsampled, plus noise
            base = np.kron(rng.integers(0, 256, (4, 4, 3)), np.ones((8, 8, 1)))
            img = np.clip(base + rng.normal(0, 20, (32, 32, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(d, f"{i}.png"))


def phase_grid(fa, cli) -> dict:
    """reproduce-grid on an image tree, its --resume and --reuse-generated, an
    MNIST CSV through the native loader, exact resume in f32, --profile-dir,
    and the 128-px Config-E sampler through the gather plan."""
    import shutil

    from aliasfree_diffusion_models_pytorch_tpu_torch import data
    from aliasfree_diffusion_models_pytorch_tpu_torch import train as train_mod
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops import rotation
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils import native

    root = os.path.join(OUT_DIR, "grid_root")
    shutil.rmtree(root, ignore_errors=True)
    tree = os.path.join(root, "tree")
    write_image_tree(tree, *GRID_TREE, seed=5)
    out = os.path.join(root, "grid.json")
    grid_args = ["reproduce-grid", *GRID_FLAGS, "--dataset-path", tree, "--root", root,
                 "--out", out]
    results: dict = {}

    def counts():
        return fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches

    # Spies: each training run and each sampler call of the grid, with its
    # wall time and the launches it made. The training run named in
    # `traced` writes a profiler trace of its steps 10-19; the trace's export
    # is timed apart and left out of that run's wall time.
    events: list[dict] = []
    exports: list[float] = []
    traced = {"run": None}
    grid_prof = os.path.join(root, "grid_profile")
    plain_train, plain_sample, plain_stop = (train_mod.train, Diffusion.sample,
                                             train_mod._stop_profiler)

    def timed_stop(*a, **k):
        t0 = time.perf_counter()
        path = plain_stop(*a, **k)
        exports.append(time.perf_counter() - t0)
        return path

    def spied(kind, fn):
        def run(*a, **k):
            name = getattr(a[0], "run_name", None)
            if kind == "train" and name == traced["run"]:
                k = {**k, "profile_dir": grid_prof}
            torch.cuda.synchronize()
            before, n_exports, t0 = counts(), len(exports), time.perf_counter()
            value = fn(*a, **k)
            torch.cuda.synchronize()
            after, exported = counts(), sum(exports[n_exports:])
            events.append(dict(kind=kind, wall_s=time.perf_counter() - t0 - exported,
                               trace_export_s=exported, fwd=after[0] - before[0],
                               bwd=after[1] - before[1], run=name))
            return value
        return run

    def grid(extra):
        events.clear()
        train_mod.train = spied("train", plain_train)
        Diffusion.sample = spied("sample", plain_sample)
        train_mod._stop_profiler = timed_stop
        try:
            torch.cuda.synchronize()
            fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
            t0 = time.perf_counter()
            check(cli.main([*grid_args, *extra]) == 0, f"reproduce-grid {extra}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            train_mod.train, Diffusion.sample = plain_train, plain_sample
            train_mod._stop_profiler = plain_stop
        with open(out) as f:
            return json.load(f), wall, counts(), list(events)

    steps = GRID_TREE[0] * GRID_TREE[1] // 16
    sampler = 2 * 6 * (100 - 1)  # two chunks of 16, 99 denoising steps, six attention blocks
    traced["run"] = "grid_CIFAR10_D-2N"
    result, wall, total, evs = grid([])
    traced["run"] = None
    per_config = []
    for i, name in enumerate(("A", "D-2N")):
        tr = [e for e in evs if e["kind"] == "train"][i]
        gen = [e for e in evs if e["kind"] == "sample"][2 * i: 2 * i + 2]
        row = result["rows"][i]
        entry = dict(config=name, train_s=tr["wall_s"], trace_export_s=tr["trace_export_s"],
                     gen_s=sum(e["wall_s"] for e in gen),
                     train_launches=[tr["fwd"], tr["bwd"]],
                     gen_launches=[sum(e["fwd"] for e in gen), sum(e["bwd"] for e in gen)],
                     final_loss=row["final_loss"], row=row)
        per_config.append(entry)
        log(f"  grid {name}: train {entry['train_s']:.2f} s ({steps} steps, launches fwd/bwd "
            f"{entry['train_launches']}), generation {entry['gen_s']:.2f} s (launches "
            f"{entry['gen_launches']}), final loss {row['final_loss']}, row {json.dumps(row)}")
        check(entry["train_launches"] == [6 * steps, 6 * steps],
              f"grid {name} training launches {entry['train_launches']}")
        check(entry["gen_launches"] == [sampler, 0],
              f"grid {name} generation launches {entry['gen_launches']}")
        check(math.isfinite(row["fid_raw"]) and math.isfinite(row["kid_x100_raw"])
              and math.isfinite(row["is_raw"]) and math.isfinite(row["final_loss"]),
              f"grid {name}: row {row}")
        with np.load(os.path.join(root, row["gen_images"])) as z:
            check(z["images"].shape == (32, 32, 32, 3) and z["images"].dtype == np.uint8,
                  f"grid {name}: generated set {z['images'].shape}")
    check(result["complete"] and result["real_data"] and not result["comparable_to_published"]
          and [r["config"] for r in result["rows"]] == ["A", "D-2N"], "grid artifact")
    check(total == (2 * (6 * steps + sampler), 2 * 6 * steps), f"grid launches {total}")
    log(f"  grid: {wall:.2f} s wall, launches fwd/bwd {list(total)}")
    results["grid"] = dict(wall_s=wall, launches=list(total), configs=per_config)

    resumed, wall, total, evs = grid(["--resume"])
    check(total == (0, 0) and not evs, f"grid --resume: launches {total}, calls {len(evs)}")
    check(resumed["rows"] == result["rows"], "grid --resume: rows differ")
    log(f"  grid --resume: {wall:.2f} s, no training, no launches, the same rows")
    results["grid_resume"] = dict(wall_s=wall, launches=list(total))

    reused, wall, total, evs = grid(["--reuse-generated"])
    check(total == (0, 0) and not evs, f"grid --reuse-generated: launches {total}")
    for a, b in zip(reused["rows"], result["rows"]):
        for key in ("is_raw", "fid_raw", "kid_x100_raw"):
            check(abs(a[key] - b[key]) <= EVAL_ATOL + EVAL_RTOL * abs(b[key]),
                  f"grid --reuse-generated {a['config']} {key}: {a[key]} vs {b[key]}")
        check({k: v for k, v in a.items() if not k.endswith("_raw") and k not in
               ("is", "fid", "kid_x100")} == {k: v for k, v in b.items() if not
               k.endswith("_raw") and k not in ("is", "fid", "kid_x100")},
              f"grid --reuse-generated {a['config']}: rows differ")
    log(f"  grid --reuse-generated: {wall:.2f} s, metrics recomputed equal to the rows")
    results["grid_reuse_generated"] = dict(wall_s=wall, launches=list(total))

    # Attention's share of the grid's own D-2N training, steps 10-19.
    kernels, span_ms = read_trace(os.path.join(grid_prof, "trace_grid_CIFAR10_D-2N.json"))
    busy = sum(us for _, us in kernels) / 1e3
    attn = {key: sum(us for n_, us in kernels if key in n_) / 1e3
            for key in ("flash_fwd", "flash_bwd")}
    found = {key: sum(key in n_ for n_, _ in kernels) for key in attn}
    check(all(found.values()), f"grid trace: attention kernels {found}")
    share = sum(attn.values())
    results["grid_step"] = dict(
        steps=10, wall_ms_per_step=span_ms / 10, device_busy_ms_per_step=busy / 10,
        flash_fwd_ms_per_step=attn["flash_fwd"] / 10, flash_bwd_ms_per_step=attn["flash_bwd"] / 10,
        kernel_events=found, attention_share_of_device=share / busy,
        attention_share_of_wall=share / span_ms, idle_share=1.0 - busy / span_ms)
    log(f"  grid D-2N training, steps 10-19 traced: {span_ms / 10:.2f} ms per step wall, "
        f"device busy {busy / 10:.3f} ms, attention {share / 10:.4f} ms per step = "
        f"{share / busy:.4f} of device time, {share / span_ms:.5f} of the wall "
        f"(kernel events {found}; trace export {per_config[1]['trace_export_s']:.2f} s, "
        f"left out of the train time)")

    # MNIST CSV through the C++ loader.
    rng = np.random.default_rng(6)
    csv_path = os.path.join(root, "mnist.csv")
    rows = np.concatenate([rng.integers(0, 10, (64, 1)), rng.integers(0, 256, (64, 784))], axis=1)
    np.savetxt(csv_path, rows, fmt="%d", delimiter=",", comments="",
               header=",".join(["label"] + [f"p{i}" for i in range(784)]))
    mnist_root = os.path.join(root, "mnist_root")
    fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    check(cli.main(["train", "--variant", "3", "--compute-dtype", "bfloat16",
                    "--dataset", "MNIST", "--dataset-path", csv_path,
                    "--image-channels", "1", "--epochs", "1", "--batch-size", "16",
                    "--image-gen-per-epoch", "0", "--root", mnist_root, "--device", "cuda"]) == 0,
          "train on the MNIST CSV")
    wall = time.perf_counter() - t0
    with open(os.path.join(mnist_root, "runs", "DDPM_Uncondtional_MNIST_3", "metrics.jsonl")) as f:
        header = json.loads(f.readline())
    native_loader = header["impl"]["native_loader"]
    check(native_loader == "loaded", f"MNIST CSV: native_loader {native_loader}")
    check(counts() == (24, 24), f"MNIST CSV: launches {counts()}")
    log(f"  train on a 64-row MNIST CSV: {wall:.2f} s, native_loader {native_loader}, "
        f"launches {list(counts())}")
    results["mnist_csv"] = dict(wall_s=wall, native_loader=native_loader,
                                launches=list(counts()), loader_us=time_loader(data, native))

    # Exact resume in f32: 2 epochs straight against 1 + a resumed 1.
    resume_flags = ["train", "--variant", "3", "--image-channels", "3",
                    "--compute-dtype", "float32", "--checkpoint-opt-state",
                    "--batch-size", "64", "--image-gen-per-epoch", "0", "--dataset", "CIFAR10",
                    "--device", "cuda"]
    straight, split = os.path.join(root, "straight"), os.path.join(root, "split")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)  # names what is not
    torch.utils.deterministic.fill_uninitialized_memory = False
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            check(cli.main([*resume_flags, "--epochs", "2", "--root", straight]) == 0, "2 epochs")
            check(cli.main([*resume_flags, "--epochs", "1", "--root", split]) == 0, "1 epoch")
            check(cli.main([*resume_flags, "--epochs", "1", "--root", split, "--resume"]) == 0,
                  "resume")
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        torch.utils.deterministic.fill_uninitialized_memory = True
    wall = time.perf_counter() - t0
    nondeterministic = sorted({str(w.message)[:120] for w in caught
                               if "deterministic" in str(w.message)})
    log(f"  exact resume: ops without a deterministic version: {nondeterministic or 'none'}")
    ckpt = os.path.join("models", "DDPM_Uncondtional_CIFAR10_3", "ckpt_CIFAR10_3.npz")
    worst, worst_key = 0.0, ""
    with np.load(os.path.join(straight, ckpt)) as a, np.load(os.path.join(split, ckpt)) as b:
        check(set(a.files) == set(b.files) and int(a["step"]) == int(b["step"]) == 16,
              "exact resume: checkpoint keys or steps")
        check(any(k.startswith("opt_state/0/.mu/") for k in a.files), "no AdamW moments saved")
        for key in a.files:
            share = float(np.abs(a[key].astype(np.float64) - b[key]).max()) / max(
                float(np.abs(a[key]).max()), 1e-30)
            if share > worst:
                worst, worst_key = share, key
    log(f"  exact resume, f32, 16 steps: worst difference {worst:.2e} of its tensor's largest "
        f"entry ({worst_key or 'none'}; limit {RESUME_REL_TOL}); {wall:.2f} s for the three runs")
    check(worst <= RESUME_REL_TOL, f"exact resume: {worst_key} differs by {worst}")
    results["exact_resume"] = dict(worst_rel=worst, worst_key=worst_key, wall_s=wall,
                                   nondeterministic_ops=nondeterministic)

    # --profile-dir: 25 steps (512 synthetic images at batch 21), steps 10-19 traced.
    prof_dir = os.path.join(root, "profile")
    check(cli.main(["train", "--variant", "3", "--image-channels", "3",
                    "--compute-dtype", "bfloat16",
                    "--batch-size", "21", "--epochs", "1", "--image-gen-per-epoch", "0",
                    "--dataset", "CIFAR10", "--root", os.path.join(root, "prof_root"),
                    "--profile-dir", prof_dir, "--device", "cuda"]) == 0, "train --profile-dir")
    trace = os.path.join(prof_dir, "trace_DDPM_Uncondtional_CIFAR10_3.json")
    check(os.path.exists(trace), f"no trace at {trace}")
    kernels, _ = read_trace(trace)
    found = {key: sum(key in n for n, _ in kernels) for key in ("flash_fwd", "flash_bwd")}
    check(all(found.values()), f"trace {trace}: kernels {found}")
    log(f"  train --profile-dir: {os.path.getsize(trace) / 1e6:.1f} MB trace, kernel events "
        f"{found} (10 steps: 60 forward, 180 backward expected)")
    results["profile_dir"] = dict(trace_bytes=os.path.getsize(trace), kernel_events=found)

    # Config E at 128 px: the gather plan, card against CPU, then the sampler.
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 128, 128, 3)).astype(np.float32))
    rot_err = {}
    for order in (1, 3):
        check(isinstance(rotation.build_rotation(128, 1.8, order, "cuda"), rotation.GatherRotation),
              "128 px: not the gather plan")
        got = rotation.rotate_nhwc(x.cuda(), 1.8, order).cpu()
        rot_err[order] = (got - rotation.rotate_nhwc(x, 1.8, order)).abs().max().item()
        check(rot_err[order] <= ROTATE_ATOL, f"rotate_nhwc 128 px order {order}: {rot_err[order]}")
    log(f"  rotate_nhwc 128 px, card vs cpu: order 1 {rot_err[1]:.1e}, order 3 {rot_err[3]:.1e} "
        f"(limit {ROTATE_ATOL})")
    operands = []
    plain_build = rotation.build_rotation

    def spy_build(*a, **k):
        operands.append(plain_build(*a, **k))
        return operands[-1]

    sample_args = cli.build_parser().parse_args(
        ["sample", "--variant", "3", "--image-channels", "3", "--compute-dtype", "bfloat16",
         "--random-weights", "--image-size", "128", "--theta", "90",
         "--noise-steps", "50", "--n", "4", "--device", "cuda",
         "--out", os.path.join(root, "e128.png")])
    import aliasfree_diffusion_models_pytorch_tpu_torch.diffusion as diffusion_mod

    diffusion_mod.build_rotation = spy_build
    try:
        cli.run_sample(sample_args)  # first call: the plan and the 128-px operands built
        torch.cuda.synchronize()
        fa.flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        final = cli.run_sample(sample_args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        diffusion_mod.build_rotation = plain_build
    launches = fa.flash_attention_fwd.launches
    check(all(isinstance(op, rotation.GatherRotation) for op in operands) and operands,
          "128-px sampler did not take the gather plan")
    check(launches == 6 * 49, f"128-px sampler: {launches} launches, expected {6 * 49}")
    check(final.shape == (4, 128, 128, 3) and final.std() > 0, "128-px sampler output")
    events_, pwall = device_events(lambda: cli.run_sample(sample_args), {"flash_fwd": 6 * 49})
    busy = sum(us for _, us in events_) / 1e3
    attn = sum(us for n_, us in events_ if "flash_fwd" in n_) / 1e3
    results["config_e_128"] = dict(wall_s=wall, launches=launches, steps=49,
                                   ms_per_step=wall / 49 * 1e3, device_ms_per_step=busy / 49,
                                   flash_fwd_ms_per_step=attn / 49, rotate_err=rot_err)
    log(f"  sample 128 px, Config E (theta 90, 50 noise steps, n=4, bf16, base width 128): "
        f"{wall:.2f} s, {wall / 49 * 1e3:.1f} ms per step wall, {busy / 49:.2f} ms per step on the "
        f"device (flash_fwd {attn / 49:.2f} ms), {launches} launches, gather plan")
    return results


def read_trace(path: str) -> tuple[list[tuple[str, float]], float]:
    """The kernels of a torch.profiler Chrome trace as (name, device us), and
    the trace's span in ms, first event start to last event end."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [(e.get("name", ""), float(e["dur"])) for e in events if e.get("cat") == "kernel"]
    span_us = (max(float(e["ts"]) + float(e["dur"]) for e in events)
               - min(float(e["ts"]) for e in events))
    return kernels, span_us / 1e3


def time_loader(data, native) -> dict:
    """Host microseconds per call of the loader's two per-epoch and per-batch
    operations, the C++ binding against numpy (median of repeats): the
    splitmix64 permutation of the grid tree's 320 images and of MNIST's 60000,
    and the gather of a batch of 16 from 4096 32x32x3 f32 images (the grid's)."""
    def median_us(fn, reps):
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e6

    check(native.load_native() is not None, "native loader not built")
    out = {}
    for n, reps in ((320, 200), (60000, 9)):
        out[f"permutation_{n}"] = dict(
            cpp=median_us(lambda: native.shuffled_permutation(n, 42, 1), reps),
            numpy=median_us(lambda: data.splitmix64_permutation(n, 42, 1), reps))
    images = np.random.default_rng(8).standard_normal((4096, 32, 32, 3)).astype(np.float32)
    perm = data.splitmix64_permutation(len(images), 42, 1)
    check(np.array_equal(native.gather_batch(images, perm, 160, 16), images[perm[160:176]]),
          "native gather differs from numpy indexing")
    out["gather_16x32x32x3"] = dict(
        cpp=median_us(lambda: native.gather_batch(images, perm, 160, 16), 2000),
        numpy=median_us(lambda: images[perm[160:176]], 2000))
    for key, t in out.items():
        log(f"  loader {key}: C++ {t['cpp']:.2f} us, numpy {t['numpy']:.2f} us per call "
            f"(host)")
    return out


def profile_step(step, state, batch, fg: int, dtype=torch.bfloat16) -> dict:
    """Device time and kernel count of one train step (torch.profiler); ``fg``
    filtered-GELU forward (and as many backward) launches a step."""
    events, wall = device_events(lambda: step(state, batch)[1].item(),
                                 {"flash_fwd": 6, "flash_bwd": 6 * BWD_KERNELS[dtype],
                                  "filtered_gelu": 2 * fg})
    busy = {"total": 0.0, "flash_fwd": 0.0, "flash_bwd": 0.0, "filtered_gelu": 0.0,
            "layer_norm": 0.0}
    by_name: dict[str, list] = {}  # kernel name -> [device us, launches]
    for name, us in events:
        busy["total"] += us
        entry = by_name.setdefault(name, [0.0, 0])
        entry[0] += us
        entry[1] += 1
        for key in ("flash_fwd", "flash_bwd", "filtered_gelu"):
            if key in name:
                busy[key] += us
        if any(k in name for k in LN_KERNELS):
            busy["layer_norm"] += us
    kernels = len(events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"profiled_wall_ms": round(wall * 1e3, 3),
            "device_busy_ms": round(busy["total"] / 1e3, 3), "device_kernels": kernels,
            "depthwise_conv_kernels": sum("conv_depthwise2d" in name for name, _ in events),
            "flash_fwd_ms": round(busy["flash_fwd"] / 1e3, 4),
            "flash_bwd_ms": round(busy["flash_bwd"] / 1e3, 4),
            "filtered_gelu_ms": round(busy["filtered_gelu"] / 1e3, 4),
            "layer_norm_ms": round(busy["layer_norm"] / 1e3, 4),
            "top_kernels": [{"name": name[:100], "ms": round(us / 1e3, 3), "launches": count}
                            for name, (us, count) in top]}


# Phase 6's steps: (image, base width, batch, warm-up steps, timed steps, the
# filtered-GELU forms to run): 32 px and 64 px with the kernel pair and, in the
# same run, with AFDM_FG_IMPL=conv; then the two 128-px regimes of
# benchmarks/train128.py (TRAIN_128). bf16, Config D.
STEP_CELLS = [(32, 32, 256, 3, 10, ("phases", "conv")), (64, 64, 32, 2, 5, ("phases", "conv"))] + [
    (128, width, batch, 2, 5, ("phases",)) for _, width, batch in TRAIN_128]
# ... and the f32 steps at 32 px, graphed like the bf16 ones: (config, variant,
# batch, warm-up steps, timed steps). Config A (variant 0, no filters) is the
# JAX CLI's default model. Config D's f32 filtered GELU takes the conv form,
# whose step held 23.7 GB at batch 256 in bf16 and would hold about twice that
# in f32, so it runs at batch 64.
STEP_CELLS_F32 = [("A", 0, 256, 3, 10), ("D", 3, 64, 3, 10)]


def time_step(fa, rs, step, state, batch, warm: int, timed: int, dtype) -> tuple:
    """Steady-state ms per step over ``timed`` steps after ``warm`` (a ``.item()``
    closes the timed region), the launch counts, and one profiled step."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops import layer_norm as ln

    for _ in range(warm):
        state, loss = step(state, batch)
    loss.item()
    fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
    rs.filtered_gelu_fwd.launches = rs.filtered_gelu_bwd.launches = 0
    ln.layer_norm_fwd.launches = ln.layer_norm_bwd.launches = 0
    t0 = time.perf_counter()
    for _ in range(timed):
        state, loss = step(state, batch)
    final_loss = loss.item()  # waits for the device inside the timed region
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    counts = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    fg = rs.filtered_gelu_fwd.launches // timed
    check(counts == (6 * timed, 6 * timed), f"steps: launches {counts}")
    check(rs.filtered_gelu_fwd.launches == rs.filtered_gelu_bwd.launches == fg * timed,
          f"steps: filtered_gelu launches {rs.filtered_gelu_fwd.launches}, "
          f"{rs.filtered_gelu_bwd.launches}")
    ln_counts = (ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches)
    check(ln_counts == (12 * timed, 12 * timed), f"steps: layer_norm launches {ln_counts}")
    check(math.isfinite(final_loss), f"step loss {final_loss}")
    return step_ms, final_loss, fg, profile_step(step, state, batch, fg, dtype)


def phase_step_time(fa, rs, config) -> list[dict]:
    """Steady-state train step on one fixed batch at each STEP_CELLS entry,
    with each filtered-GELU form it names, then at each STEP_CELLS_F32 entry.
    Peak memory counts from before the warm-up steps."""
    import dataclasses

    from aliasfree_diffusion_models_pytorch_tpu_torch import train as train_mod
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion

    runs = [(dataclasses.replace(config, image_size=px, base_width=width, batch_size=n,
                                 run_name=f"bench{px}"), "D", warm, timed, impls)
            for px, width, n, warm, timed, impls in STEP_CELLS]
    runs += [(dataclasses.replace(config, image_size=32, base_width=32, batch_size=n,
                                  variant=variant, filters=config.filters if variant else None,
                                  compute_dtype="float32", run_name=f"bench32_f32_{name}"),
              name, warm, timed, (None,))
             for name, variant, n, warm, timed in STEP_CELLS_F32]
    results = []
    for cfg, name, warm, timed, impls in runs:
        px, width, n = cfg.image_size, cfg.base_width, cfg.batch_size
        dtype = getattr(torch, cfg.compute_dtype)
        model, state = train_mod.create_train_state(cfg, device="cuda")
        step_fn = train_mod.make_train_step(
            model, cfg, Diffusion(noise_steps=1000, img_size=px, device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        step = lambda st, b: step_fn(st, b, gen)  # noqa: E731
        rng = np.random.default_rng(0)
        batch = torch.from_numpy(rng.standard_normal((n, px, px, 3)).astype(np.float32)).cuda()
        for impl in impls:
            if impl is not None:
                os.environ["AFDM_FG_IMPL"] = impl
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                step_ms, final_loss, fg, prof = time_step(fa, rs, step, state, batch, warm, timed,
                                                          dtype)
            finally:
                os.environ.pop("AFDM_FG_IMPL", None)
            # the kernel pair runs in bf16 under `phases`; f32 takes the conv form
            check((fg > 0) == (impl == "phases"), f"{px}px {impl}: {fg} filtered_gelu launches")
            attn_ms = prof["flash_fwd_ms"] + prof["flash_bwd_ms"]
            row = dict(px=px, base_width=width, batch=n, config=name, dtype=cfg.compute_dtype,
                       fg_impl=impl or ("conv (f32)" if cfg.filters else "none"), step_ms=step_ms,
                       imgs_per_s=n / step_ms * 1e3,
                       idle_share=1.0 - prof["device_busy_ms"] / step_ms,
                       attention_share=attn_ms / prof["device_busy_ms"],
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                       fg_launches_per_step=fg, final_loss=final_loss, **prof)
            results.append(row)
            log(f"  {px}px Config {name} base width {width} batch {n} {cfg.compute_dtype}, "
                f"filtered GELU {row['fg_impl']}: "
                f"{step_ms:.2f} ms per step, {row['imgs_per_s']:.1f} images/s, device busy "
                f"{prof['device_busy_ms']:.2f} ms (idle share {row['idle_share']:.2f}), "
                f"{prof['device_kernels']} kernels per step, flash_fwd {prof['flash_fwd_ms']:.3f}"
                f" ms + flash_bwd {prof['flash_bwd_ms']:.3f} ms ({row['attention_share']:.3f} of "
                f"the device time), filtered_gelu "
                f"{prof['filtered_gelu_ms']:.3f} ms ({fg} + {fg} launches) per step, "
                f"layer_norm {prof['layer_norm_ms']:.3f} ms (12 + 12 launches), "
                f"{prof['depthwise_conv_kernels']} depthwise conv kernels, "
                f"peak memory {row['peak_mem_gb']:.2f} GB")
            for k in prof["top_kernels"]:
                log(f"    {k['ms']:8.3f} ms {k['launches']:5d}x  {k['name']}")
        del model, state, step_fn, step, batch
        torch.cuda.empty_cache()
    return results


# Phase 6a: bench_torch.py as a child process. bench.py's keys (its `out`
# dict, the 64-px regime's included), the timed steps of its card branch, and
# how far its step may be from phase 6's graphed 32-px bf16 step (the same
# step at the same batch, timed in another process).
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "batch_size", "n_devices", "mesh",
              "backend", "device_kind", "compute_dtype", "step_ms", "final_loss",
              "flops_per_step", "mfu", "sample_1000step_n16_wall_s", "ddim_50step_n16_wall_s",
              "train64_step_ms", "train64_imgs_per_sec_b32", "train64_flops_per_step",
              "train64_mfu", "phase_s")
BENCH_NUMBERS = [k for k in BENCH_KEYS if k not in (
    "metric", "unit", "mesh", "backend", "device_kind", "compute_dtype", "phase_s")]
BENCH_TIMED_STEPS = 30
BENCH_STEP_RTOL = 0.15
BENCH_TIMEOUT_S = 420


def phase_bench(step_rows: list[dict]) -> dict:
    """Run ``python3 bench_torch.py`` from the checkout's root, as a user
    would, on the kernels phase 1 built, and check its one line: bench.py's
    keys, finite numbers, the card's name, both MFUs in (0, 1], the step
    within BENCH_STEP_RTOL of phase 6's, and the launches of its timed steps
    (its stderr) those of 30 graphed steps, the LayerNorm pair's 12 + 12
    a step among them. Prints the line."""
    import re

    _free_device_memory()
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(root, "bench_torch.py")], cwd=root,
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        log(f"  {line[:400]}")
    check(proc.returncode == 0, f"bench_torch.py exited {proc.returncode}")
    lines = proc.stdout.strip().splitlines()
    check(len(lines) == 1, f"bench_torch.py printed {len(lines)} lines on stdout")
    print(lines[0], flush=True)  # the bench's line as it printed it
    res = json.loads(lines[0])
    check(tuple(res) == BENCH_KEYS, f"bench keys {list(res)}")
    bad = [k for k in BENCH_NUMBERS if not (isinstance(res[k], (int, float))
                                            and math.isfinite(res[k]))]
    bad += [k for k, v in res["phase_s"].items() if not math.isfinite(v)]
    check(not bad, f"bench: not a finite number: {bad}")
    check(res["backend"] == "cuda" and res["compute_dtype"] == "bfloat16"
          and res["n_devices"] == 1 and res["mesh"] is None and res["batch_size"] == 256,
          f"bench settings {res}")
    check(res["device_kind"] == torch.cuda.get_device_name(0), f"bench device {res['device_kind']}")
    check(0 < res["mfu"] <= 1 and 0 < res["train64_mfu"] <= 1,
          f"bench mfu {res['mfu']}, train64_mfu {res['train64_mfu']}")
    ref = next(r for r in step_rows if r["px"] == 32 and r["dtype"] == "bfloat16"
               and r["fg_impl"] == "phases")
    check(abs(res["step_ms"] - ref["step_ms"]) <= BENCH_STEP_RTOL * ref["step_ms"],
          f"bench step {res['step_ms']} ms, phase 6's {ref['step_ms']:.2f} ms")
    found = re.search(r"launches (\{[^}]*\})", proc.stderr)
    check(found is not None, "bench: no launch counts on stderr")
    launches = json.loads(found.group(1))
    n = BENCH_TIMED_STEPS
    fg = ref["fg_launches_per_step"] * n
    check(launches.get("flash_attention_fwd") == 6 * n
          and launches.get("flash_attention_bwd") == 6 * n
          and launches.get("filtered_gelu_fwd") == launches.get("filtered_gelu_bwd") == fg > 0
          and launches.get("plain_gelu_fwd") == launches.get("plain_gelu_bwd") == 6 * n
          and launches.get("layer_norm_fwd") == launches.get("layer_norm_bwd") == 12 * n,
          f"bench launches {launches}: expected {6 * n} attention, {fg} filtered-GELU, "
          f"{6 * n} plain-GELU and {12 * n} LayerNorm launches each way")
    log(f"  bench: {res['value']} imgs/s/chip, step {res['step_ms']} ms (phase 6: "
        f"{ref['step_ms']:.2f} ms), mfu {res['mfu']}, train64 {res['train64_step_ms']} ms "
        f"(mfu {res['train64_mfu']}), DDPM-1000 {res['sample_1000step_n16_wall_s']} s, DDIM-50 "
        f"{res['ddim_50step_n16_wall_s']} s; child process {wall:.1f} s")
    return {"line": res, "timed_launches": launches, "phase6_step_ms": ref["step_ms"],
            "child_s": wall}


# Phase 6b: graphed against eager, in turns in one run. The samplers of phase
# 4 (n = 16, bf16, 32 px), the shift sweep's sampler of phase 7 and the
# Config-E sampler of phase 8 at 128 px: (name, image size, base width,
# classes, noise steps, n, sampler call, UNet forwards a call).
GRAPH_SAMPLERS = [
    ("ddpm1000", 32, 32, None, 1000, 16, lambda d, m, g: d.sample(m, 16, 3, generator=g), 999),
    ("ddim50", 32, 32, None, 1000, 16,
     lambda d, m, g: d.sample_ddim(m, 16, 3, generator=g, steps=50), 50),
    ("ddim20_cfg3", 32, 32, 10, 1000, 16,
     lambda d, m, g: d.sample_ddim(m, 16, 3, generator=g, steps=20, labels=3, cfg_scale=3.0), 20),
    ("shift8_200", 32, 32, None, 200, 16,
     lambda d, m, g: d.sample_shift(m, 16, 3, generator=g, shift=8), 199),
    ("config_e_128px", 128, 128, None, 50, 4,
     lambda d, m, g: d.sample(m, 4, 3, generator=g, theta=90.0), 49),
]
# Phase 6b's steps: phase 6's, and the grid's D-2N step at its batch of 16
# (reproduce.py:_build_config: Config D, kernel 3, β 2, bf16, 32 px).
GRAPH_STEP_CELLS = STEP_CELLS + [(32, 32, 16, 3, 10, ("phases",))]
# The f32 step held bit-equal graphed against eager (32 px, base width 32),
# and the capturable AdamW against the plain one: batch, steps.
GRAPH_F32_STEP = (64, 6)
# Capturable AdamW (step count and lr on the device, its bias corrections in
# f32 there) against the plain one (lr and bias corrections in float64 on the
# host). The first update starts from the same parameters and, under
# deterministic algorithms, the same gradients. The two updates (each at most
# lr, 3e-4) differ by 6.4e-6 of their size: β2 = 0.999 rounded to f32 makes
# 1 − β2 off by 1.3e-5, and √(1 − β2) scales the update; f32 roundings add
# about 1e-6. So after it every parameter within 1e-5·lr of the plain run's,
# plus two f32 ulps of the parameter (2^-22 relative) for its own rounding.
# Later steps see gradients of parameters that differ, and AdamW's
# normalisation turns that noise in a near-zero gradient into moves of up to
# lr: after all steps only the bound both obey, 2·lr per update.
ADAMW_FIRST_RTOL, ADAMW_FIRST_ATOL = 2.0**-22, 1e-5 * 3e-4
# bf16 steps graphed against eager: dQ's atomics make two eager runs differ
# from the first rounding that they add in another order, and the graphed
# run differs from an eager one in the same way. Where that starts varies,
# so the mean |difference| of two runs after a few steps varies by orders of
# magnitude from pair to pair, far below the parameters' own movement over
# those steps. Held: the graphed run's mean difference
# from an eager run, and the eager runs' own, each within 1% of the eager
# run's mean movement (the key bias left out: see param_difference). A step
# that replayed the wrong noise, batch or learning rate moves the parameters
# elsewhere by a share of their movement itself.
BF16_STEP_SHARE = 1e-2


def _deterministic_algorithms(on: bool) -> None:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = on
    torch.use_deterministic_algorithms(on, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = not on


def param_difference(a: dict, b: dict) -> tuple[float, float]:
    """(mean, max) of |a − b| over every entry of two parameter sets, the key
    part of each attention's qkv bias left out: softmax ignores a shift of the
    keys, so its true gradient is 0 and AdamW moves it by about lr a step on
    rounding noise alone, whatever else the runs share."""
    total, count, worst = 0.0, 0, 0.0
    for name, value in a.items():
        d = (value - b[name]).abs().flatten()
        if name.endswith(".qkv.bias"):
            third = d.numel() // 3
            d = torch.cat([d[:third], d[2 * third:]])
        total += d.sum().item()
        count += d.numel()
        worst = max(worst, d.max().item())
    return total / count, worst


def _free_device_memory() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def phase_graphs(fa, rs, weights, unet_mod, config, fg: int) -> dict:
    """The samplers and the train steps with CUDA graphs (the default) and
    with ``graphs=False``, in turns, from the same weights and generator
    seeds: outputs bit-equal, the same launch counts, one replay's kernels in
    torch.profiler against the counters' replay count, wall and device time
    per step, peak memory; the f32 step bit-equal over several steps, the
    bf16 step within the spread of two eager runs, the capturable AdamW
    against the plain one."""
    import dataclasses

    from aliasfree_diffusion_models_pytorch_tpu_torch import diffusion as diffusion_mod
    from aliasfree_diffusion_models_pytorch_tpu_torch import train as train_mod
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops import layer_norm as ln

    Diffusion = diffusion_mod.Diffusion
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd, rs.filtered_gelu_fwd,
                rs.filtered_gelu_bwd, ln.layer_norm_fwd, ln.layer_norm_bwd)
    results: dict = {"sampling": [], "train": []}

    for name, px, width, classes, steps, n, call, forwards in GRAPH_SAMPLERS:
        cfg = dataclasses.replace(config, image_size=px, base_width=width, num_classes=classes)
        model = unet_mod.build_model(cfg, device="cuda", state_dict=weights.init_params(cfg, 0))
        row = dict(name=name, image=px, n=n, noise_steps=steps, forwards=forwards)
        outs = {}
        for mode in ("graphed", "eager"):
            d = Diffusion(noise_steps=steps, img_size=px, device="cuda",
                          graphs=mode == "graphed")
            gen = torch.Generator(device="cuda")
            if mode == "graphed":  # warm-up and capture; the eager path has nothing to set up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call(d, model, gen.manual_seed(0))
                torch.cuda.synchronize()
                row["graphed_first_call_s"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            outs[mode] = call(d, model, gen.manual_seed(1))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = (fa.flash_attention_fwd.launches, rs.filtered_gelu_fwd.launches,
                      ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches)
            # DDPM-1000: 999 forwards, 11,988 LayerNorm launches
            check(counts == (6 * forwards, fg * forwards, 12 * forwards, 0),
                  f"{name} {mode}: launches (flash_fwd, filtered_gelu, layer_norm fwd, bwd) "
                  f"{counts}, expected {(6 * forwards, fg * forwards, 12 * forwards, 0)}")
            row[f"{mode}_s"] = wall
            row[f"{mode}_ms_per_step"] = wall / forwards * 1e3
            row["launches"] = counts
        for a, b in zip(*(o if isinstance(o, tuple) else (o,) for o in outs.values())):
            check(torch.equal(a, b), f"{name}: graphed and eager outputs differ")
        # One replay of a captured step under torch.profiler: its kernels
        # against what the launch counters add for a replay. The step index is
        # set back to a valid step first (the loop left it past its end).
        (sampler,) = [s_ for s_ in diffusion_mod._SAMPLERS[model].values()
                      if s_.graphs and s_.captured]
        variant = sampler.captured[0]

        def replay():
            with torch.inference_mode():  # the sampler's buffers are inference tensors
                sampler.index.fill_(1)
                sampler(variant)

        before = [c.launches for c in counters]
        replay()
        per_replay = [c.launches - b for c, b in zip(counters, before)]
        check(per_replay == [6, 0, fg, 0, 12, 0],
              f"{name}: counters add {per_replay} for a replay")
        events, _ = device_events(replay, {"flash_fwd": 6, "filtered_gelu": fg,
                                           "ln_fwd_kernel": 12})
        row["replay_device_ms"] = sum(us for _, us in events) / 1e3
        row["replay_kernels"] = len(events)
        row["replay_counted"] = per_replay
        results["sampling"].append(row)
        log(f"  {name} ({px} px, n={n}, {forwards} forwards): graphed {row['graphed_s']:.3f} s "
            f"({row['graphed_ms_per_step']:.3f} ms a step; first call with warm-up and capture "
            f"{row['graphed_first_call_s']:.3f} s), eager {row['eager_s']:.3f} s "
            f"({row['eager_ms_per_step']:.3f} ms a step); bit-equal; launches {counts}; one "
            f"replay: {row['replay_kernels']} kernels, {row['replay_device_ms']:.3f} ms on the "
            f"device, counters {per_replay}")
        del model, sampler, replay, outs
        _free_device_memory()

    # The steps with the kernel pair: graphed, eager, eager again.
    for px, width, n, warm, timed, _ in GRAPH_STEP_CELLS:
        cfg = dataclasses.replace(config, image_size=px, base_width=width, batch_size=n,
                                  run_name=f"graphs{px}")
        batch = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (n, px, px, 3)).astype(np.float32)).cuda()
        row = dict(px=px, base_width=width, batch=n)
        params = {}
        for mode in ("graphed", "eager", "eager_again"):
            # Peak memory counts from what was allocated before this run's
            # model: what earlier runs left behind is not the run's own.
            base = torch.cuda.memory_allocated()
            model, state = train_mod.create_train_state(cfg, device="cuda")
            if mode == "eager":
                params["start"] = {k: v.clone() for k, v in state.params.items()}
            step_fn = train_mod.make_train_step(
                model, cfg, Diffusion(noise_steps=1000, img_size=px, device="cuda"),
                graphs=mode == "graphed")
            gen = torch.Generator(device="cuda")

            def step(st, b, i):
                return step_fn(st, b, train_mod.step_generator(gen, 0, i))

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for i in range(warm):
                state, loss = step(state, batch, i)
            loss.item()
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            for i in range(warm, warm + timed):
                state, loss = step(state, batch, i)
            final_loss = loss.item()
            step_ms = (time.perf_counter() - t0) / timed * 1e3
            counts = [c.launches for c in counters]
            check(counts == [6 * timed, 6 * timed, fg * timed, fg * timed, 12 * timed,
                             12 * timed], f"{px}px {mode} steps: launches {counts}")
            check(math.isfinite(final_loss), f"{px}px {mode}: loss {final_loss}")
            params[mode] = {k: v.clone() for k, v in state.params.items()}
            entry = dict(step_ms=step_ms,
                         peak_mem_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                         final_loss=final_loss)
            if mode != "eager_again":
                prof = profile_step(lambda st, b: step(st, b, warm + timed), state, batch, fg)
                entry.update(device_busy_ms=prof["device_busy_ms"],
                             device_kernels=prof["device_kernels"],
                             idle_share=1.0 - prof["device_busy_ms"] / step_ms)
            row[mode] = entry
            del model, state, step_fn, step
            _free_device_memory()
        spread, spread_max = param_difference(params["eager"], params["eager_again"])
        diff, diff_max = param_difference(params["graphed"], params["eager"])
        movement, _ = param_difference(params["eager"], params["start"])
        row.update(eager_spread_mean=spread, eager_spread_max=spread_max,
                   graphed_vs_eager_mean=diff, graphed_vs_eager_max=diff_max,
                   eager_movement_mean=movement)
        check(max(diff, spread) <= BF16_STEP_SHARE * movement,
              f"{px}px: graphed differs from eager by {diff} (mean), two eager runs by "
              f"{spread}, against {BF16_STEP_SHARE} of the movement {movement}")
        results["train"].append(row)
        g, e = row["graphed"], row["eager"]
        log(f"  {px}px base width {width} batch {n} bf16: graphed {g['step_ms']:.2f} ms a step "
            f"(device busy {g['device_busy_ms']:.2f} ms, idle {g['idle_share']:.3f}, "
            f"{g['device_kernels']} kernels, peak {g['peak_mem_gb']:.2f} GB) against eager "
            f"{e['step_ms']:.2f} ms (busy {e['device_busy_ms']:.2f}, idle {e['idle_share']:.3f}, "
            f"{e['device_kernels']} kernels, peak {e['peak_mem_gb']:.2f} GB), eager again "
            f"{row['eager_again']['step_ms']:.2f} ms; parameters after {warm + timed} steps, mean "
            f"(max) |difference|: graphed vs eager {diff:.2e} ({diff_max:.2e}), eager vs eager "
            f"{spread:.2e} ({spread_max:.2e}), eager movement {movement:.2e} (limit "
            f"{BF16_STEP_SHARE} of it)")
        del params, batch
        _free_device_memory()

    # f32 at 32 px: graphed against eager bit for bit, then the capturable
    # AdamW against the plain one, under deterministic algorithms.
    batch_n, steps = GRAPH_F32_STEP
    cfg = dataclasses.replace(config, compute_dtype="float32", batch_size=batch_n)
    batch = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (batch_n, 32, 32, 3)).astype(np.float32)).cuda()
    finals = {}
    _deterministic_algorithms(True)
    try:
        for mode in ("graphed", "eager", "plain_adamw"):
            model, state = train_mod.create_train_state(cfg, device="cuda")
            if mode == "plain_adamw":
                state.optimizer = train_mod.make_optimizer(cfg, state.params.values(),
                                                           capturable=False)
            step_fn = train_mod.make_train_step(
                model, cfg, Diffusion(noise_steps=1000, img_size=32, device="cuda"),
                graphs=mode == "graphed")
            gen = torch.Generator(device="cuda")
            losses = []
            for i in range(steps):
                state, loss = step_fn(state, batch, train_mod.step_generator(gen, 0, i))
                losses.append(loss)
                if i == 0:
                    first = {k: v.clone() for k, v in state.params.items()}
            finals[mode] = (torch.stack(losses), {k: v.clone() for k, v in state.params.items()},
                            state.optimizer.param_groups[0]["capturable"], first)
            del model, state, step_fn
            _free_device_memory()
    finally:
        _deterministic_algorithms(False)
    check(finals["graphed"][2] and finals["eager"][2] and not finals["plain_adamw"][2],
          "f32 steps: the card's optimizer is not capturable")
    check(torch.equal(finals["graphed"][0], finals["eager"][0]), "f32 step: losses differ")
    differing = [k for k, v in finals["graphed"][1].items()
                 if not torch.equal(v, finals["eager"][1][k])]
    check(not differing, f"f32 step: graphed and eager parameters differ in {differing[:4]}")
    first_excess, first_max, worst = 0.0, 0.0, 0.0
    for k, v in finals["eager"][3].items():
        ref = finals["plain_adamw"][3][k]
        err = (v - ref).abs()
        first_max = max(first_max, err.max().item())
        limit = ADAMW_FIRST_ATOL + ADAMW_FIRST_RTOL * ref.abs()
        first_excess = max(first_excess, (err / limit).max().item())
        worst = max(worst, (finals["eager"][1][k] - finals["plain_adamw"][1][k]).abs().max().item())
    bound_ = 2.0 * cfg.lr * steps
    check(first_excess <= 1.0, f"capturable AdamW vs plain, first update: {first_excess} of "
          f"the limit (max |difference| {first_max})")
    check(worst <= bound_, f"capturable AdamW vs plain after {steps} steps: {worst} > {bound_}")
    results["f32_step"] = dict(batch=batch_n, steps=steps, bit_equal=True,
                               adamw_first_update_max=first_max,
                               adamw_first_update_share_of_limit=first_excess,
                               adamw_after_steps_max=worst)
    log(f"  f32 step, 32 px batch {batch_n}, {steps} steps, deterministic algorithms: graphed "
        f"and eager bit-equal (losses and every parameter); capturable AdamW against the plain "
        f"one: first update max {first_max:.2e} ({first_excess:.2f} of its limit), "
        f"after {steps} steps max {worst:.2e} (bound {bound_:.1e})")
    return results


# Phase 2f: the filtered-GELU pair under each AFDM_GELU mode (None: unset, the
# degree-15 polynomial on bf16; poly13; exact, the erf form), at every shape
# of the 32-px bf16 train step, against its plain version (the same limits as
# phase 2e: the bf16 forward equal element for element, the backward within
# 2^-6 of its largest entry), timed per step; then one graphed 32-px Config-D
# bf16 train step at batch 256 under poly13 after the default mode, which
# must take a signature of its own and capture its own graphs.
GELU_MODES = (None, "poly13", "exact")


def _set_gelu_mode(mode) -> None:
    if mode is None:
        os.environ.pop("AFDM_GELU", None)
    else:
        os.environ["AFDM_GELU"] = mode


def phase_gelu_modes(rs, fgres, ptxas, config) -> dict:
    """The kernel pair in every GELU mode at the 32-px step's shapes, its
    registers and spills per mode, and the graphed step under poly13."""
    import dataclasses

    from aliasfree_diffusion_models_pytorch_tpu_torch import train as train_mod
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion

    k = config.filters.kernel_size
    from aliasfree_diffusion_models_pytorch_tpu_torch.models import blocks

    up, down = (torch.from_numpy(t).cuda().bfloat16() for t in blocks.design_taps(config.filters))
    shapes = fgres["steps"]["32px_w32_b256"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    inputs = [((2 * torch.randn(e["shape"], generator=gen, device="cuda")).bfloat16(),
               torch.randn(e["shape"], generator=gen, device="cuda").bfloat16(), e["calls"])
              for e in shapes]
    modes = {}
    try:
        for mode in GELU_MODES:
            _set_gelu_mode(mode)
            form = rs.gelu_form(torch.bfloat16)
            row = dict(mode=mode or "unset", form=form, fwd_ms=0.0, bwd_ms=0.0, fwd_differ=0,
                       bwd_rel=0.0)
            for x, g, calls in inputs:
                y, dx = rs.filtered_gelu_fwd(x, up, down), rs.filtered_gelu_bwd(x, up, down, g)
                xg = x.clone().requires_grad_()
                ref = rs.filtered_gelu_phases(xg, up, down)
                (ref_dx,) = torch.autograd.grad(ref, xg, g)
                differ = int((y != ref).sum())
                _, rel = errors(dx, ref_dx)
                tag = f"AFDM_GELU={mode or 'unset'} {tuple(x.shape)}"
                check(differ == 0, f"filtered_gelu {tag}: {differ} forward elements differ")
                check(rel <= FG_REL_TOL[torch.bfloat16][1] and bool(torch.isfinite(dx).all()),
                      f"filtered_gelu {tag}: backward {rel} of its largest entry")
                row["fwd_differ"] += differ
                row["bwd_rel"] = max(row["bwd_rel"], rel)
                row["fwd_ms"] += calls * device_ms(lambda: rs.filtered_gelu_fwd(x, up, down),
                                                   iters=10, per_call={"filtered_gelu_fwd": 1})
                row["bwd_ms"] += calls * device_ms(lambda: rs.filtered_gelu_bwd(x, up, down, g),
                                                   iters=10, per_call={"filtered_gelu_bwd": 1})
                del y, dx, xg, ref, ref_dx
            row["ms"] = row["fwd_ms"] + row["bwd_ms"]
            index = str(rs.FG_GELU_FORMS.index(form))
            row["ptxas"] = [e for e in ptxas if e["library"] == "filtered_gelu"
                            and "bf16" in e["kernel"] and e["kernel"].endswith(f", {index}>")]
            check(row["ptxas"] and not any(e["spill_stores"] + e["spill_loads"]
                                           for e in row["ptxas"]),
                  f"filtered_gelu {form}: instantiations missing or spilling")
            side32 = {e["kernel"].split("<")[0]: e["registers"] for e in row["ptxas"]
                      if e["kernel"].endswith(f"<bf16, {k}, 32, 8, {index}>")}
            row["registers_side32"] = side32
            modes[row["mode"]] = row
            log(f"  AFDM_GELU={row['mode']:<6} ({form}): 32-px step's {sum(c for *_, c in inputs)}"
                f" calls, forward + backward {row['ms']:.3f} ms ({row['fwd_ms']:.3f} + "
                f"{row['bwd_ms']:.3f}), 0 forward elements differ, backward "
                f"{row['bwd_rel']:.1e} of its largest entry; side-32 registers {side32}; "
                f"{len(row['ptxas'])} bf16 instantiations, no spill")
    finally:
        _set_gelu_mode(None)
    step_2e = fgres["per_step"]["32px_w32_b256"]
    log(f"  (phase 2e's default-mode pair in this run: "
        f"{step_2e['fwd_ms'] + step_2e['bwd_ms']:.3f} ms a step)")

    # The graphed step: the default mode, then poly13 on the same step.
    cfg = dataclasses.replace(config, batch_size=256, run_name="gelu_modes")
    model, state = train_mod.create_train_state(cfg, device="cuda")
    step_fn = train_mod.make_train_step(model, cfg, Diffusion(noise_steps=1000, img_size=32,
                                                              device="cuda"))
    batch = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, (256, 32, 32, 3)).astype(np.float32)).cuda()
    gen = torch.Generator(device="cuda")
    graphed = {}
    try:
        for mode in (None, "poly13"):
            _set_gelu_mode(mode)
            rs.filtered_gelu_fwd.launches = 0
            for i in range(4):  # warm-up, capture, two replays
                state, loss = step_fn(state, batch, train_mod.step_generator(gen, 0, i))
            final = loss.item()
            check(math.isfinite(final), f"graphed step under {mode}: loss {final}")
            graphed[mode or "unset"] = dict(loss=final, fg_launches=rs.filtered_gelu_fwd.launches)
    finally:
        _set_gelu_mode(None)
    sigs = list(step_fn.signatures.values())
    check(len(sigs) == 2 and all(s.captured for s in sigs),
          f"graphed step: {len(sigs)} signatures for two GELU modes, captured "
          f"{[s.captured for s in sigs]}")
    log(f"  graphed 32-px Config-D bf16 step at batch 256: default mode then poly13, "
        f"{len(sigs)} signatures, each captured ({[s.captured for s in sigs]}); losses "
        f"{graphed}")
    del model, state, step_fn, batch, inputs
    _free_device_memory()
    return dict(modes=modes, default_2e_ms=step_2e["fwd_ms"] + step_2e["bwd_ms"],
                graphed_step=graphed, signatures=len(sigs))


# Phase 2g: the plain GELU's kernel pair (csrc/plain_gelu.cu) at every shape
# and layout gelu_exact takes in one bf16 Config-A train step at batch 256 (a
# spy on the blocks' gelu_exact: the 22 DoubleConv GELUs on GroupNorm's NCHW
# output, the six feed-forward GELUs on Linear's (n, S, C) output). The least
# work of a call: x read once and the result written once, g read once more
# in the backward (4 and 6 bytes an element); the polynomial in about 12 f32
# instructions an element, its derivative in about 20. The filtered-GELU
# pair's side-32 registers at degree 15 and 13, forward / backward, as they
# were before its polynomial moved into the shared header csrc/gelu.cuh,
# must not move.
PG_OPS = {False: 12, True: 20}
FG_SIDE32_REGISTERS = {"poly15": (118, 125), "poly13": (114, 126)}


def pg_times(numel: int, backward: bool) -> tuple[float, float]:
    """(bytes ms, operations ms) of one plain-GELU call."""
    nbytes = (6 if backward else 4) * numel
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * numel * PG_OPS[backward] / FMA_PER_S


def pg_step_calls(unet_mod, blocks, config) -> dict:
    """{(shape, strides): calls} of gelu_exact in one forward of the bf16
    UNet of ``config`` on the card (the backward calls the same)."""
    model = unet_mod.build_model(config, device="cuda")
    calls: dict = {}
    real = blocks.gelu_exact

    def spy(x):
        key = (tuple(x.shape), x.stride())
        calls[key] = calls.get(key, 0) + 1
        return real(x)

    blocks.gelu_exact = spy
    try:
        with torch.no_grad():
            n = config.batch_size
            model(torch.zeros((n, config.image_size, config.image_size, 3), device="cuda"),
                  torch.ones((n,), dtype=torch.long, device="cuda"))
    finally:
        blocks.gelu_exact = real
    del model
    torch.cuda.empty_cache()
    return calls


def phase_plain_gelu(rs, unet_mod, blocks, ptxas) -> dict:
    """The plain GELU's pair at Config A's shapes: bit-equal to the composed
    form and to autograd through it, timed beside the composed form and the
    bound, summed per step; its registers and spills, and the filtered-GELU
    pair's side-32 registers after the header move."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.config import TrainConfig

    config = TrainConfig(image_size=32, image_channels=3, variant=0, batch_size=256,
                         compute_dtype="bfloat16", filters=None)
    calls = pg_step_calls(unet_mod, blocks, config)
    total = sum(calls.values())
    check(total == 28, f"Config A: {total} gelu_exact calls a forward, expected 28")
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    for (shape, stride), n in calls.items():
        x = torch.empty_strided(shape, stride, device="cuda", dtype=torch.bfloat16)
        g = torch.empty_strided(shape, stride, device="cuda", dtype=torch.bfloat16)
        x.copy_(3 * torch.randn(shape, generator=gen, device="cuda"))
        g.copy_(torch.randn(shape, generator=gen, device="cuda"))
        y, dx = rs.plain_gelu_fwd(x), rs.plain_gelu_bwd(x, g)
        xg = x.clone().requires_grad_()
        ref = rs.gelu_poly(xg)
        (ref_dx,) = torch.autograd.grad(ref, xg, g, retain_graph=True)
        torch.cuda.synchronize()
        differ = (int((y != ref).sum()), int((dx != ref_dx).sum()))
        check(differ == (0, 0) and y.stride() == stride,
              f"plain_gelu {shape} {stride}: {differ} elements differ fwd / bwd, strides "
              f"{y.stride()}")
        row = dict(shape=list(shape), strides=list(stride), calls=n)
        timed = {
            "fwd_ms": (lambda: rs.plain_gelu_fwd(x), {"plain_gelu_fwd": 1}),
            "bwd_ms": (lambda: rs.plain_gelu_bwd(x, g), {"plain_gelu_bwd": 1}),
            "composed_fwd_ms": (lambda: rs.gelu_poly(x), None),
            "composed_bwd_ms": (lambda: torch.autograd.grad(ref, xg, g, retain_graph=True),
                                None),
        }
        for key, (fn, per_call) in timed.items():
            row[key] = device_ms(fn, iters=10 if per_call else 3, per_call=per_call)
        numel = math.prod(shape)
        for key, bwd in (("fwd", False), ("bwd", True)):
            row[f"{key}_bound_ms"], _ = bound([pg_times(numel, bwd)])
        rows.append(row)
        log(f"  {str(shape):<22} {str(stride):<22} x{n}: device us fwd/bwd: kernel "
            f"{row['fwd_ms'] * 1e3:7.1f} {row['bwd_ms'] * 1e3:7.1f} bound "
            f"{row['fwd_bound_ms'] * 1e3:6.1f} {row['bwd_bound_ms'] * 1e3:6.1f} composed "
            f"{row['composed_fwd_ms'] * 1e3:8.1f} {row['composed_bwd_ms'] * 1e3:8.1f}")
        del x, g, y, dx, xg, ref, ref_dx
    torch.cuda.empty_cache()
    step = {key: sum(r["calls"] * r[key] for r in rows)
            for key in ("fwd_ms", "bwd_ms", "composed_fwd_ms", "composed_bwd_ms")}
    times = [pg_times(math.prod(r["shape"]), bwd) for r in rows
             for bwd in (False, True) for _ in range(r["calls"])]
    step["bound_ms"], step["bound_by"] = bound(times)
    step["calls"] = total
    log(f"  per Config-A step at batch 256 ({total} calls, forward + backward): kernel "
        f"{step['fwd_ms'] + step['bwd_ms']:.3f} ms ({step['fwd_ms']:.3f} + {step['bwd_ms']:.3f}),"
        f" bound {step['bound_ms']:.3f} ({step['bound_by']}), composed "
        f"{step['composed_fwd_ms'] + step['composed_bwd_ms']:.3f}")
    regs = [e for e in ptxas if e["library"] == "plain_gelu"]
    check(len(regs) == 4 and not any(e["spill_stores"] + e["spill_loads"] for e in regs),
          f"plain_gelu: instantiations missing or spilling: {regs}")
    side32 = {}
    for form in FG_SIDE32_REGISTERS:
        index = rs.FG_GELU_FORMS.index(form)
        side32[form] = tuple(
            next(e["registers"] for e in ptxas if e["library"] == "filtered_gelu"
                 and e["kernel"] == f"filtered_gelu_{way}_kernel<bf16, 3, 32, 8, {index}>")
            for way in ("fwd", "bwd"))
    log(f"  plain_gelu registers: " + ", ".join(f"{e['kernel']} {e['registers']}" for e in regs)
        + f"; filtered-GELU pair at side 32, fwd / bwd: {side32}")
    check(side32 == FG_SIDE32_REGISTERS,
          f"filtered-GELU pair's side-32 registers {side32}, were {FG_SIDE32_REGISTERS}")
    return dict(rows=rows, per_step=step, ptxas=regs, fg_side32_registers=side32)


# Phase 2h: the attention block's LayerNorm pair (csrc/layer_norm.cu) at the
# twelve calls of one bf16 32-px train step at batch 256 (forward hooks on the
# model's TokenLayerNorms: each block's ln on its NCHW map read channel-major,
# its ff_ln on the residual sum in row order) and the twelve forward calls of
# a sampling forward at n=200, and in f32 the calls of the examples' step (32
# px, batch 64) and of the 128-px step at base width 128 (batch 4: C = 512 at
# sa2 and sa3), against the form the port ran before: the tokens copied into
# row order and nn.LayerNorm (F.layer_norm, autograd's backward). The least
# work of a call: x read once and y written once forward (2 elements' bytes),
# x and dy read and dx written backward (3); about 8 and 16 f32 instructions
# an element. Each result is held as in tests/test_torch_layer_norm.py: bf16
# within one unit in the last place of nn.LayerNorm's and a floor for values
# that cancel, 2^-16 of the magnitude of their terms; f32 against the float64
# computation within 2^-18 (y, dx) and 2^-20 (dw, db) of those magnitudes.
LN_OPS = {False: 8, True: 16}
LN_FLOORS = {torch.bfloat16: (2.0**-16, 2.0**-16), torch.float32: (2.0**-18, 2.0**-20)}
LN_EPS = 1e-5
# the pair's kernels, as their names show in a trace
LN_KERNELS = ("ln_fwd_kernel", "ln_bwd_kernel", "ln_dparams_kernel")


def ln_times(numel: int, backward: bool, dtype=torch.bfloat16) -> tuple[float, float]:
    """(bytes ms, operations ms) of one LayerNorm call."""
    nbytes = (3 if backward else 2) * numel * torch.finfo(dtype).bits // 8
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * numel * LN_OPS[backward] / FMA_PER_S


def ln_calls(unet_mod, config) -> dict:
    """{(shape, strides): calls} of the TokenLayerNorms in one forward of the
    UNet of ``config`` on the card."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops.layer_norm import TokenLayerNorm

    model = unet_mod.build_model(config, device="cuda")
    calls: dict = {}

    def hook(mod, inp, out):
        key = (tuple(inp[0].shape), inp[0].stride())
        calls[key] = calls.get(key, 0) + 1

    for m in model.modules():
        if isinstance(m, TokenLayerNorm):
            m.register_forward_hook(hook)
    with torch.no_grad():
        n = config.batch_size
        model(torch.zeros((n, config.image_size, config.image_size, 3), device="cuda"),
              torch.ones((n,), dtype=torch.long, device="cuda"))
    del model
    torch.cuda.empty_cache()
    return calls


def ln_units(got, ref, x, w, b, dy) -> list[float]:
    """Each of y, dx, dw, db's largest |got − ref| in units of its bound: in
    bf16 one ulp of ref, plus LN_FLOORS of the magnitude of its terms, m =
    (1/σ)·(|x| + |mean|) in place of |x̂|."""
    xd, wd, bd, dyd = (t.double() for t in (x, w, b, dy))
    mean = xd.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xd - mean) ** 2).mean(-1, keepdim=True) + LN_EPS)
    m = rstd * (xd.abs() + mean.abs())
    g = (wd * dyd).abs()
    c = x.shape[-1]
    scales = (wd.abs() * m + bd.abs(),
              rstd * (g + (m * (g * m).sum(-1, keepdim=True) + g.sum(-1, keepdim=True)) / c),
              (dyd.abs() * m).reshape(-1, c).sum(0), dyd.abs().reshape(-1, c).sum(0))
    units = []
    for i, (a, r, sc) in enumerate(zip(got, ref, scales)):
        rd = r.double()
        ulp = torch.where(rd != 0, torch.exp2(torch.floor(torch.log2(rd.abs().clamp_min(1e-38)))
                                              - 7), 0.0) if x.dtype == torch.bfloat16 else 0.0
        floor = LN_FLOORS[x.dtype][i >= 2]
        units.append(((a.double() - rd).abs() / (ulp + floor * sc)).max().item())
    return units


def phase_layer_norm(unet_mod, ptxas) -> dict:
    """The LayerNorm pair at the bf16 train step's and sampler's shapes and at
    the f32 steps' of the examples and of 128 px: held against nn.LayerNorm
    (f32: float64), timed beside the composed form and the bound, summed per
    step; the composed backward's kernels and GroupNorm's, named in full;
    the launches of a forward and of an eager train step; the pair's
    registers and spills."""
    import dataclasses

    import torch.nn.functional as F

    from aliasfree_diffusion_models_pytorch_tpu_torch import train as train_mod
    from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops import layer_norm as ln

    config = TrainConfig(image_size=32, image_channels=3, variant=3, batch_size=256,
                         compute_dtype="bfloat16", filters=FilterSettings())
    gen = torch.Generator(device="cuda").manual_seed(22)
    rows, composed_kernels = [], {}
    max_units = {"bfloat16": [0.0] * 4, "float32": [0.0] * 4}
    f32 = dict(compute_dtype="float32")
    regimes = {"step": (config, True),
               "sampling": (dataclasses.replace(config, batch_size=200), False),
               "f32_examples_b64": (dataclasses.replace(config, batch_size=64, **f32), True),
               "f32_128px_w128_b4": (dataclasses.replace(config, image_size=128, base_width=128,
                                                         batch_size=4, **f32), True)}
    per = {}
    for regime, (cfg, backward) in regimes.items():
        dtype = getattr(torch, cfg.compute_dtype)
        calls = ln_calls(unet_mod, cfg)
        check(sum(calls.values()) == 12, f"{regime}: {sum(calls.values())} LayerNorm calls a "
                                         f"forward, expected 12")
        for (shape, stride), n_calls in calls.items():
            n, s, c = shape
            x = torch.empty_strided(shape, stride, device="cuda", dtype=dtype)
            x.copy_(torch.randn(shape, generator=gen, device="cuda") * 1.5 + 0.3)
            w = (1 + 0.5 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
            b = (0.5 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
            dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            layout = ln.token_layout(x)
            y, mean, rstd = ln.layer_norm_fwd(x, w, b, LN_EPS)
            dx, dw, db = ln.layer_norm_bwd(x, dy, w, mean, rstd)
            xg = x.detach().requires_grad_()
            wg, bg = w.clone().requires_grad_(), b.clone().requires_grad_()
            ref = F.layer_norm(xg, (c,), wg, bg, LN_EPS)  # the composed form, timed below
            if dtype == torch.bfloat16:
                want = (ref.detach(), *torch.autograd.grad(ref, (xg, wg, bg), dy,
                                                           retain_graph=True))
            else:
                xd, wd, bd = (t.detach().double().requires_grad_() for t in (x, w, b))
                rd = F.layer_norm(xd, (c,), wd, bd, LN_EPS)
                want = tuple(t.float() for t in (rd.detach(), *torch.autograd.grad(
                    rd, (xd, wd, bd), dy.double())))
                del xd, wd, bd, rd
            units = ln_units((y, dx, dw, db), want, x, w, b, dy)
            check(max(units) <= 1.0 and dx.stride() == x.stride(),
                  f"layer_norm {regime} {shape} {stride}: errors {units} units of the bound, dx "
                  f"strides {dx.stride()}")
            worst = max_units[cfg.compute_dtype]
            max_units[cfg.compute_dtype] = [max(a, u) for a, u in zip(worst, units)]
            row = dict(regime=regime, dtype=cfg.compute_dtype, shape=list(shape),
                       strides=list(stride), layout=layout, calls=n_calls, units=units,
                       fwd_ms=device_ms(lambda: ln.layer_norm_fwd(x, w, b, LN_EPS), iters=10,
                                        per_call={"ln_fwd_kernel": 1}),
                       composed_fwd_ms=device_ms(lambda: F.layer_norm(x, (c,), w, b, LN_EPS),
                                                 iters=10))
            row["fwd_bound_ms"], _ = bound([ln_times(x.numel(), False, dtype)])
            if backward:
                row["bwd_ms"] = device_ms(lambda: ln.layer_norm_bwd(x, dy, w, mean, rstd),
                                          iters=10, per_call={"ln_bwd_kernel": 1,
                                                              "ln_dparams_kernel": 1})
                row["composed_bwd_ms"] = device_ms(
                    lambda: torch.autograd.grad(ref, (xg, wg, bg), dy, retain_graph=True),
                    iters=10)
                row["bwd_bound_ms"], _ = bound([ln_times(x.numel(), True, dtype)])
                if dtype == torch.bfloat16 and layout not in composed_kernels:
                    events, _ = device_events(
                        lambda: torch.autograd.grad(ref, (xg, wg, bg), dy, retain_graph=True))
                    composed_kernels[layout] = sorted({name for name, _ in events})
            rows.append(row)
            log(f"  {regime:<8} {str(shape):<19} {layout:<8} x{n_calls}: device us fwd "
                f"{row['fwd_ms'] * 1e3:7.1f} (bound {row['fwd_bound_ms'] * 1e3:6.1f}, composed "
                f"{row['composed_fwd_ms'] * 1e3:7.1f})"
                + (f" bwd {row['bwd_ms'] * 1e3:7.1f} (bound {row['bwd_bound_ms'] * 1e3:6.1f}, "
                   f"composed {row['composed_bwd_ms'] * 1e3:7.1f})" if backward else "")
                + f"; units of the bound y/dx/dw/db {[round(u, 3) for u in units]}")
            del x, w, b, dy, y, mean, rstd, dx, dw, db, xg, wg, bg, ref, want
        keys = ("fwd_ms", "composed_fwd_ms") + (("bwd_ms", "composed_bwd_ms") if backward else ())
        mine = [r for r in rows if r["regime"] == regime]
        per[regime] = {k: sum(r["calls"] * r[k] for r in mine) for k in keys}
        times = [ln_times(math.prod(r["shape"]), bwd, dtype) for r in mine
                 for bwd in ((False, True) if backward else (False,)) for _ in range(r["calls"])]
        per[regime]["bound_ms"], per[regime]["bound_by"] = bound(times)
        per[regime]["elements"] = sum(r["calls"] * math.prod(r["shape"]) for r in mine)
    step, sampling = per["step"], per["sampling"]
    log(f"  per 32-px train step at batch 256 (12 calls each way, {step['elements']} elements): "
        f"kernel {step['fwd_ms'] + step['bwd_ms']:.4f} ms ({step['fwd_ms']:.4f} + "
        f"{step['bwd_ms']:.4f}), bound {step['bound_ms']:.4f} ({step['bound_by']}), composed "
        f"{step['composed_fwd_ms'] + step['composed_bwd_ms']:.4f} "
        f"({step['composed_fwd_ms']:.4f} + {step['composed_bwd_ms']:.4f})")
    log(f"  per sampling forward at n=200 (12 calls): kernel {sampling['fwd_ms']:.4f} ms, bound "
        f"{sampling['bound_ms']:.4f}, composed {sampling['composed_fwd_ms']:.4f}")
    f32_steps = {k: v for k, v in per.items() if k.startswith("f32_")}
    for regime, t in f32_steps.items():
        log(f"  per f32 step, {regime} (12 calls each way, {t['elements']} elements): kernel "
            f"{t['fwd_ms'] + t['bwd_ms']:.4f} ms ({t['fwd_ms']:.4f} + {t['bwd_ms']:.4f}), bound "
            f"{t['bound_ms']:.4f} ({t['bound_by']}), composed "
            f"{t['composed_fwd_ms'] + t['composed_bwd_ms']:.4f} ({t['composed_fwd_ms']:.4f} + "
            f"{t['composed_bwd_ms']:.4f})")
    for layout, names in composed_kernels.items():
        log(f"  composed backward's kernels ({layout}): {names}")
    gn = torch.nn.GroupNorm(1, 64).cuda().bfloat16()
    gx = torch.randn((256, 64, 32, 32), device="cuda").bfloat16().requires_grad_()
    gy = gn(gx)
    events, _ = device_events(lambda: torch.autograd.grad(gy, (gx, *gn.parameters()),
                                                          torch.ones_like(gy), retain_graph=True))
    composed_kernels["group_norm_backward"] = sorted({name for name, _ in events})
    log(f"  GroupNorm(1, 64) backward's kernels: {composed_kernels['group_norm_backward']}")
    del gn, gx, gy
    # launches: a forward, and one eager train step, of the bf16 32-px model at batch 4
    small = dataclasses.replace(config, batch_size=4, noise_steps=50)
    model, state = train_mod.create_train_state(small, device="cuda")
    counts = lambda: (ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches)  # noqa: E731
    before = counts()
    with torch.no_grad():
        model(torch.zeros((4, 32, 32, 3), device="cuda"),
              torch.ones((4,), dtype=torch.long, device="cuda"))
    fwd_launches = tuple(a - b for a, b in zip(counts(), before))
    step_fn = train_mod.make_train_step(model, small, Diffusion(noise_steps=50, img_size=32,
                                                                device="cuda"), graphs=False)
    before = counts()
    state, loss = step_fn(state, torch.rand((4, 32, 32, 3), device="cuda") * 2 - 1,
                          train_mod.step_generator(torch.Generator(device="cuda"), 0, 0))
    torch.cuda.synchronize()
    step_launches = tuple(a - b for a, b in zip(counts(), before))
    check(fwd_launches == (12, 0) and step_launches == (12, 12) and math.isfinite(loss.item()),
          f"LayerNorm launches: a forward {fwd_launches}, a train step {step_launches}")
    log(f"  launches: a forward {fwd_launches}, an eager train step {step_launches}")
    del model, state, step_fn
    torch.cuda.empty_cache()
    regs = [e for e in ptxas if e["library"] == "layer_norm"]
    check(len(regs) == 12 and not any(e["spill_stores"] + e["spill_loads"] for e in regs),
          f"layer_norm: instantiations missing or spilling: {regs}")
    log("  layer_norm registers: " + ", ".join(f"{e['kernel']} {e['registers']}" for e in regs))
    return dict(rows=rows, per_step=step, sampling=sampling, f32_steps=f32_steps,
                max_units=max_units,
                composed_kernels=composed_kernels, ptxas=regs,
                launches={"forward": fwd_launches, "train_step": step_launches})


# Phase 6c: the step on a one-rank NCCL mesh (torch.distributed with this
# process as rank 0 of 1), graphed: the 32-px Config-D bf16 step at batch 256
# on a data mesh and on an fsdp mesh of size 1, in turns with the
# non-distributed step (single, data, fsdp, single again) over six steps
# each; the f32 step (batch 64, deterministic algorithms) bit-equal to the
# non-distributed one over six steps; the CLI train and run under the process
# group; the CLI sample with the JAX CLI's training flags.
DIST_STEPS = 6
# The bf16 mesh step's mean |parameter difference| from the single step: at
# most ten times that of two single runs, or 1e-4 of the parameters' movement
# where those happen to agree more closely.
DIST_SPREAD_TIMES, DIST_FLOOR_SHARE = 10.0, 1e-4


def phase_distributed(fa, rs, cli, config) -> dict:
    import dataclasses
    import shutil
    import socket

    import torch.distributed as dist

    from aliasfree_diffusion_models_pytorch_tpu_torch import train as train_mod
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
    from aliasfree_diffusion_models_pytorch_tpu_torch.parallel import make_mesh
    from aliasfree_diffusion_models_pytorch_tpu_torch.parallel.multihost import init_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    check(init_distributed(f"tcp://localhost:{port}", 1, 0), "init_distributed")
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "NCCL world of one")
    meshes = {"single": None, "data": make_mesh(), "fsdp": make_mesh((1, 1), ("data", "fsdp"))}
    out: dict = {"backend": dist.get_backend(), "world_size": dist.get_world_size()}
    try:
        def run_steps(cfg, mesh, batch, start=None):
            model, state = train_mod.create_train_state(cfg, device="cuda", mesh=mesh)
            if start is not None:
                start.update({k: v.clone() for k, v in state.params.items()})
            step_fn = train_mod.make_train_step(
                model, cfg, Diffusion(noise_steps=1000, img_size=32, device="cuda"), mesh=mesh)
            gen = torch.Generator(device="cuda")
            losses = []
            for i in range(DIST_STEPS):
                if i == 3:  # warm-up and capture done: the replays are timed
                    losses[-1].item()
                    t0 = time.perf_counter()
                state, loss = step_fn(state, batch, train_mod.step_generator(gen, 0, i))
                losses.append(loss)
            final = losses[-1].item()
            step_ms = (time.perf_counter() - t0) / (DIST_STEPS - 3) * 1e3
            captured = [s.captured for s in step_fn.signatures.values()]
            params = {k: v.clone() for k, v in state.params.items()}
            del model, state, step_fn
            _free_device_memory()
            return torch.stack(losses), params, step_ms, captured, final

        # bf16 at batch 256, in turns
        cfg = dataclasses.replace(config, batch_size=256, run_name="dist")
        batch = torch.from_numpy(np.random.default_rng(7).uniform(
            -1, 1, (256, 32, 32, 3)).astype(np.float32)).cuda()
        bf16, start = {}, {}
        for name in ("single", "data", "fsdp", "single_again"):
            mesh = meshes[name.replace("_again", "")]
            fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
            losses, params, step_ms, captured, final = run_steps(
                cfg, mesh, batch, start if name == "single" else None)
            check(math.isfinite(final), f"{name} step: loss {final}")
            check(all(captured) and len(captured) == 1,
                  f"{name} step: captured variants {captured}")
            check((fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
                  == (6 * DIST_STEPS, 6 * DIST_STEPS),
                  f"{name} step: attention launches {fa.flash_attention_fwd.launches}")
            bf16[name] = dict(step_ms=step_ms, losses=losses, params=params, captured=captured)
        spread, _ = param_difference(bf16["single"]["params"], bf16["single_again"]["params"])
        movement, _ = param_difference(bf16["single"]["params"], start)
        rows = {}
        for name in ("data", "fsdp"):
            diff, diff_max = param_difference(bf16[name]["params"], bf16["single"]["params"])
            first_equal = bool(torch.equal(bf16[name]["losses"][0], bf16["single"]["losses"][0]))
            check(first_equal, f"bf16 {name} step: first loss differs from the single step's")
            # dQ's atomics make the bf16 step differ run to run: the mesh step is
            # held to that spread of the single step's own two runs.
            limit = max(DIST_SPREAD_TIMES * spread, DIST_FLOOR_SHARE * movement)
            check(spread <= BF16_STEP_SHARE * movement and diff <= limit,
                  f"bf16 {name} step: {diff} from the single step (limit {limit}), single "
                  f"runs {spread} apart, movement {movement}")
            rows[name] = dict(step_ms=bf16[name]["step_ms"], vs_single_mean=diff,
                              vs_single_max=diff_max, vs_single_limit=limit,
                              first_loss_equal=first_equal,
                              graphs_held_collective=all(bf16[name]["captured"]))
        out["bf16_b256"] = dict(single_ms=bf16["single"]["step_ms"],
                                single_again_ms=bf16["single_again"]["step_ms"],
                                single_spread_mean=spread, movement_mean=movement, **rows)
        log(f"  bf16 32-px Config-D step at batch 256, graphed, {DIST_STEPS} steps (the last "
            f"{DIST_STEPS - 3} timed): single {bf16['single']['step_ms']:.2f} ms, data mesh "
            f"{rows['data']['step_ms']:.2f} ms, fsdp mesh {rows['fsdp']['step_ms']:.2f} ms, "
            f"single again {bf16['single_again']['step_ms']:.2f} ms; the graphs held the "
            f"collective: data {rows['data']['graphs_held_collective']}, fsdp "
            f"{rows['fsdp']['graphs_held_collective']}; first loss bit-equal; parameters, mean "
            f"|difference| from the single step: data {rows['data']['vs_single_mean']:.2e}, "
            f"fsdp {rows['fsdp']['vs_single_mean']:.2e}; two single runs {spread:.2e} (dQ's "
            f"atomics); movement {movement:.2e}")
        del batch, bf16
        _free_device_memory()

        # f32, deterministic: bit-equal over six steps
        batch_n = GRAPH_F32_STEP[0]
        cfg32 = dataclasses.replace(config, compute_dtype="float32", batch_size=batch_n,
                                    run_name="dist32")
        batch = torch.from_numpy(np.random.default_rng(8).uniform(
            -1, 1, (batch_n, 32, 32, 3)).astype(np.float32)).cuda()
        f32 = {}
        _deterministic_algorithms(True)
        try:
            for name in ("single", "data", "fsdp"):
                losses, params, step_ms, captured, _ = run_steps(cfg32, meshes[name], batch)
                f32[name] = (losses, params, captured)
        finally:
            _deterministic_algorithms(False)
        for name in ("data", "fsdp"):
            check(torch.equal(f32[name][0], f32["single"][0]), f"f32 {name}: losses differ")
            differing = [k for k, v in f32[name][1].items()
                         if not torch.equal(v, f32["single"][1][k])]
            check(not differing, f"f32 {name}: parameters differ in {differing[:4]}")
            check(all(f32[name][2]), f"f32 {name}: not captured")
        out["f32_b64_bit_equal"] = True
        log(f"  f32 32-px Config-D step at batch {batch_n}, deterministic algorithms, graphed: "
            f"the data and fsdp meshes bit-equal to the single step over {DIST_STEPS} steps "
            f"(losses and every parameter)")
        del batch, f32
        _free_device_memory()

        # the CLI under the process group
        root = os.path.join(OUT_DIR, "dist_root")
        shutil.rmtree(root, ignore_errors=True)
        args = cli.build_parser().parse_args(["train", *TRAIN_FLAGS, "--epochs", "1",
                                              "--root", root])
        t0 = time.perf_counter()
        losses = cli.run_train(args)
        wall = time.perf_counter() - t0
        run_cfg = cli.config_from_args(args)
        with open(os.path.join(run_cfg.runs_dir(root), "metrics.jsonl")) as f:
            header = json.loads(f.readline())
        impl = header.get("impl", {})
        check(impl.get("distributed", {}).get("backend") == "nccl"
              and impl["distributed"]["world_size"] == 1 and impl.get("cuda_graphs") is True,
              f"train header impl: {impl}")
        check(os.path.exists(run_cfg.checkpoint_path(root) + ".npz"), "train: no checkpoint")
        check(len(losses) == 1 and math.isfinite(losses[0]), f"train losses {losses}")
        run_root = os.path.join(OUT_DIR, "dist_run_root")
        shutil.rmtree(run_root, ignore_errors=True)
        cli.run_ddpm(cli.build_parser().parse_args(
            ["run", *STUDY_MODEL_FLAGS, "--batch-size", "256", "--image-gen-per-epoch", "0",
             "--epochs", "1", "--noise-steps", "20", "--gen-total", "4", "--gen-per-batch", "4",
             "--root", run_root]))
        run_cfg2 = cli.config_from_args(cli.build_parser().parse_args(
            ["run", *STUDY_MODEL_FLAGS]))
        settings = os.path.join(run_cfg2.runs_dir(run_root),
                                f"settings_{run_cfg2.dataset}_{run_cfg2.variant}.txt")
        with open(settings) as f:
            impl_lines = [line for line in f.read().splitlines() if line.startswith("impl.")]
        check(any(line.startswith("impl.distributed: ") and "'nccl'" in line
                  for line in impl_lines), f"settings impl lines: {impl_lines}")
        out["cli_train"] = dict(wall_s=wall, losses=losses, impl=impl,
                                settings_impl_lines=len(impl_lines))
        log(f"  CLI train, 1 epoch at batch 256 under the process group: {wall:.2f} s, loss "
            f"{losses[0]:.4f}; metrics.jsonl header impl.distributed {impl['distributed']}, "
            f"impl.cuda_graphs {impl['cuda_graphs']}; rank 0 wrote the checkpoint; run's "
            f"settings file: {len(impl_lines)} impl.* lines")
    finally:
        dist.destroy_process_group()

    # the CLI sample with a JAX command line's training flags
    path = os.path.join(OUT_DIR, "sample_batch_size.png")
    t0 = time.perf_counter()
    rc = cli.main(["sample", "--batch-size", "16", "--epochs", "3", "--lr", "1e-3",
                   "--variant", "3", "--image-size", "32", "--image-channels", "3",
                   "--compute-dtype", "bfloat16", "--f-kernel", "3", "--f-beta", "2",
                   "--random-weights", "--ddim-steps", "10", "--n", "4", "--device", "cuda",
                   "--out", path])
    check(rc == 0 and os.path.exists(path), "sample --batch-size 16")
    out["cli_sample_batch_size"] = dict(wall_s=time.perf_counter() - t0)
    log(f"  CLI sample --batch-size 16 --epochs 3 --lr 1e-3 (the JAX CLI's flags): wrote "
        f"{path} in {out['cli_sample_batch_size']['wall_s']:.2f} s")
    return out


# Phase 9: the examples at the JAX scripts' full configuration (Config D,
# 32 px, f32, 5 epochs of 512 synthetic images at batch 64 = 40 steps, 1000
# noise steps). Attention launches: 6 a forward and 6 a backward a step, 6 a
# sampler step (999 for DDPM-1000, 50 for DDIM-50; CFG doubles the batch, not
# the forwards). The LayerNorm pair launches twice as often (ln and ff_ln).
# The filtered GELU takes the conv form in f32 (as the JAX package's f32 path
# does): the pair launches nothing here.
EXAMPLES = {
    "quickstart": dict(fwd=6 * 40 + 6 * 999 + 6 * 50 + 6 * 999, bwd=6 * 40),
    "conditional_cfg": dict(fwd=6 * 40 + 6 * 50, bwd=6 * 40),
}
EXAMPLE_METRICS = ("feature_space", "inception_score_mean", "inception_score_std",
                   "frechet_inception_distance", "kernel_inception_distance_mean",
                   "kernel_inception_distance_std")


def load_example(name: str):
    """``examples/<name>.py`` of this checkout, imported by its path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_examples(fa, rs) -> list[dict]:
    """Each port example's ``main`` in this process, with a scratch working
    directory, every launch counter set to 0 just before and read just after:
    in f32, two LayerNorm launches for each attention launch."""
    import shutil

    from aliasfree_diffusion_models_pytorch_tpu_torch.ops import layer_norm as ln

    work = os.path.abspath(os.path.join(OUT_DIR, "examples"))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    argvs = {"quickstart": ["--root", work],
             "conditional_cfg": ["--root", os.path.join(work, "cond_example")]}
    rows = []
    for name, expect in EXAMPLES.items():
        module = load_example(f"{name}_torch")
        stage_s: dict[str, float] = {}

        def timed(fn, stage: str):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    torch.cuda.synchronize()
                    stage_s[stage] = stage_s.get(stage, 0.0) + time.perf_counter() - t0
            return run

        # the wall of each stage: the example calls these by their module names
        for stage in ("train", "sample_stage", "calculate_metrics"):
            if hasattr(module, stage):
                setattr(module, stage, timed(getattr(module, stage), stage))
        _free_device_memory()
        cwd = os.getcwd()
        os.chdir(work)
        torch.cuda.synchronize()
        fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
        rs.filtered_gelu_fwd.launches = rs.filtered_gelu_bwd.launches = 0
        ln.layer_norm_fwd.launches = ln.layer_norm_bwd.launches = 0
        t0 = time.perf_counter()
        try:
            result = module.main(argvs[name])
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
        fg_counts = (rs.filtered_gelu_fwd.launches, rs.filtered_gelu_bwd.launches)
        check(counts == (expect["fwd"], expect["bwd"]),
              f"{name}: attention launches (fwd, bwd) {counts}, expected "
              f"{(expect['fwd'], expect['bwd'])}")
        check(fg_counts == (0, 0), f"{name}: filtered_gelu launches {fg_counts} in f32")
        ln_counts = (ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches)
        check(ln_counts == (2 * expect["fwd"], 2 * expect["bwd"]),
              f"{name}: layer_norm launches {ln_counts} in f32, expected "
              f"{(2 * expect['fwd'], 2 * expect['bwd'])}")
        losses = result["losses"]
        check(len(losses) == 5 and all(math.isfinite(x) for x in losses),
              f"{name}: epoch losses {losses}")
        check(os.path.exists(result["checkpoint"]), f"{name}: no checkpoint {result['checkpoint']}")
        grid = os.path.join(work, result["grid"])
        check(os.path.exists(grid), f"{name}: no grid at {grid}")
        row = dict(run=f"example_{name}", wall_s=wall, stage_s=stage_s, fwd_launches=counts[0],
                   bwd_launches=counts[1], fg_fwd_launches=fg_counts[0],
                   fg_bwd_launches=fg_counts[1], ln_fwd_launches=ln_counts[0],
                   ln_bwd_launches=ln_counts[1], epoch_losses=losses)
        if name == "quickstart":
            shapes = {k: (v.shape, str(v.dtype)) for k, v in result["samples"].items()}
            check(shapes == {"final": ((8, 32, 32, 1), "uint8"), "fast": ((8, 32, 32, 1), "uint8"),
                             "rotated": ((4, 32, 32, 1), "uint8")}, f"quickstart samples {shapes}")
            check(all(v.std() > 0 for v in result["samples"].values()), "quickstart: constant samples")
            metrics = result["metrics"]
            check(tuple(metrics) == EXAMPLE_METRICS, f"quickstart metric keys {list(metrics)}")
            check(all(math.isfinite(v) for k, v in metrics.items() if k != "feature_space"),
                  f"quickstart metrics {metrics}")
            row["metrics"] = metrics
        else:
            imgs = result["images"]
            check(imgs.shape == (40, 32, 32, 1) and imgs.dtype == np.uint8 and imgs.std() > 0,
                  f"conditional_cfg images {imgs.shape} {imgs.dtype}")
        stages = ", ".join(f"{k} {v:.2f} s" for k, v in stage_s.items())
        log(f"  {name}: {wall:.2f} s wall ({stages}), epoch mean losses "
            f"{[round(x, 4) for x in losses]}, launches attention {counts[0]} + {counts[1]}, "
            f"filtered_gelu {fg_counts[0]} + {fg_counts[1]}, layer_norm {ln_counts[0]} + "
            f"{ln_counts[1]}"
            + (f", metrics {row['metrics']}" if "metrics" in row else ""))
        rows.append(row)
    return rows


# Phase 9b: the CLI under torchrun, one rank on the card (an NCCL world of
# one): it must end the process group it started, so PyTorch does not warn.
TEARDOWN_TIMEOUT_S = 300
TEARDOWN_WARNING = "destroy_process_group"


def phase_teardown(cli) -> list[dict]:
    """``torchrun --nproc-per-node 1 -m <port> train`` and ``run`` at a cut
    size as child processes, each in a session of its own that a time limit
    kills whole: exit 0, no teardown warning, the run's files written."""
    import shutil
    import signal
    import socket

    _free_device_memory()
    repo = os.path.dirname(os.path.abspath(__file__))
    rows = []
    cuts = {
        "train": ["train", *TRAIN_FLAGS, "--epochs", "1"],
        "run": ["run", *STUDY_MODEL_FLAGS, "--batch-size", "256", "--image-gen-per-epoch", "0",
                "--epochs", "1", "--noise-steps", "20", "--gen-total", "4", "--gen-per-batch",
                "4"],
    }
    for name, argv in cuts.items():
        root = os.path.abspath(os.path.join(OUT_DIR, f"torchrun_{name}"))
        shutil.rmtree(root, ignore_errors=True)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
               "--nproc-per-node", "1", "--master-port", str(port), "-m",
               "aliasfree_diffusion_models_pytorch_tpu_torch", *argv, "--root", root]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, start_new_session=True)
        try:
            out, err = proc.communicate(timeout=TEARDOWN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise AssertionError(f"torchrun {name}: no exit within {TEARDOWN_TIMEOUT_S} s")
        wall = time.perf_counter() - t0
        for line in err.splitlines()[-8:]:
            log(f"    {line[:300]}")
        check(proc.returncode == 0, f"torchrun {name} exited {proc.returncode}")
        warned = TEARDOWN_WARNING in out + err
        check(not warned, f"torchrun {name}: the teardown warning is on its output")
        config = cli.config_from_args(cli.build_parser().parse_args(argv))
        check(os.path.exists(config.checkpoint_path(root) + ".npz"),
              f"torchrun {name}: no checkpoint")
        if name == "train":
            final = json.loads(out.strip().splitlines()[-1])["final_loss"]
            check(math.isfinite(final), f"torchrun train: final loss {final}")
        else:
            gen = os.path.join(root, "images", "generated", f"{config.dataset}_{config.variant}")
            check(sorted(os.listdir(gen))[:4] == [f"image_{i}.png" for i in range(4)],
                  f"torchrun run: generated {sorted(os.listdir(gen))}")
        log(f"  torchrun --nproc-per-node 1 -m ... {name}: exit {proc.returncode} in {wall:.1f} s, "
            f"teardown warning: {warned}")
        rows.append(dict(run=f"torchrun_{name}", exit=proc.returncode, wall_s=wall,
                         teardown_warning=warned))
    return rows


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — needs a CUDA GPU")
    from aliasfree_diffusion_models_pytorch_tpu_torch import cli, probes
    from aliasfree_diffusion_models_pytorch_tpu_torch.models import blocks
    from aliasfree_diffusion_models_pytorch_tpu_torch.models import unet as unet_mod
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops import flash_attention as fa
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops import probes as kp
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops import resample as rs
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
    # Every attention kernel, bf16 and f32, and the filtered-GELU pair keep
    # every value in registers; the report holds every f32 instantiation.
    spilled = [e["kernel"] for e in ptxas if e["spill_stores"] + e["spill_loads"] and (
        e["library"] in ("filtered_gelu", "plain_gelu", "layer_norm", "qk_rowsum")
        or e["library"].startswith("flash_"))]
    check(not spilled, f"attention, GELU, LayerNorm or qk_rowsum kernels spill: {spilled}")
    # qk_rowsum runs on wgmma and TMA in every instantiation, with no mma.sync left
    qk_sass = sass_report(kernels.library_path("qk_rowsum"))
    for label, ops in qk_sass.items():
        log(f"    sass {label:<28} " + ", ".join(f"{op} {n}" for op, n in ops.items()))
    qk_labels = {f"qk_rowsum_kernel<{d}>" for d in kp.QK_HEAD_DIMS}
    check(set(qk_sass) == qk_labels, f"qk_rowsum functions in the SASS: {sorted(qk_sass)}")
    check(all(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0 and ops["HMMA"] == 0
              for ops in qk_sass.values()), f"qk_rowsum SASS: {qk_sass}")
    # Its consumers take the registers its producer gives back (setmaxnreg), which adds up
    # only at the count every thread starts with.
    qk_regs = {e["kernel"]: e["registers"] for e in ptxas if e["library"] == "qk_rowsum"}
    expect_regs = {f"qk_rowsum_kernel<{d}>": kp.QK_LAUNCH_REGS[t[3]]
                   for d, t in kp.QK_TILES.items()}
    check(qk_regs == expect_regs, f"qk_rowsum registers {qk_regs}, expected {expect_regs}")
    f32_found = {e["kernel"] for e in ptxas if "_f32_" in e["kernel"]}
    check(f32_found == F32_INSTANTIATIONS,
          f"f32 kernels in the ptxas report: {sorted(f32_found)}, expected "
          f"{sorted(F32_INSTANTIATIONS)}")

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
    log("[2e] filtered_gelu pair vs plain version and conv form at the train steps' and the sampler's shapes")
    fgres = phase_fg_kernel(rs, unet_mod, blocks, config)
    done("filtered_gelu kernels")
    log("[2f] filtered_gelu pair under each AFDM_GELU mode at the 32-px step's shapes; the "
        "graphed step under poly13")
    gelu_modes = phase_gelu_modes(rs, fgres, ptxas, config)
    done("gelu modes")
    log("[2g] plain GELU pair vs the composed form at Config A's step shapes")
    pgres = phase_plain_gelu(rs, unet_mod, blocks, ptxas)
    done("plain_gelu kernels")
    log("[2h] LayerNorm pair vs nn.LayerNorm at the attention blocks' step and sampling shapes")
    lnres = phase_layer_norm(unet_mod, ptxas)
    done("layer_norm kernels")
    log("[3] full-width Config-D UNet forward and sampler, card vs cpu")
    fg = phase_unet(fa, rs, weights, unet_mod, config)
    done("unet card vs cpu")
    log("[3b] full-width f32 train step, card vs cpu")
    phase_train_step_vs_cpu(fa, weights, config)
    done("train step card vs cpu")

    log("[4] main path: CLI sample")
    runs = phase_cli(fa, rs, cli, fg)
    done("cli sample")
    log("[5] main path: CLI train, sample from its checkpoint, optimizer knobs")
    train_runs = phase_cli_train(fa, rs, cli, fg)
    done("cli train")
    log("[6] steady-state train step")
    step_rows = phase_step_time(fa, rs, config)
    done("step time")
    log("[6a] bench_torch.py as a child process: its line against phase 6")
    bench_res = phase_bench(step_rows)
    done("bench")
    log("[6b] CUDA graphs against eager: the samplers and the train steps")
    graph_res = phase_graphs(fa, rs, weights, unet_mod, config, fg)
    done("graphs against eager")
    log("[6c] the step on a one-rank NCCL mesh (data, fsdp) against the single step; the CLI "
        "under the process group; sample with the JAX CLI's training flags")
    dist_res = phase_distributed(fa, rs, cli, config)
    done("distributed step")
    log("[7] study path: CLI probe, run, rotate, shift, eval; Inception forward")
    study = phase_study(fa, kp, cli)
    done("study path")
    log("[8] reproduce-grid on an image tree; MNIST CSV; exact resume; --profile-dir; "
        "Config E at 128 px")
    grid = phase_grid(fa, cli)
    done("grid and the rest")
    log("[9] the examples in this process at the JAX scripts' full configuration")
    examples = phase_examples(fa, rs)
    done("examples")
    log("[9b] the CLI under torchrun on one card: train and run end their process group")
    teardown = phase_teardown(cli)
    done("torchrun teardown")
    log(f"  [whole script: {time.perf_counter() - t_start:.1f} s]")

    main_rows = [r for r in kres["rows"] if r["n"] == 16 and r["dtype"] == "bfloat16"]
    main_bound, main_bound_by = bound(
        [attention_times(r["bh"], r["s"], r["d"], torch.bfloat16) for r in main_rows])
    bwd_rows = [r for r in bres["rows"] if r["px"] == 32 and r["dtype"] == "bfloat16"]
    bwd_bound, bwd_bound_by = bound(
        [attention_bwd_times(r["bh"], r["s"], r["d"], torch.bfloat16) for r in bwd_rows])
    # the same calls in f32: the six forward calls at n=16, the six backward
    # calls of the 32-px step at batch 256
    main_rows_f32 = [r for r in kres["rows"] if r["n"] == 16 and r["dtype"] == "float32"]
    bwd_rows_f32 = [r for r in bres["rows"] if r["px"] == 32 and r["dtype"] == "float32"]
    check(len(main_rows) == len(main_rows_f32) == len(bwd_rows) == len(bwd_rows_f32) == 6,
          "six attention calls a forward and a backward, in bf16 and f32")

    def f32_sums(rows, times) -> dict:
        return {"ms_f32": sum(r["ms"] for r in rows),
                "plain_ms_f32": sum(r["plain_ms"] for r in rows),
                "bound_ms_f32": bound([times(r["bh"], r["s"], r["d"], torch.float32)
                                       for r in rows])[0],
                "library_ms_f32": sum(r["library_ms"] for r in rows)}

    fg_step = fgres["per_step"]["32px_w32_b256"]
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
        **f32_sums(main_rows_f32, attention_times),
        "max_abs_err_by_dtype": {str(k)[6:]: v for k, v in kres["max_err"].items()},
        # largest error of a check as a share of its tensor's largest entry,
        # and the limit it was held to
        "max_rel_err_by_dtype": {str(k)[6:]: v for k, v in kres["max_rel"].items()},
        "rel_tol_by_dtype": {str(k)[6:]: v for k, v in REL_TOL.items()},
        "kernels_per_launch": 1,
        "ptxas": [e for e in ptxas if e["library"] == "flash_fwd"],
        "shapes": kres["rows"],
        "main_path_runs": runs + [
            {"run": "grid_" + c["config"], "train_launches": c["train_launches"][0],
             "gen_launches": c["gen_launches"][0], "train_s": c["train_s"], "gen_s": c["gen_s"]}
            for c in grid["grid"]["configs"]] + [
            {"run": "sample_128px_config_e", "launches": grid["config_e_128"]["launches"],
             "wall_s": grid["config_e_128"]["wall_s"]}] + [
            {"run": r["run"], "launches": r["fwd_launches"], "wall_s": r["wall_s"]}
            for r in examples],
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
        **f32_sums(bwd_rows_f32, attention_bwd_times),
        "max_abs_err_by_dtype": {str(k)[6:]: v for k, v in bres["max_err"].items()},
        "max_rel_err_by_dtype": {str(k)[6:]: v for k, v in bres["max_rel"].items()},
        "rel_tol_by_dtype": {str(k)[6:]: v for k, v in REL_TOL.items()},
        # "launches" counts calls of the wrapper: a bf16 call runs three
        # __global__ kernels (pre-pass, tensor-core pass, dQ cast), an f32 call
        # two (the dQ pass with each query's m, 1/Σ and δ, then the dK/dV
        # pass), and a profiler shows that many flash_bwd
        # events per call. A call without stats also adds 1 to flash_fwd's
        # count (the stats-mode forward that recomputes m and Σ).
        "kernels_per_launch": {str(k)[6:]: v for k, v in BWD_KERNELS.items()},
        "ptxas": [e for e in ptxas if e["library"] == "flash_bwd"],
        "shapes": bres["rows"],
        "main_path_runs": train_runs + [
            {"run": "grid_" + c["config"], "train_launches": c["train_launches"][1],
             "train_s": c["train_s"]} for c in grid["grid"]["configs"]] + [
            {"run": r["run"], "launches": r["bwd_launches"], "wall_s": r["wall_s"]}
            for r in examples],
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
        "design": "persistent blocks over (group, 256 queries) items; wgmma.mma_async "
                  "m64nNk16 with A (the item's queries, a TMA tile of Qt turned into registers "
                  "by ldmatrix.trans) and B (128-key tiles of K, by TMA through an mbarrier "
                  "ring fed by a producer warpgroup that gives its registers to two consumer "
                  "warpgroups); f32 accumulators carried over every key tile, summed once",
        "flops": sum(r["flops"] for r in qres["rows"]),
        "sass": qk_sass,
        "registers": [e for e in ptxas if e["library"] == "qk_rowsum"],
        "shapes": qres["rows"],
        "packed_over_perhead": qres["packed_over_perhead"],
        "d128_over_d8": qres["d128_over_d8"],
        "verdict": qres["verdict"],
        "main_path_runs": {"probe_headpack": study["probe_headpack"],
                           "result": study["probe_headpack_result"]},
    }, {
        "name": "filtered_gelu",
        "route": "cuda",
        "source": "aliasfree_diffusion_models_pytorch_tpu_torch/csrc/filtered_gelu.cu",
        "replaces": "aliasfree_diffusion_models_pytorch_tpu/ops/resample.py:345",
        # forward and backward launches of the 10-step CLI train run
        "launches": train_runs[0]["fg_fwd_launches"] + train_runs[0]["fg_bwd_launches"],
        "max_abs_err": max(fgres["max_err"].values()),
        # times: every filtered-GELU call of one bf16 32-px Config-D train
        # step at batch 256, forward and backward; the yardstick is the conv
        # form (upsample2x, gelu_exact, downsample2x and autograd's backward):
        # no single PyTorch call computes the function
        "ms": fg_step["fwd_ms"] + fg_step["bwd_ms"],
        "plain_ms": fg_step["plain_fwd_ms"] + fg_step["plain_bwd_ms"],
        "bound_ms": fg_step["bound_ms"],
        "bound_by": fg_step["bound_by"],
        "library_ms": fg_step["conv_fwd_ms"] + fg_step["conv_bwd_ms"],
        "library_call": "conv form: upsample2x, gelu_exact, downsample2x, autograd backward",
        "max_abs_err_by_dtype": {str(k)[6:]: v for k, v in fgres["max_err"].items()},
        "max_rel_err_by_dtype": {str(k)[6:]: v for k, v in fgres["max_rel"].items()},
        "rel_tol_by_dtype": {str(k)[6:]: v for k, v in FG_REL_TOL.items()},
        "kernels_per_launch": 1,
        "launches_per_forward": fg,
        "ptxas": [e for e in ptxas if e["library"] == "filtered_gelu"],
        # the instantiations the kernels launched at the distinct shapes of
        # the four train steps and the sampling forward
        "instantiations": sorted({r["instantiation"] for r in fgres["rows"]}),
        "per_step": fgres["per_step"],
        "steps": fgres["steps"],
        "sampling": fgres["sampling"],
        "per_sampling_forward_ms": fgres["per_forward"],
        # phase 2f: the pair per step under each AFDM_GELU mode
        "gelu_modes": gelu_modes,
        "shapes": fgres["rows"],
        # the examples run in f32, which takes the conv form: 0 launches
        "main_path_runs": train_runs + runs + examples,
    }, {
        "name": "plain_gelu",
        "route": "cuda",
        "source": "aliasfree_diffusion_models_pytorch_tpu_torch/csrc/plain_gelu.cu",
        "replaces": "aliasfree_diffusion_models_pytorch_tpu/ops/resample.py:305 (XLA-fused)",
        # times: every gelu_exact call of one bf16 32-px Config-A train step
        # at batch 256, forward and backward; the yardstick is the composed
        # form (gelu_poly) with autograd's backward, which the port ran before
        "ms": pgres["per_step"]["fwd_ms"] + pgres["per_step"]["bwd_ms"],
        "plain_ms": pgres["per_step"]["composed_fwd_ms"] + pgres["per_step"]["composed_bwd_ms"],
        "bound_ms": pgres["per_step"]["bound_ms"],
        "bound_by": pgres["per_step"]["bound_by"],
        "library_ms": None,
        "max_abs_err": 0.0,  # bit-equal, forward and backward, at every shape
        "kernels_per_launch": 1,
        "ptxas": pgres["ptxas"],
        "fg_side32_registers": pgres["fg_side32_registers"],
        "shapes": pgres["rows"],
    }, {
        "name": "layer_norm",
        "route": "cuda",
        "source": "aliasfree_diffusion_models_pytorch_tpu_torch/csrc/layer_norm.cu",
        "replaces": "flax nn.LayerNorm of the JAX package's attention block (XLA-fused)",
        # times: the twelve calls of one bf16 32-px train step at batch 256,
        # forward and backward; the yardstick is the form the port ran before:
        # the tokens view copied into row order, nn.LayerNorm and its backward
        "ms": lnres["per_step"]["fwd_ms"] + lnres["per_step"]["bwd_ms"],
        "plain_ms": None,
        "bound_ms": lnres["per_step"]["bound_ms"],
        "bound_by": lnres["per_step"]["bound_by"],
        "library_ms": lnres["per_step"]["composed_fwd_ms"] + lnres["per_step"]["composed_bwd_ms"],
        "library_call": "x.contiguous() of the tokens view, F.layer_norm, autograd backward",
        "max_units_of_bound": lnres["max_units"],
        "kernels_per_launch": {"fwd": 1, "bwd": 2},
        "ptxas": lnres["ptxas"],
        "per_step": lnres["per_step"],
        "sampling_n200": lnres["sampling"],
        # phase 2h's f32 calls: the examples' step and the 128-px step at base width 128
        "f32_steps": lnres["f32_steps"],
        # the main path's counts: bench_torch.py's 30 graphed steps at batch 256
        # (phase 6a) and a graphed DDPM-1000 call at n=16 (phase 6b); then
        # phase 2h's eager forward and step at batch 4
        "launches": {
            "bench_30_graphed_steps": {k: bench_res["timed_launches"][k]
                                       for k in ("layer_norm_fwd", "layer_norm_bwd")},
            "graphed_ddpm1000_n16": dict(zip(
                ("layer_norm_fwd", "layer_norm_bwd"),
                next(r for r in graph_res["sampling"] if r["name"] == "ddpm1000"
                     )["launches"][2:])),
            "eager_b4": lnres["launches"]},
        "composed_kernels": lnres["composed_kernels"],
        "shapes": lnres["rows"],
    }], "bench": bench_res,
        "graphs": graph_res,
        "distributed": dist_res,
        "study_path": {k: v for k, v in study.items() if not k.startswith("probe_")},
        "grid_path": grid,
        "examples": examples,
        "torchrun_teardown": teardown,
        "profiler_shortfalls": PROFILER_SHORTFALLS}
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)  # the nvidia-smi line as it printed it
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
