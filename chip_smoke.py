#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

Run from the root of a checkout:  python3 chip_smoke.py

1. names the card (``nvidia-smi`` name and power limit, torch's device name);
2. builds every hand-written kernel from ``csrc/`` with nvcc (sm_90a), all
   sources at once, and prints the build seconds and ptxas' register report;
3. holds each kernel against its plain PyTorch version on the card at every
   shape of the main path (Config D, image 32, base width 32: the six
   attention blocks at n=16 and at the CFG-doubled n=32), in bf16 and f32,
   with and without softmax stats, and times kernel, plain version and the
   one-call PyTorch yardstick (``scaled_dot_product_attention``, never
   called by the port) with CUDA events, beside the reckoned bound;
4. runs the full-width Config-D UNet forward (n=16) in f32 on the card
   against the same weights on the CPU (TF32 off), and in bf16, counting 6
   kernel launches per forward; then DDIM-5 on the card against the CPU with
   the same injected noise;
5. drives the main path through the CLI's ``sample`` entry point: 1000-step
   DDPM at n=16 in bf16 (5994 launches), DDIM-50, DDIM-50 with θ=90
   (Config E) and a conditional DDIM-20 with CFG 3.0 — each with its launch
   counter set to 0 just before and read just after;
6. prints one JSON line of every ported kernel, the card line, and last
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
# cores 989 TFLOP/s; f32 outside the tensor cores 67 TFLOP/s. exp on the
# special-function units: 3.9 T/s (FlashAttention-3 paper, H100 SXM5).
HBM_BYTES_PER_S = 3.35e12
MATMUL_FLOPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
EXP_PER_S = 3.9e12

# (block, S, C) of the six attention blocks at image 32, base width 32.
ATTN_SHAPES = [("sa1", 256, 64), ("sa2", 64, 128), ("sa3", 16, 128),
               ("sa4", 64, 64), ("sa5", 256, 32), ("sa6", 1024, 32)]
HEADS = 4
# Kernel vs plain version, max |difference| allowed:
#  f32: both sum f32 products exactly, in another order → 1e-5;
#  bf16: the kernel rounds p to bf16 against the running max of its online
#  softmax, the plain version against the final max, so single weights can
#  round one bf16 ulp apart (2^-8 relative), and both round the output to
#  bf16 (one ulp at |out| < 2 is 2^-7) → 2e-2.
OUT_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
M_ATOL = 1e-5   # row max of identical f32 logits, summation order only
SUM_RTOL = 1e-4  # Σ rescaled once per 32-key tile: a few f32 roundings per tile


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call: the summed durations of the kernels (and copies)
    that ``iters`` calls ran, from torch.profiler's CUDA trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    check(us > 0, "torch.profiler recorded no device time")
    return us / iters / 1e3


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
                err = max((out.float() - ref.float()).abs().max().item(),
                          (out_s.float() - ref.float()).abs().max().item())
                m_err = (m - ref_m).abs().max().item()
                s_rel = ((ssum - ref_s).abs() / ref_s).max().item()
                tag = f"{block} n={n} S={s} D={d} {str(dtype)[6:]}"
                check(err <= OUT_ATOL[dtype], f"{tag}: out err {err} > {OUT_ATOL[dtype]}")
                check(m_err <= M_ATOL, f"{tag}: stats m err {m_err}")
                check(s_rel <= SUM_RTOL, f"{tag}: stats sum rel err {s_rel}")
                max_err[dtype] = max(max_err[dtype], err)
                row = dict(block=block, n=n, bh=n * HEADS, s=s, d=d, dtype=str(dtype)[6:],
                           max_abs_err=err)
                calls = {"": lambda: fa.flash_attention_fwd(q, k, v, scale),
                         "plain_": lambda: fa.attention_reference(q, k, v, scale),
                         "library_": lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)}
                for key, fn in calls.items():
                    row[f"{key}ms"] = device_ms(fn)
                    row[f"{key}call_ms"] = call_ms(fn)
                row["bound_ms"], row["bound_by"] = bound([attention_times(n * HEADS, s, d, dtype)])
                rows.append(row)
                log(f"  {tag:<28} err {err:.1e}  device us: kernel {row['ms'] * 1e3:7.1f}"
                    f" plain {row['plain_ms'] * 1e3:7.1f} sdpa {row['library_ms'] * 1e3:7.1f}"
                    f" bound {row['bound_ms'] * 1e3:6.2f} ({row['bound_by']}) | per call us:"
                    f" kernel {row['call_ms'] * 1e3:6.1f} plain {row['plain_call_ms'] * 1e3:6.1f}"
                    f" sdpa {row['library_call_ms'] * 1e3:6.1f}")
    return dict(rows=rows, max_err=max_err)


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


def profile_forward(model, x, t) -> dict:
    """Device time by kernel family for one forward (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    model(x, t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(x, t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total, attn, kernels = 0.0, 0.0, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = evt.time_range.elapsed_us()
            total += us
            kernels += 1
            if "flash_fwd" in evt.name:
                attn += us
    return {"wall_ms": round(wall * 1e3, 3), "device_busy_ms": round(total / 1e3, 3),
            "device_kernels": kernels, "flash_fwd_ms": round(attn / 1e3, 4)}


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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — needs a CUDA GPU")
    from aliasfree_diffusion_models_pytorch_tpu_torch import cli
    from aliasfree_diffusion_models_pytorch_tpu_torch.models import unet as unet_mod
    from aliasfree_diffusion_models_pytorch_tpu_torch.ops import flash_attention as fa
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
    for name in kernels.SOURCES:
        stale = kernels.library_path(name)
        if stale.exists():
            stale.unlink()  # prove the build from this checkout's sources
    for r in kernels.build():
        log(f"  {r.name}: {r.seconds:.1f} s -> {r.path}")
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")

    log("[2] kernel vs plain version at the main-path shapes")
    kres = phase_kernels(fa)

    config = cli.config_from_args(cli.build_parser().parse_args(
        ["sample", "--variant", "3", "--image-size", "32", "--image-channels", "3",
         "--compute-dtype", "bfloat16", "--f-kernel", "3", "--f-beta", "2"]))
    log("[3] full-width Config-D UNet forward and sampler, card vs cpu")
    phase_unet(fa, weights, unet_mod, config)

    log("[4] main path: CLI sample")
    runs = phase_cli(fa, cli)

    main_rows = [r for r in kres["rows"] if r["n"] == 16 and r["dtype"] == "bfloat16"]
    main_bound, main_bound_by = bound(
        [attention_times(r["bh"], r["s"], r["d"], torch.bfloat16) for r in main_rows])
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
        "shapes": kres["rows"],
        "main_path_runs": runs,
    }]}
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)  # the nvidia-smi line as it printed it
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
