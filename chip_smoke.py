#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

Run from the root of a checkout:  python3 chip_smoke.py

1. names the card (``nvidia-smi`` name and power limit, torch's device name);
2. builds every hand-written kernel from ``csrc/`` with nvcc (sm_90a), all
   sources at once (``flash_fwd``, ``flash_bwd``), and prints the build
   seconds and ptxas' register report;
3. holds each kernel against its plain PyTorch version on the card, in bf16
   and f32, with and without softmax stats, and times kernel, plain version
   and the one-call PyTorch yardstick (``scaled_dot_product_attention`` and
   its backward, never called by the port) beside the reckoned bound:
   the forward at every shape of the sampling path (Config D, image 32, base
   width 32: the six attention blocks at n=16 and at the CFG-doubled n=32);
   the backward at every shape of the training path (the same six blocks at
   batch 256, the six blocks of the 64-px step at batch 32, S up to 4096, and
   S=16384 of a 128-px step at batch 2), with the stats-mode forward that
   feeds it checked at the same shapes;
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
8. prints one JSON line of every ported kernel, the card line, and last
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

# The 64-px train step (image 64, base width 64, batch 32): (block, S, C).
ATTN_SHAPES_64 = [("sa1", 1024, 128), ("sa2", 256, 256), ("sa3", 64, 256),
                  ("sa4", 256, 128), ("sa5", 1024, 64), ("sa6", 4096, 64)]
# The longest sequence the JAX package trains (image 128, base width 128):
# checked against the plain version at batch 2; no train step runs it here.
ATTN_SHAPES_128 = [("sa6", 16384, 128)]
# The plain backward holds about six S×S f32 arrays per (batch, head): it is
# compared, and timed, at the largest batch that keeps one of them under this.
PLAIN_SS_BYTES = 5 * 2**30


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


def device_events(run) -> tuple[list[tuple[str, float]], float]:
    """Runs ``run()`` under torch.profiler: the (name, µs) of every kernel and
    copy on the card, and the host's seconds around the run. A trace now and
    then comes back with no device events at all; then the run is profiled
    again, and a third empty trace fails."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events, wall
        log("  (torch.profiler recorded no device events; profiling again)")
    raise AssertionError("torch.profiler recorded no device time in three traces")


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call: the summed durations of the kernels (and copies)
    that ``iters`` calls ran, from torch.profiler's CUDA trace."""
    fn()
    events, _ = device_events(lambda: [fn() for _ in range(iters)])
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
                    row[f"{key}ms"] = device_ms(fn)
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
                    row[f"{key}ms"] = device_ms(fn, iters=5)
                    row[f"{key}call_ms"] = call_ms(fn, iters=10, warmup=1)
                row["bound_ms"], row["bound_by"] = bound(
                    [attention_bwd_times(n * HEADS, s, d, dtype)])
                rows.append(row)
                log(f"  {tag:<34} err dq {errs[0]:.1e} dk {errs[1]:.1e} dv {errs[2]:.1e}"
                    f" (of max: {rels[0]:.1e} {rels[1]:.1e} {rels[2]:.1e}; fwd {fwd_rel:.1e})"
                    f"  device us: kernel {row['ms'] * 1e3:8.1f}"
                    f" plain(bh={row['plain_bh']}) {row['plain_ms'] * 1e3:8.1f}"
                    f" sdpa-bwd {row['library_ms'] * 1e3:8.1f}"
                    f" bound {row['bound_ms'] * 1e3:7.2f} ({row['bound_by']})")
                del sdpa_out, qg, kg, vg, q, k, v, g, out, m, ssum, small, stats
            torch.cuda.empty_cache()
    return dict(rows=rows, max_err=max_err, max_rel=max_rel)


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
    events, wall = device_events(lambda: model(x, t))
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


def profile_step(step, state, batch) -> dict:
    """Device time and kernel count of one train step (torch.profiler)."""
    events, wall = device_events(lambda: step(state, batch)[1].item())
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
    t_build = time.perf_counter()
    for name in kernels.SOURCES:
        stale = kernels.library_path(name)
        if stale.exists():
            stale.unlink()  # prove the build from this checkout's sources
    for r in kernels.build():
        log(f"  {r.name}: {r.seconds:.1f} s -> {r.path}")
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")

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
        # "launches" counts calls of the wrapper: each runs two __global__
        # kernels (dQ with δ, then dK/dV), so a profiler shows twice as many
        # flash_bwd events. A call without stats also adds 1 to flash_fwd's
        # count (the stats-mode forward that recomputes m and Σ).
        "kernels_per_launch": 2,
        "shapes": bres["rows"],
        "main_path_runs": train_runs,
        "train_step": step_rows,
    }]}
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)  # the nvidia-smi line as it printed it
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
