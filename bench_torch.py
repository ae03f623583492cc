#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: training throughput (imgs/sec/chip) on
the flagship config, the two samplers' wall time and the 64-px step.

The port's counterpart of ``bench.py``, with its settings and its JSON keys.
It times the graphed train step of UNet variant 3 (Config D) on
CIFAR-10-shaped data (32x32x3) in bfloat16 on the card, through the port's
own entry points (``train.create_train_state``, ``train.make_train_step``,
``Diffusion.sample``, ``Diffusion.sample_ddim``), then 1000-step DDPM and
50-step DDIM sampling at n=16 and the 64-px step at batch 32 (S = 4096
through the attention backward).

Run from the root of a checkout:

    python3 bench_torch.py                          # one card
    torchrun --nproc-per-node N bench_torch.py      # a (data, fsdp) mesh of N cards
    python3 bench_torch.py --device cpu             # the CPU branch

``--device`` defaults to ``cuda``; without a card the bench exits non-zero.
``--device cpu`` takes bench.py's CPU branch: batch 16, float32, 3 timed
steps, no samplers and no 64-px step. Under torch.distributed with more
than one rank (``torchrun``, or a caller that started it) the step runs on
bench.py's mesh, ``(n // 2, 2)`` over ``("data", "fsdp")`` for an even n of
at least 4, else ``(n, 1)``, at a global batch of n times the per-chip
batch; throughput is reported per chip, FLOPs only without a mesh, and rank
0 alone prints the line.

FLOPs per step. The model FLOPs of one forward and backward: the matmuls
and convolutions as ``torch.utils.flop_counter.FlopCounterMode`` counts them
(elementwise work, the optimizer and the EMA count nothing). The count does
not depend on the route the timed step takes: it is taken on one route, in
f32 on fake CPU tensors (no computation, no memory), with the plain
attention and the conv form of the filtered GELU whatever ``AFDM_FG_IMPL``
says, at batch 1, and scaled by the batch (every op is per sample). On that
route the attention cores are the only batched matmuls, and they count
what PyTorch's SDPA formula counts (``sdpa_flop_count`` and
``sdpa_backward_flop_count``: two products forward, five backward, the
scores recomputed among them). MFU is that count over the step time over the
card's dense bf16 tensor-core peak (:data:`PEAK_BF16_TFLOPS`), null for a
card not in the table.

Timing. Every timed region ends with a host fetch (``loss.item()``, or the
sum of the sampled uint8 images), and every timed step draws from a fresh
generator (``train.step_generator``). The warm-up (3 steps and a fetch)
builds the kernels a first launch needs and captures the CUDA graphs.

Output: ONE JSON line on stdout with bench.py's keys; progress on stderr,
with one line that gives the kernels' launches during the timed steps and
the implementation choices in effect (``impl_flags.impl_report_text``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np
import torch

A100_TORCH_IMGS_PER_SEC_EST = 1000.0  # bench.py's documented estimate (its docstring)

IMAGE_SIZE, CHANNELS = 32, 3
BATCH = {"cuda": 256, "cpu": 16}  # per chip
TIMED_STEPS = {"cuda": 30, "cpu": 3}
WARM_STEPS = 3
SAMPLER_N, SAMPLER_ITERS, DDIM_STEPS = 16, 3, 50
# the 64-px regime: image size, batch, timed steps
TRAIN64 = (64, 32, 10)

# Peak dense bf16 tensor-core TFLOP/s by a substring of
# torch.cuda.get_device_name() (NVIDIA data sheets, without sparsity).
PEAK_BF16_TFLOPS = [
    ("H100 80GB HBM3", 989.0),  # H100 SXM5
]


def _note(msg: str) -> None:
    """Progress marker on stderr (stdout carries only the final JSON line)."""
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def peak_flops_per_sec(device_name: str) -> float | None:
    for tag, tflops in PEAK_BF16_TFLOPS:
        if tag in device_name:
            return tflops * 1e12
    return None


def bench_config(device: str, n_ranks: int = 1):
    """bench.py's ``TrainConfig``: Config D at 32 px on CIFAR-10-shaped data,
    bfloat16 on the card and float32 on the CPU, at the per-chip batch times
    the ranks of the mesh."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.config import FilterSettings, TrainConfig

    return TrainConfig(
        run_name="bench",
        epochs=1,
        batch_size=BATCH[device] * n_ranks,
        image_size=IMAGE_SIZE,
        image_channels=CHANNELS,
        dataset="CIFAR10",
        dataset_path=None,
        lr=3e-4,
        noise_steps=1000,
        variant=3,
        filters=FilterSettings(),
        compute_dtype="bfloat16" if device == "cuda" else "float32",
    )


def bench_mesh_shape(n: int) -> tuple[int, int]:
    """bench.py's mesh over n ranks, axes ``("data", "fsdp")``."""
    return (n // 2, 2) if n % 2 == 0 and n >= 4 else (n, 1)


@contextlib.contextmanager
def _conv_form():
    """The filtered GELU's conv form, whatever ``AFDM_FG_IMPL`` says."""
    before = os.environ.get("AFDM_FG_IMPL")
    os.environ["AFDM_FG_IMPL"] = "conv"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("AFDM_FG_IMPL", None)
        else:
            os.environ["AFDM_FG_IMPL"] = before


def step_flops(config, batch: int = 1) -> dict:
    """Model FLOPs of one forward and backward of ``config``'s UNet at
    ``batch`` (see the module docstring): ``{"total": n, "by_op": {aten op:
    n}}``. Runs on fake tensors: nothing is computed or allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import build_model

    model = build_model(dataclasses.replace(config, compute_dtype="float32"), device="cpu")
    fake = FakeTensorMode()
    params = {n: fake.from_tensor(p).requires_grad_() for n, p in model.named_parameters()}
    buffers = {n: fake.from_tensor(b) for n, b in model.named_buffers()}
    counter = FlopCounterMode(display=False)
    size, channels = config.image_size, config.image_channels
    with _conv_form(), fake, counter:
        x = torch.zeros((batch, size, size, channels))
        t = torch.ones((batch,), dtype=torch.long)
        eps = torch.func.functional_call(model, {**params, **buffers}, (x, t))
        torch.autograd.grad(eps.square().mean(), list(params.values()), allow_unused=True)
    by_op = {str(op): int(n) for op, n in counter.get_flop_counts()["Global"].items()}
    return {"total": int(counter.get_total_flops()), "by_op": by_op}


def bench_images(rng: np.random.Generator, batch: int, size: int) -> np.ndarray:
    """bench.py's images: standard normal NHWC f32 from the bench's rng."""
    return rng.standard_normal((batch, size, size, CHANNELS)).astype(np.float32)


def build_step(config, device: torch.device, mesh=None, state_dict=None):
    """The port's train step for ``config`` on ``device`` (on ``mesh``):
    ``(model, state, step)``. Weights from ``state_dict``, else
    ``init_params(config, config.seed)``."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
    from aliasfree_diffusion_models_pytorch_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    model, state = create_train_state(config, device=device, state_dict=state_dict, mesh=mesh)
    diffusion = Diffusion(noise_steps=config.noise_steps, img_size=config.image_size,
                          device=device)
    return model, state, make_train_step(model, config, diffusion, mesh=mesh)


def run_steps(step, state, batch, generator, seed: int, first: int, n: int):
    """``n`` steps on ``batch``, step i drawing from
    ``step_generator(generator, seed, first + i)``; the seconds they took
    up to and including the host fetch of the last loss, and that loss."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.train import step_generator

    t0 = time.perf_counter()
    for i in range(n):
        state, loss = step(state, batch, step_generator(generator, seed, first + i))
    final_loss = loss.item()  # forced device→host fetch INSIDE the timed region
    return time.perf_counter() - t0, final_loss


def sampler_wall(fn, device: torch.device, iters: int = SAMPLER_ITERS) -> float:
    """Seconds per call of ``fn(generator) -> uint8 images``: one warm call
    (it captures the sampler's graphs), then ``iters`` calls, each from a
    fresh generator and ended by a host fetch of the images' sum."""
    generator = torch.Generator(device=device)
    int(fn(generator.manual_seed(0)).sum())
    t0 = time.perf_counter()
    for i in range(iters):
        int(fn(generator.manual_seed(1 + i)).sum())  # forced fetch every call
    return round((time.perf_counter() - t0) / iters, 3)


def main(argv=None) -> int:
    import torch.distributed as dist

    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
    from aliasfree_diffusion_models_pytorch_tpu_torch.impl_flags import impl_report_text
    from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import build_model
    from aliasfree_diffusion_models_pytorch_tpu_torch.parallel import make_mesh, world
    from aliasfree_diffusion_models_pytorch_tpu_torch.parallel.multihost import (
        init_distributed,
        put_global_batch,
    )
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils.weights import init_params

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (default): the card, bf16; cpu: bench.py's CPU branch")
    args = parser.parse_args(argv)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("bench_torch: torch.cuda.is_available() is false: the bench needs a "
                         "CUDA card (--device cpu runs the CPU branch)")

    phases: dict[str, float] = {}
    t_phase = time.perf_counter()

    def phase(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        phases[name] = round(now - t_phase, 1)
        t_phase = now

    # torchrun's environment, unless the caller started torch.distributed
    started = not dist.is_initialized() and init_distributed(
        backend=None if on_card else "gloo")
    rank, n_ranks = world()
    if on_card:
        device = torch.device("cuda", torch.cuda.current_device())
        device_kind = torch.cuda.get_device_name(device)
    else:
        device, device_kind = torch.device("cpu"), "cpu"
    phase("backend_init_s")

    mesh = make_mesh(bench_mesh_shape(n_ranks), ("data", "fsdp")) if n_ranks > 1 else None
    config = bench_config(args.device, n_ranks if mesh is not None else 1)
    batch = config.batch_size
    _note(f"backend={args.device} device={device_kind} ranks={n_ranks} batch={batch}")
    model, state, step = build_step(config, device, mesh)
    _note("train state created")
    phase("state_init_s")

    rng = np.random.default_rng(0)
    images = put_global_batch(mesh, bench_images(rng, batch, IMAGE_SIZE), device=device)
    images = images.to(device)  # this rank's rows, on the card once

    # Model FLOPs (single device only, as bench.py's cost analysis).
    flops_per_step = None
    if mesh is None:
        flops_per_step = step_flops(config)["total"] * batch
        _note(f"flop count done: flops_per_step={flops_per_step}")
    phase("cost_analysis_s")

    generator = torch.Generator(device=device)
    run_steps(step, state, images, generator, config.seed, 0, WARM_STEPS)  # build, capture
    _note("train step built + warm")
    phase("train_compile_warm_s")

    n_steps = TIMED_STEPS[args.device]
    for wrapper in kernels.COUNTED:
        wrapper.launches = 0
    dt, final_loss = run_steps(step, state, images, generator, config.seed, 100, n_steps)
    launches = {wrapper.__name__: wrapper.launches for wrapper in kernels.COUNTED}
    imgs_per_sec = batch * n_steps / dt
    step_s = dt / n_steps
    phase("train_measure_s")
    impl = impl_report_text(mesh, graphs=on_card).replace("\n", " | ")
    _note(f"timed steps: launches {json.dumps(launches)} | {impl}")

    mfu = None
    peak = peak_flops_per_sec(device_kind) if on_card else None
    if flops_per_step and peak:
        mfu = flops_per_step / step_s / peak

    # The step's CUDA graphs go now, on every rank: NCCL's communicators must
    # outlive the graphs that captured their collectives.
    del model, state, step
    gc.collect()
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()

    # Secondary metrics: 1000-step ancestral sampling and DDIM-50 at n=16,
    # the graphed samplers (rank 0 alone under a mesh).
    sample_wall = ddim_wall = None
    if on_card and rank == 0:
        smodel = build_model(config, device=device, state_dict=init_params(config, 0))
        sdiff = Diffusion(noise_steps=config.noise_steps, img_size=IMAGE_SIZE, device=device)
        sample_wall = sampler_wall(lambda g: sdiff.sample(
            smodel, n=SAMPLER_N, image_channels=CHANNELS, generator=g)[0], device)
        _note(f"ancestral sampler timed: {sample_wall}s")
        ddim_wall = sampler_wall(lambda g: sdiff.sample_ddim(
            smodel, n=SAMPLER_N, image_channels=CHANNELS, generator=g, steps=DDIM_STEPS), device)
        _note(f"ddim sampler timed: {ddim_wall}s")
        del smodel
    phase("samplers_s")

    # The 64-px regime (the CelebA-64 knob of Train.ipynb cell 4): S = 4096
    # through the attention backward. Single card only; batch 32.
    t64 = {}
    if on_card and mesh is None:
        size64, batch64, timed64 = TRAIN64
        config64 = dataclasses.replace(config, image_size=size64, batch_size=batch64,
                                       run_name="bench64")
        _, state64, step64 = build_step(config64, device)
        images64 = torch.from_numpy(bench_images(rng, batch64, size64)).to(device)
        flops64 = step_flops(config64)["total"] * batch64
        run_steps(step64, state64, images64, generator, config.seed, 0, WARM_STEPS)
        _note("64x64 train step built + warm")
        dt64, _ = run_steps(step64, state64, images64, generator, config.seed, 200, timed64)
        step64_s = dt64 / timed64
        t64 = {
            "train64_step_ms": round(1000 * step64_s, 2),
            "train64_imgs_per_sec_b32": round(batch64 / step64_s, 1),
            "train64_flops_per_step": flops64,
            "train64_mfu": round(flops64 / step64_s / peak, 4) if peak else None,
        }
        _note(f"64x64 regime timed: {t64}")
    phase("train64_s")

    per_chip = imgs_per_sec / (n_ranks if mesh is not None else 1)
    out = {
        "metric": "train_imgs_per_sec_chip",
        "value": round(per_chip, 1),
        "unit": "imgs/sec/chip (CIFAR-10 32x32, UNet variant 3 / Config D)",
        "vs_baseline": round(per_chip / A100_TORCH_IMGS_PER_SEC_EST, 3),
        "batch_size": batch,
        "n_devices": n_ranks,
        "mesh": dict(mesh.shape) if mesh is not None else None,
        "backend": args.device,
        "device_kind": device_kind,
        "compute_dtype": config.compute_dtype,
        "step_ms": round(1000 * step_s, 2),
        "final_loss": final_loss,
        "flops_per_step": flops_per_step,
        "mfu": round(mfu, 4) if mfu is not None else None,
        "sample_1000step_n16_wall_s": sample_wall,
        "ddim_50step_n16_wall_s": ddim_wall,
        **t64,
        "phase_s": phases,
    }
    if rank == 0:
        print(json.dumps(out), flush=True)
    if started:
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
