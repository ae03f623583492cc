"""Config-E sampling requests: ``Diffusion.sample(theta=θ)``, DDPM over every
noise step with the rotation θ/N after each, the last included, one client
in a closed loop.

Every call has its own θ, drawn from ``--seed`` and the call's number,
uniform in the mix's ``theta_range``: a sweep's frames, so that each call
builds its rotation operator, which no cache can serve. Every call starts
from the same latent and noise (``noise_fn`` from a device generator seeded
from ``--seed``), as the reference's sweep re-seeds for each angle.

The rest follows :mod:`portbench.lib.sampling`, whose parts this module
takes: set-up builds the program's model and ``Diffusion`` and makes one
call (the kernels' build, the graphs' capture), then goes on calling for the
mix's ``settle_s`` seconds, each call at an angle of its own, so that the
slow phase at a run's start (calls ~9% slower, most often for up to 20 s)
falls before the window. The window makes
calls until ``--seconds`` have passed and closes when the last one has
returned its uint8 images to the host. The :class:`~portbench.lib.sampling.Recorder`
keeps the model's input and prediction of a few rows at every step, and
the comparison (:func:`portbench.lib.sampling.compare`, call by call) checks
each kept step against the reference's DDPM update followed by the
reference's rotation of it (:mod:`portbench.reference.rotation`, float64) at
the call's angle, and the last step through the uint8 conversion after the
rotation. The card rotates in float32, so ``update_gap`` and
``uint8_levels`` are not exact (``limits/<cell>.json`` gives why).

With ``--trace 1``, after the window, a call at a fresh angle runs with the
profiler started before the call, so the stretch holds the operator's build
(the program's ``rotation.build`` span) and the call's first
``trace_steps`` steps.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from portbench.lib import bounds, cost, program, sampling, seeds
from portbench.lib import weights as wlib
from portbench.lib.cell import Cell, Facts, log
from portbench.lib.trace import Tracer
from portbench.reference import rotation as ref_rotation
from portbench.reference import unet as ref_unet
from portbench.reference.precision import exact_float32

NUMBERS = ("start_gap", "eps_gap", "eps_gap_image", "update_gap", "uint8_levels")


class RotatedPlan(sampling.Plan):
    """DDPM with the per-step rotation at the angle :attr:`theta`."""

    def __init__(self, cfg: dict, mix: dict):
        super().__init__("ddpm", cfg, mix)
        self.order = int(cfg["rotation"]["order"])
        if self.order != 3:
            raise ValueError(f"the reference rotates with cubic splines, not order {self.order}")
        self.theta = 0.0

    def call(self, diffusion, model, n: int, channels: int, noise_fn):
        return diffusion.sample(model, n=n, image_channels=channels, theta=self.theta,
                                rotation_order=self.order, noise_fn=noise_fn)[0]

    def update(self, x, eps, j: np.ndarray, z):
        """The reference's DDPM step, then its rotation by θ/N in float64."""
        return ref_rotation.rotate(super().update(x, eps, j, z),
                                   self.theta / self.schedule.noise_steps)


def theta_of(seed: int, call: int, span) -> float:
    lo, hi = span
    return float(np.random.default_rng(seeds.derive(seed, f"theta{call}")).uniform(lo, hi))


def compare(plan: RotatedPlan, model_ref, w0: dict, kept: dict, steps_of: dict,
            thetas: dict, device, seed: int, shape: tuple, block: int) -> dict:
    """:func:`portbench.lib.sampling.compare` call by call, each at its own
    angle; every number the largest over the calls. Every call's noise is
    call 0's, which is what ``sampling.compare`` draws for key 0."""
    numbers = dict.fromkeys(NUMBERS)
    for call, record in kept.items():
        plan.theta = thetas[call]
        one = sampling.compare(plan, model_ref, w0, {0: record}, {0: steps_of[call]}, device,
                               seed, shape, block)
        numbers = {k: one[k] if numbers[k] is None else max(numbers[k], one[k]) for k in NUMBERS}
    return numbers


def run(cell: Cell) -> dict:
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
    from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import build_model

    cfg, mix, device = cell.cfg, cell.mix, cell.device
    plan = RotatedPlan(cfg, mix)
    model_ref = ref_unet.Model.from_config(cfg)
    n, size, channels = mix["n"], cfg["image_size"], cfg["image_channels"]
    shape = (n, size, size, channels)
    chk = mix["check"]
    w0 = wlib.make(model_ref, seeds.derive(cell.seed, "weights"), device)
    model = build_model(program.train_config(cfg, f"portbench_{cell.name}"), device=device,
                        state_dict=w0)
    diffusion = Diffusion(noise_steps=cfg["noise_steps"], beta_start=cfg["beta_start"],
                          beta_end=cfg["beta_end"], img_size=size, device=device)
    rec = sampling.Recorder(model, cfg["noise_steps"], chk["rows"], shape[1:], device)
    gen = torch.Generator(device=device)
    tracer = Tracer(program.launches, log) if cell.trace else None
    n_steps = len(plan.ts)
    tr_steps = min(mix.get("trace_steps", 0), n_steps - 1)
    noise_seed = seeds.derive(cell.seed, "noise0")  # every call's: sampling.compare's key 0

    def noise_fn(shape_, step):
        if step == 0:
            gen.manual_seed(noise_seed)
        elif tracer is not None and tracer.active and step == 1 + tr_steps:
            tracer.end(tr_steps)
        return torch.randn(shape_, generator=gen, device=device, dtype=torch.float32)

    rows = np.sort(np.random.default_rng(seeds.derive(cell.seed, "rows"))
                   .choice(n, chk["rows"], replace=False))
    rec.select(rows)
    thetas = {}

    def one_call(call: int):
        plan.theta = thetas[call] = theta_of(cell.seed, call, mix["theta_range"])
        t0 = time.perf_counter()
        out = plan.call(diffusion, model, n, channels, noise_fn)
        t_issued = time.perf_counter()
        u8 = out.cpu()
        t1 = time.perf_counter()
        return t1 - t0, t_issued - t0, u8

    warm = [one_call(-1)[0]]  # builds the kernels and captures the graphs
    t_settle = time.perf_counter()
    while time.perf_counter() - t_settle < mix.get("settle_s", 0.0):
        warm.append(one_call(-1 - len(warm))[0])
    log("set-up calls, ms: " + ", ".join(f"{1e3 * dt:.1f}" for dt in warm))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    keep_calls = set(range(chk.get("first_calls", 0)))
    steps_of, kept, latencies, issued, bad = {}, {}, [], [], 0
    t_open = time.perf_counter()
    setup_s = t_open - cell.t_start
    log(f"window opens; set-up {setup_s:.2f} s")
    call = 0
    while time.perf_counter() - t_open < cell.seconds:
        dt, dt_issued, u8 = one_call(call)
        latencies.append(dt)
        issued.append(dt_issued)
        if tuple(u8.shape) != shape or u8.dtype != torch.uint8:
            bad += 1
        if call in keep_calls:
            rs = np.random.default_rng(seeds.derive(cell.seed, f"steps{call}"))
            picked = rs.choice(n_steps - 1, min(chk["steps"], n_steps - 1), replace=False)
            steps = sorted(set(picked.tolist()) | {0, n_steps - 1})
            slots = sorted({int(plan.ts[j]) for j in steps}
                           | {int(plan.ts[j + 1]) for j in steps if j + 1 < n_steps})
            x, e = rec.keep(slots)
            steps_of[call] = steps
            kept[call] = (rows, slots, x, e, u8[torch.as_tensor(rows)].clone())
        call += 1
    window_s = time.perf_counter() - t_open
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"requests in the window: {call}; {call * n} images in {window_s:.3f} s")
    log("window calls, ms: " + ", ".join(f"{1e3 * dt:.1f}" for dt in latencies))
    if len(latencies) > 1:
        sampling.log_modes(latencies, issued)
    extra = call
    while tracer is not None and not tracer.done:
        tracer.begin()  # before the call: the stretch holds the operator's build
        one_call(extra)
        extra += 1
    rec.handle.remove()
    log(f"launches so far {program.launches()} | {program.impl_text()}")

    del model, diffusion
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with exact_float32():
        numbers = compare(plan, model_ref, w0, kept, steps_of, thetas, device, cell.seed, shape,
                          chk.get("block", 64))
    numbers["outputs_bad"] = float(bad)

    images = call * n
    facts = Facts(kind="sample", model=model_ref, batch=n, window_s=window_s, images=images,
                  forwards_per_image=n_steps, flops_fwd=cost.flops_per_image(model_ref, False),
                  flops_train=cost.flops_per_image(model_ref, True),
                  peak_flops=bounds.peak_bf16(torch.cuda.get_device_name(device))
                  if device.type == "cuda" else None,
                  trace=tracer.summary if tracer else None)
    e2e = {"sample_imgs_per_s": images / window_s, "setup_s": setup_s}
    if latencies:
        e2e["sample_p95_ms"] = 1e3 * (statistics.quantiles(latencies, n=100, method="inclusive")[94]
                                      if len(latencies) > 1 else latencies[0])
    records = {"kind": "sample", "plan": plan, "model": model_ref, "w0": w0, "kept": kept,
               "steps_of": steps_of, "thetas": thetas, "seed": cell.seed, "shape": shape,
               "device": device, "block": chk.get("block", 64)}
    return {"attempted": call, "failed": bad, "end_to_end": e2e, "facts": facts,
            "numbers": numbers, "memory_peak_bytes": memory_peak, "records": records}
