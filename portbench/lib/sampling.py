"""Sampling requests through ``Diffusion.sample`` (DDPM) or
``Diffusion.sample_ddim``, one client in a closed loop.

Set-up builds the program's model (``models.unet.build_model`` with the
seeded weights, in the configuration's compute dtype) and ``Diffusion``, and
makes one call at the mix's ``n``, which builds the kernels and captures the
sampler's graphs. The window then makes calls back to back until
``--seconds`` have passed since it opened; it closes when the last call
started before then has returned its uint8 images to the host. A call's
latency runs from the call to those images on the host. Each call's noise is
handed in by ``noise_fn`` from a generator on the device, seeded from
``--seed`` and the call's number: draw 0 is the initial latent, draw j the
noise of reverse step j.

The comparison follows the program step by step from its own state: a
forward hook on the program's model (:class:`Recorder`) writes, at every
model call, the input x_t and the prediction of a few rows drawn from the
seed into slot t of two device buffers. That adds two small copies to each
step and nothing else. After chosen calls the harness keeps the slots it
will check. Once the window has closed, the reference:

* ``start_gap``: compares the first step's input with the noise handed in
  (exact: nothing has touched it);
* ``eps_gap``: runs its own model at the recorded x_t and t and compares the
  predictions: the relative L2 gap of all a call's checked predictions
  together, the worst call (``eps_gap_image``, the worst single image's, is
  reported beside it);
* ``update_gap``: applies its own update to the recorded x_t, prediction and
  noise, and compares with the next step's recorded input (the largest
  difference over the image's largest entry, the worst);
* ``uint8_levels``: applies the last update and the uint8 conversion, and
  compares with the images the call returned (the largest difference in
  levels);
* ``outputs_bad``: counts the window's calls whose images are not (n, H, W, C)
  uint8.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from portbench.lib import bounds, cost, program, seeds
from portbench.lib import weights as wlib
from portbench.lib.cell import Cell, Facts, log
from portbench.lib.trace import Tracer
from portbench.reference import unet as ref_unet
from portbench.reference.diffusion import Schedule, to_uint8
from portbench.reference.precision import exact_float32


class Recorder:
    """A forward hook on the program's model: at every call, rows ``rows``
    of the input and of the prediction go to slot t of ``x`` and ``e``."""

    def __init__(self, model, slots: int, rows: int, shape: tuple, device):
        with torch.inference_mode():
            self.x = torch.zeros((slots, rows) + shape, device=device)
            self.e = torch.zeros((slots, rows) + shape, device=device)
            self.rows = torch.zeros(rows, dtype=torch.long, device=device)
        self.handle = model.register_forward_hook(self.hook)

    def hook(self, module, args, out):
        x, t = args[0], args[1]
        slot = t[:1].long()
        self.x.index_copy_(0, slot, x.index_select(0, self.rows).float().unsqueeze(0))
        self.e.index_copy_(0, slot, out.index_select(0, self.rows).float().unsqueeze(0))

    def select(self, rows: np.ndarray) -> None:
        with torch.inference_mode():
            self.rows.copy_(torch.as_tensor(rows, dtype=torch.long))

    def keep(self, slots: list) -> tuple[torch.Tensor, torch.Tensor]:
        with torch.inference_mode():
            idx = torch.as_tensor(slots, dtype=torch.long, device=self.x.device)
            return self.x.index_select(0, idx).clone(), self.e.index_select(0, idx).clone()


class Plan:
    """What one kind of sampler calls and checks: DDPM (every step, t = N−1 …
    1) or DDIM (``steps`` of the subsequence, η)."""

    def __init__(self, kind: str, cfg: dict, mix: dict):
        self.kind, self.cfg, self.mix = kind, cfg, mix
        self.schedule = Schedule(cfg)
        n_steps = cfg["noise_steps"]
        if kind == "ddpm":
            self.ts = np.arange(n_steps - 1, 0, -1)  # the model's t, step by step
            self.noisy = [True] * (len(self.ts) - 1) + [False]  # none at t = 1
        else:
            self.eta = float(mix["eta"])
            self.ts = self.schedule.ddim_taus(mix["steps"])
            ahat = self.schedule.alpha_hat.numpy().astype(np.float64)
            ac, ap = ahat[self.ts], np.append(ahat[self.ts[1:]], 1.0)
            self.noisy = [self.eta != 0.0 and (1.0 - p) * (1.0 - c / p) > 0.0
                          for c, p in zip(ac, ap)]
        # noise_fn's draws: 0 the latent, then one for each noisy step in turn
        self.draw_of = {}
        for j, noisy in enumerate(self.noisy):
            if noisy:
                self.draw_of[j] = len(self.draw_of) + 1

    def call(self, diffusion, model, n: int, channels: int, noise_fn):
        if self.kind == "ddpm":
            return diffusion.sample(model, n=n, image_channels=channels, noise_fn=noise_fn)[0]
        return diffusion.sample_ddim(model, n=n, image_channels=channels, steps=self.mix["steps"],
                                     eta=self.eta, noise_fn=noise_fn)

    def noise_of_step(self, j: int) -> int | None:
        """The noise_fn draw that step j (0-based) adds, None for none."""
        return self.draw_of.get(j)

    def update(self, x, eps, j: np.ndarray, z):
        """The reference's step j (per row) from x and the program's prediction."""
        dev = x.device
        if self.kind == "ddpm":
            t = torch.as_tensor(self.ts[j], device=dev)
            return self.schedule.ddpm_update(x, eps, t, z)
        return self.schedule.ddim_update(x, eps, torch.as_tensor(j, device=dev), self.ts,
                                         self.eta, z)


def _noise(seed: int, device, shape, keep: set) -> dict:
    """Draws ``keep`` of the sequence that a call's noise_fn hands out."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for d in range(max(keep) + 1 if keep else 0):
        z = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        if d in keep:
            out[d] = z
    return out


def run(cell: Cell, kind: str) -> dict:
    from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
    from aliasfree_diffusion_models_pytorch_tpu_torch.models.unet import build_model

    cfg, mix, device = cell.cfg, cell.mix, cell.device
    plan = Plan(kind, cfg, mix)
    model_ref = ref_unet.Model.from_config(cfg)
    n, size, channels = mix["n"], cfg["image_size"], cfg["image_channels"]
    shape = (n, size, size, channels)
    chk = mix["check"]
    w0 = wlib.make(model_ref, seeds.derive(cell.seed, "weights"), device)
    model = build_model(program.train_config(cfg, f"portbench_{cell.name}"), device=device,
                        state_dict=w0)
    diffusion = Diffusion(noise_steps=cfg["noise_steps"], beta_start=cfg["beta_start"],
                          beta_end=cfg["beta_end"], img_size=size, device=device)
    rec = Recorder(model, cfg["noise_steps"], chk["rows"], shape[1:], device)
    gen = torch.Generator(device=device)
    tracer = Tracer(program.launches, log) if cell.trace else None
    n_steps = len(plan.ts)
    tr_from, tr_steps = mix.get("trace_from", 0), mix.get("trace_steps", 0)
    state = {"traced_from": None, "tracing": False}

    def noise_fn(shape_, step):
        if step == 0:
            gen.manual_seed(state["noise_seed"])
        elif state["tracing"] and kind == "ddpm":
            # DDPM traces stretches of steps inside a call, until one holds its kernels
            if tracer.active and step == state["traced_from"] + tr_steps:
                tracer.end(tr_steps)
            elif not tracer.done and not tracer.active and step >= tr_from \
                    and step + tr_steps < n_steps:
                tracer.begin()
                state["traced_from"] = step
        return torch.randn(shape_, generator=gen, device=device, dtype=torch.float32)

    # the rows the recorder keeps, chosen once a run, so that a request does
    # no work of the harness's own
    rows = np.sort(np.random.default_rng(seeds.derive(cell.seed, "rows"))
                   .choice(n, chk["rows"], replace=False))
    rec.select(rows)

    def one_call(call: int):
        state["noise_seed"] = seeds.derive(cell.seed, f"noise{call}")
        t0 = time.perf_counter()
        out = plan.call(diffusion, model, n, channels, noise_fn)
        t_issued = time.perf_counter()
        u8 = out.cpu()
        t1 = time.perf_counter()
        return t1 - t0, t_issued - t0, u8

    one_call(-1)  # builds the kernels and captures the graphs
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # the calls whose records are kept, and the steps checked in each
    keep_calls = set(range(chk.get("first_calls", 0)))
    if chk.get("calls"):
        rng = np.random.default_rng(seeds.derive(cell.seed, "check"))
        keep_calls |= set(rng.choice(chk["call_range"], chk["calls"], replace=False).tolist())
    steps_of = {}
    kept, latencies, issued, bad = {}, [], [], 0
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
    t_end = time.perf_counter()
    window_s = t_end - t_open
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"requests in the window: {call}; {call * n} images in {window_s:.3f} s")
    if len(latencies) > 1:
        q = statistics.quantiles(latencies, n=20, method="inclusive")
        log("latency ms: min {:.2f}, 5% {:.2f}, 25% {:.2f}, median {:.2f}, 75% {:.2f}, 95% {:.2f}, "
            "max {:.2f}".format(*(1e3 * v for v in (min(latencies), q[0], q[4], q[9], q[14], q[18],
                                                    max(latencies)))))
        log_modes(latencies, issued)
    # The traced stretches, after the window: DDPM steps inside calls, DDIM
    # whole requests (from the call to the images on the host).
    state["tracing"] = tracer is not None
    extra = call
    while tracer is not None and not tracer.done:
        if kind != "ddpm":
            tracer.begin()
        one_call(extra)
        if kind != "ddpm":
            tracer.end(n_steps)
        extra += 1
    rec.handle.remove()
    log(f"launches so far {program.launches()} | {program.impl_text()}")

    del model, diffusion
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with exact_float32():
        numbers = compare(plan, model_ref, w0, kept, steps_of, device, cell.seed, shape,
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
               "steps_of": steps_of, "device": device, "block": chk.get("block", 64)}
    return {"attempted": call, "failed": bad, "end_to_end": e2e, "facts": facts,
            "numbers": numbers, "memory_peak_bytes": memory_peak, "records": records}


def log_modes(latencies: list, issued: list, over: float = 1.05) -> None:
    """The requests slower than ``over`` times the fastest: their share,
    where they fall in the window, and the host's part of both kinds (the
    seconds until the call returned with every launch issued, the rest being
    the wait for the images)."""
    fast = min(latencies)
    slow = [dt > over * fast for dt in latencies]
    runs, last = [], None
    for s in slow:
        if s == last:
            runs[-1][1] += 1
        else:
            runs.append(["s" if s else "f", 1])
            last = s
    parts = []
    for name, pick in (("fast", False), ("slow", True)):
        sel = [i for i, s in enumerate(slow) if s == pick]
        if sel:
            parts.append("{} {}: latency median {:.2f} ms, issued in {:.2f} ms".format(
                name, len(sel), 1e3 * statistics.median(latencies[i] for i in sel),
                1e3 * statistics.median(issued[i] for i in sel)))
    log(f"slow requests (over {over} x the fastest): {sum(slow)} of {len(slow)} "
        f"({100.0 * sum(slow) / len(slow):.1f}%); " + "; ".join(parts))
    log("in order (f fast, s slow): " + " ".join(f"{k}{c}" for k, c in runs))


def compare(plan: Plan, model_ref, w0: dict, kept: dict, steps_of: dict, device, seed: int,
            shape: tuple, block: int) -> dict:
    """The numbers of the module docstring over the kept calls."""
    numbers = {"start_gap": None, "eps_gap": None, "eps_gap_image": None, "update_gap": None,
               "uint8_levels": None}
    if not kept:
        return numbers
    start = eps_gap = eps_image = upd = levels = 0.0
    for call, (rows, slots, x, e, u8_rows) in kept.items():
        at = {s: i for i, s in enumerate(slots)}
        steps = steps_of[call]
        need = {0} | {plan.noise_of_step(j) for j in steps} - {None}
        z = _noise(seeds.derive(seed, f"noise{call}"), device, shape, need)
        r = torch.as_tensor(rows, device=device)
        # the start: the first step's input is the latent handed in
        first = x[at[int(plan.ts[0])]]
        start = max(start, float((first - z[0].index_select(0, r)).abs().max()))
        # the model at the recorded inputs
        xs = torch.cat([x[at[int(plan.ts[j])]] for j in steps])
        es = torch.cat([e[at[int(plan.ts[j])]] for j in steps])
        ts = torch.as_tensor(np.repeat(plan.ts[steps], len(rows)), device=device)
        pred = torch.cat([ref_unet.forward(w0, model_ref, xs[i:i + block], ts[i:i + block])
                          for i in range(0, len(xs), block)])
        gap = (es - pred).flatten(1).norm(dim=1) / pred.flatten(1).norm(dim=1)
        eps_image = max(eps_image, float(gap.max()))
        eps_gap = max(eps_gap, float((es - pred).norm() / pred.norm()))
        # the updates, from the program's own state and prediction
        for j in steps:
            xj, ej = x[at[int(plan.ts[j])]], e[at[int(plan.ts[j])]]
            d = plan.noise_of_step(j)
            zj = None if d is None else z[d].index_select(0, r)
            nxt = plan.update(xj, ej, np.full(len(rows), j), zj)
            if j + 1 < len(plan.ts):
                got = x[at[int(plan.ts[j + 1])]]
                scale = nxt.flatten(1).abs().max(dim=1).values.clamp(min=1e-30)
                rel = (got - nxt).flatten(1).abs().max(dim=1).values / scale
                upd = max(upd, float(rel.max()))
            else:
                diff = to_uint8(nxt).int() - u8_rows.to(device).int()
                levels = max(levels, float(diff.abs().max()))
    numbers.update(start_gap=start, eps_gap=eps_gap, eps_gap_image=eps_image, update_gap=upd,
                   uint8_levels=levels)
    return numbers
