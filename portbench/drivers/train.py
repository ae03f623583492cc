"""Training through ``train.train``, as a user trains a model.

Set-up makes the weights on the device from the seed, and the dataset (the
mix's ``dataset_size`` images of the configuration's shape, uniform in
[−1, 1], made on the device from the seed), and hands them to the program:
the images through a ``data.Dataloader`` (shuffled by a seed of the run's),
the weights through ``train.create_train_state``'s ``state_dict``. With the
mix's ``resume_at_ema_start`` the state starts at step ``ema_start_steps``,
as a run resumed there holds it (the EMA equal to the weights, the step
count on, the optimizer fresh), so that every step takes the EMA's blending
branch. It then calls ``train.train(sample_each_epoch=False,
checkpoint_each_epoch=False, prefetch=True)`` once; set-up and window are
that one call:

* the loader handed to it (:class:`FeedLoader`) yields, in its first epochs,
  the batches the mix's ``warmup_epochs`` name (``-1`` is the short last
  one), so that every step variant the window replays is captured before the
  window opens, and after them whole epochs of the ``Dataloader``, timing
  each gather in the window;
* the train step that ``train`` makes is wrapped (:class:`StepSpy`): the
  wrapper counts the steps, opens the window once the warm-up steps are
  issued (a device synchronisation, then the host clock), and closes it at
  the first step issued after ``--seconds`` (a synchronisation, which waits
  for every step issued, then the clock). With ``--trace 1`` the steps
  after the close run under the profiler in stretches (``lib/trace.py``);
  then steps handed to it are not run, the loader stops, and ``train``
  returns;
* the wrapper keeps what the comparison reads: the batches of the first
  three steps as they were fed, their losses, every row's x_t and
  prediction as the model saw and made them (:class:`RowRecorder`, a hook
  on the program's model whose two copies the graph captures), each step's
  gradient as the optimizer got it (from AdamW's first moments before and after the step:
  ``g = (m_after − β1·m_before) / (1 − β1)``), the parameters before the
  second and third steps, and the parameters and EMA after the third. The
  first step runs eagerly, the second and third are replays of the captured
  graph, the window's own.

After the window the reference follows the first three steps from the same
weights, the same rows (by the data order's own rule) and the same t and
noise (drawn as the program draws them: a generator seeded
``((seed + 1) << 32) + step``, t first, then the noise), and the numbers of
:func:`compare` decide ``correct``.
"""

from __future__ import annotations

import gc
import math
import shutil
import threading
import time

import numpy as np
import torch

from portbench.lib import bounds, cost, program, seeds
from portbench.lib import weights as wlib
from portbench.lib.cell import Cell, Facts, log
from portbench.lib.trace import TRIES, Tracer
from portbench.reference import data as ref_data
from portbench.reference import train as ref_train
from portbench.reference import unet as ref_unet
from portbench.reference.precision import exact_float32

CHECK_STEPS = 3  # the steps the reference follows
GRAD_STEPS = 2  # the steps whose gradients are compared: the eager one and the first replay
MARK_EVERY = 100  # window steps between the timeline's CUDA events


class RowRecorder:
    """A forward hook on the program's compute model: every call writes the
    model's input x_t and its prediction, every row, as float32 into two
    device buffers. The copies are captured with the step, so every replay
    of the graph writes them too."""

    def __init__(self, model, batch: int, shape: tuple, device):
        self.x = torch.zeros((batch,) + shape, device=device)
        self.e = torch.zeros((batch,) + shape, device=device)
        self.handle = model.register_forward_hook(self.hook)

    def hook(self, module, args, out):
        with torch.no_grad():
            n = args[0].shape[0]
            self.x[:n].copy_(args[0])
            self.e[:n].copy_(out)

    def read(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.x.clone(), self.e.clone()


class FeedLoader:
    """The loader handed to ``train.train``: the program's ``Dataloader``
    under the harness's epoch plan."""

    def __init__(self, inner, warmup_epochs: list, stop: threading.Event,
                 window_open: threading.Event, t_start: float):
        self.inner, self.plan, self.t_start = inner, warmup_epochs, t_start
        self.stop, self.window_open = stop, window_open
        self.epochs = 0
        self.data_ms: list[float] = []

    def __len__(self) -> int:
        return len(self.inner)

    def __iter__(self):
        epoch = self.epochs
        self.epochs += 1
        if self.stop.is_set():
            return
        batches = iter(self.inner)
        if epoch < len(self.plan):
            last = len(self.inner) - 1
            keep = {last if i < 0 else i for i in self.plan[epoch]}
            for i, batch in enumerate(batches):
                if i in keep:
                    if epoch == i == 0:
                        log(f"first batch gathered at {time.perf_counter() - self.t_start:.2f} s")
                    yield batch
            return
        while not self.stop.is_set():
            t0 = time.perf_counter()
            batch = next(batches, None)
            dt = time.perf_counter() - t0
            if batch is None:
                return
            if self.window_open.is_set():
                self.data_ms.append(1e3 * dt)
            yield batch


class StepSpy:
    """Wraps the train step that ``train.train`` makes (see the module
    docstring). With a tracer, the steps after the window's close are traced
    in stretches of ``trace_steps`` until one holds its kernels; the loader
    stops after that."""

    def __init__(self, cell: Cell, warm_steps: int, stop, window_open,
                 tracer: Tracer | None, trace_steps: int):
        self.cell, self.warm_steps = cell, warm_steps
        self.stop, self.window_open = stop, window_open
        self.tracer, self.trace_steps = tracer, trace_steps
        self.beta1 = cell.cfg["adamw"]["betas"][0]
        self.calls = self.steps = self.images = self.traced = 0
        self.t0 = self.t_end = self.setup_s = None
        self.closed = False
        self.last_loss = None
        self.fed, self.losses = [], []
        self.grads = []  # step -> {name: the gradient as AdamW got it}
        self.seen = []  # step -> (x_t, prediction) of every row, as the model saw and made them
        self.recorder: RowRecorder | None = None
        self.before = {}  # step -> {name: the parameters before it}, steps 1 .. CHECK_STEPS − 1
        self.after = None  # (params, ema) after CHECK_STEPS steps
        self._moments = None  # AdamW's exp_avg after the last step read
        self.marks = []  # (window steps, CUDA event) every MARK_EVERY steps of the window

    def wrap(self, step_fn):
        def step(state, batch, *args, **kwargs):
            return self.call(step_fn, state, batch, args, kwargs)
        return step

    def _sync(self):
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)

    def close(self):
        self._sync()
        self.t_end = time.perf_counter()
        self.closed = True
        if self.tracer is None:
            self.stop.set()

    def _read_gradient(self, state) -> None:
        """The last step's gradient, from AdamW's first moments before and
        after it (none if the step made no update)."""
        moments = {n: state.optimizer.state.get(p, {}).get("exp_avg")
                   for n, p in state.params.items()}
        if any(m is None for m in moments.values()):
            return
        moments = {n: m.double() for n, m in moments.items()}
        prev = self._moments
        self.grads.append({n: ((m if prev is None else m - self.beta1 * prev[n])
                               / (1.0 - self.beta1)).float() for n, m in moments.items()})
        self._moments = moments

    def call(self, step_fn, state, batch, args, kwargs):
        k = self.calls
        self.calls += 1
        if self.stop.is_set():
            return state, self.last_loss
        if 1 <= k <= CHECK_STEPS and len(self.grads) == k - 1:
            self._read_gradient(state)
        if 1 <= k <= CHECK_STEPS and self.recorder is not None:
            self.seen.append(self.recorder.read())
        if 1 <= k < CHECK_STEPS:
            self.before[k] = {n: p.clone() for n, p in state.params.items()}
        if k == CHECK_STEPS:
            self._moments = None
            self.after = ({n: p.clone() for n, p in state.params.items()},
                          {n: p.clone() for n, p in state.ema_params.items()})
        if k == self.warm_steps:
            self._sync()
            self.t0 = time.perf_counter()
            self.setup_s = self.t0 - self.cell.t_start
            self.window_open.set()
            log(f"window opens after {k} warm-up steps; set-up {self.setup_s:.2f} s")
        elif k < self.warm_steps:
            log(f"warm-up step {k} issued at {time.perf_counter() - self.cell.t_start:.2f} s")
        if self.t0 is not None and not self.closed and \
                time.perf_counter() - self.t0 >= self.cell.seconds:
            self.close()
        tr = self.tracer
        if self.closed:  # the traced stretches
            if tr is None or tr.done:
                self.stop.set()
                return state, self.last_loss
            if not tr.active:
                tr.begin()
                self.traced = 0
        if k < CHECK_STEPS:
            self.fed.append(batch.clone())
        state, loss = step_fn(state, batch, *args, **kwargs)
        if k < CHECK_STEPS:
            self.losses.append(loss)
        self.last_loss = loss
        if self.closed:
            self.traced += 1
            if self.traced == self.trace_steps:
                tr.end(self.traced)
        elif self.t0 is not None:
            self.steps += 1
            self.images += batch.shape[0]
            if self.cell.device.type == "cuda" and self.steps % MARK_EVERY in (0, 1):
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                self.marks.append((self.steps, event))
        return state, loss

    def timeline(self) -> list[float]:
        """Device milliseconds a step over each stretch of MARK_EVERY steps
        of the window, from CUDA events recorded between steps (the host
        waits for none of them)."""
        ends = [(n, e) for n, e in self.marks if n % MARK_EVERY == 0]
        starts = {n: e for n, e in self.marks if n % MARK_EVERY == 1}
        return [starts[n - MARK_EVERY + 1].elapsed_time(e) / (MARK_EVERY - 1)
                for n, e in ends if n - MARK_EVERY + 1 in starts]


def _median_diff(prog: dict, ref: dict) -> tuple[float, str]:
    """The median leaf's ‖prog − ref‖ / ‖ref‖, and the worst leaf's name."""
    rel = {n: float((prog[n].double() - ref[n].double()).norm() / ref[n].double().norm())
           for n in ref}
    return float(np.median(list(rel.values()))), max(rel, key=rel.get)


def _leaf_gap(prog: dict, ref: dict, masks: dict | None = None) -> tuple[float, str]:
    """Worst leaf of |‖prog‖ − ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖),
    over the entries ``masks`` keeps."""
    def norm(t, n):
        return float((t if masks is None else t[masks[n]]).double().norm())

    pn = {n: norm(prog[n], n) for n in ref}
    rn = {n: norm(ref[n], n) for n in ref}
    median = float(np.median(list(rn.values())))
    worst, which = 0.0, ""
    for n in ref:
        gap = abs(pn[n] - rn[n]) / max(rn[n], median)
        if gap > worst:
            worst, which = gap, n
    return worst, which


def _rows_gap(prog: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """‖prog − ref‖ / ‖ref‖ over every row, and the worst row's."""
    d = (prog - ref).double()
    r = ref.double()
    rows = d.flatten(1).norm(dim=1) / r.flatten(1).norm(dim=1)
    return float(d.norm() / r.norm()), float(rows.max())


def compare(spy, ref: dict, w0: dict, expected_batches: list, cfg: dict, grads_at,
            predict) -> dict:
    """The numbers that decide ``correct``, over the first three steps (the
    first eager, the others replays of the window's graph):

    * ``rows_bad``: fed batches that differ from the rows the data order
      gives (exact);
    * ``xt_gap``: the model's input x_t against the reference's, from the
      same rows, t and ε (the largest difference over the largest entry);
    * ``pred_gap``: every row's prediction against the reference model's at
      the same x_t and at the program's own parameters before the step
      (``predict(step, params)``; the first step's are the weights both sides
      start from): the relative L2 gap of all rows, the worst step
      (``pred_gap_row``, the worst row's, is reported);
    * ``grad_gap``: the gradient as AdamW got it, worst leaf
      (:func:`_leaf_gap`), the worse of the first two steps, against the
      reference's at the program's own parameters before the step
      (``grads_at(step, params)``);
    * ``change_gap``: the parameters' change over the three steps, worst leaf;
    * ``ema_gap``: the EMA's change over the three steps, worst leaf.

    Reported beside them: ``loss_gap`` (the three losses against the
    reference's own path), ``grad_diff`` (the median leaf's difference of the
    first two steps' gradients, :func:`_median_diff`), the third step's
    ``grad_gap_step3`` and ``grad_diff_step3`` (bf16 against float32 reads
    more, and more from seed to seed, after two AdamW steps), and
    ``grad_diff_own`` (the later steps against the reference's own path,
    which parts from the program's by AdamW's first steps: they move an entry
    whose gradient is nought to rounding by a whole step either way).

    What is nought to rounding in the reference's first gradient is left
    out: of the gradient numbers, leaves whose norm is under a thousandth of
    the median leaf's; of the change numbers, also the entries whose
    magnitude is under 1e-5 of the median leaf's root mean square (a key's
    bias under softmax, a third of each ``qkv.bias``, reads zero or a few
    float32 roundings). AdamW moves such an entry by a whole step on the
    sign of its rounding noise, on one side and not the other."""
    numbers: dict = {"rows_bad": None, "xt_gap": None, "pred_gap": None, "pred_gap_row": None,
                     "loss_gap": None, "grad_gap": None, "grad_diff": None,
                     "grad_gap_step3": None, "grad_diff_step3": None, "grad_diff_own": None,
                     "change_gap": None, "ema_gap": None}
    if not cfg["use_ema"]:
        numbers.pop("ema_gap")
    if len(spy.fed) == CHECK_STEPS:
        numbers["rows_bad"] = float(sum(
            not torch.equal(f.cpu(), e) for f, e in zip(spy.fed, expected_batches)))
    if len(spy.losses) == CHECK_STEPS:
        numbers["loss_gap"] = max(abs(float(lp) - lr) / abs(lr)
                                  for lp, lr in zip(spy.losses, ref["losses"]))
    params_before = dict(spy.before)
    params_before[0] = w0
    if len(spy.seen) == CHECK_STEPS and len(params_before) == CHECK_STEPS:
        xt = pred = row = 0.0
        for k, (x_prog, e_prog) in enumerate(spy.seen):
            x_ref = ref["x_t"][k]
            xt = max(xt, float((x_prog - x_ref).abs().max() / x_ref.abs().max()))
            gap, worst_row = _rows_gap(e_prog, predict(k, params_before[k]))
            pred, row = max(pred, gap), max(row, worst_row)
            log(f"step {k}: pred_gap {gap:.5f} (worst row {worst_row:.5f})")
        numbers.update(xt_gap=xt, pred_gap=pred, pred_gap_row=row)
    g_ref = ref["grads"][0]
    norms = {n: float(g.double().norm()) for n, g in g_ref.items()}
    leaves = [n for n in g_ref if norms[n] >= 1e-3 * float(np.median(list(norms.values())))]
    rms = float(np.median([norms[n] / g_ref[n].numel() ** 0.5 for n in g_ref]))
    masks = {n: g_ref[n].abs() >= 1e-5 * rms for n in leaves}
    dropped = sum(int((~m).sum()) for m in masks.values())
    log(f"left out: leaves {sorted(set(g_ref) - set(leaves))}; {dropped} entries of "
        f"{sum(m.numel() for m in masks.values())} in the change numbers")
    if len(spy.grads) == CHECK_STEPS and len(params_before) == CHECK_STEPS:
        gaps, diffs, own = [], [], []
        for k, g_prog in enumerate(spy.grads):
            g_k = g_ref if k == 0 else grads_at(k, params_before[k])
            gap, worst = _leaf_gap({n: g_prog[n] for n in leaves}, {n: g_k[n] for n in leaves})
            diff, worst_diff = _median_diff({n: g_prog[n] for n in leaves},
                                            {n: g_k[n] for n in leaves})
            gaps.append(gap)
            diffs.append(diff)
            if k > 0:
                own.append(_median_diff({n: g_prog[n] for n in leaves},
                                        {n: ref["grads"][k][n] for n in leaves})[0])
            log(f"step {k}: grad_gap {gap:.5f} (worst leaf {worst}), "
                f"grad_diff {diff:.5f} (worst leaf {worst_diff})")
            del g_k
        numbers.update(grad_gap=max(gaps[:GRAD_STEPS]), grad_diff=max(diffs[:GRAD_STEPS]),
                       grad_gap_step3=gaps[2], grad_diff_step3=diffs[2], grad_diff_own=max(own))
    if spy.after is not None:
        for key, side, mine in (("change_gap", "params", spy.after[0]),
                                ("ema_gap", "ema", spy.after[1])):
            if key in numbers:
                numbers[key], worst = _leaf_gap({n: mine[n] - w0[n] for n in leaves},
                                                {n: ref[side][n] - w0[n] for n in leaves}, masks)
                log(f"{key} worst leaf: {worst}")
    return numbers


def make_images(n: int, shape: tuple, seed: int, device) -> np.ndarray:
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((n,) + shape, generator=gen, device=device, dtype=torch.float32)
    return (x * 2.0 - 1.0).cpu().numpy()


def reference_draws(cfg: dict, train_seed: int, batch: int, shape: tuple, device,
                    start_step: int = 0) -> list:
    """Each checked step's (t, ε): a generator seeded ``((seed + 1) << 32) +
    step`` (the run's step count); t uniform in [1, noise_steps), then
    standard-normal ε."""
    gen = torch.Generator(device=device)
    draws = []
    for step in range(start_step, start_step + CHECK_STEPS):
        gen.manual_seed(((train_seed + 1) << 32) + step)
        t = torch.randint(1, cfg["noise_steps"], (batch,), generator=gen, device=device)
        eps = torch.randn((batch,) + shape, generator=gen, dtype=torch.float32, device=device)
        draws.append((t, eps))
    return draws


def run(cell: Cell) -> dict:
    from aliasfree_diffusion_models_pytorch_tpu_torch import train as program_train
    from aliasfree_diffusion_models_pytorch_tpu_torch.data import ArrayDataset, Dataloader

    cfg, mix, device = cell.cfg, cell.mix, cell.device
    model = ref_unet.Model.from_config(cfg)
    size, channels = cfg["image_size"], cfg["image_channels"]
    shape = (size, size, channels)
    batch = mix["batch"]
    w0 = wlib.make(model, seeds.derive(cell.seed, "weights"), device)
    images = make_images(mix["dataset_size"], shape, seeds.derive(cell.seed, "data"), device)
    log(f"weights and {len(images)} images made at {time.perf_counter() - cell.t_start:.2f} s")
    train_seed = seeds.derive(cell.seed, "train", 31)
    loader_seed = seeds.derive(cell.seed, "loader", 31)
    start_step = cfg["ema_start_steps"] if mix.get("resume_at_ema_start") else 0

    stop, window_open = threading.Event(), threading.Event()
    inner = Dataloader(ArrayDataset(images, np.zeros(len(images), np.int32)), batch,
                       shuffle=True, seed=loader_seed)
    loader = FeedLoader(inner, mix["warmup_epochs"], stop, window_open, cell.t_start)
    warm_steps = sum(len(e) for e in mix["warmup_epochs"])
    # Enough epochs for the window at any pace up to max_steps_per_s, and the
    # traced stretches: the wrapper stops the loader once they are done.
    epochs = len(mix["warmup_epochs"]) + 2 + math.ceil(
        cell.seconds * mix["max_steps_per_s"] / len(inner))
    tracer = Tracer(program.launches, log) if cell.trace else None
    spy = StepSpy(cell, warm_steps, stop, window_open, tracer, mix["trace_steps"])
    config = program.train_config(cfg, f"portbench_{cell.name}", batch_size=batch,
                                  epochs=epochs, seed=train_seed)

    real_create, real_make = program_train.create_train_state, program_train.make_train_step

    def create_train_state(config, device="cuda", state_dict=None, mesh=None):
        log(f"train() builds its state at {time.perf_counter() - cell.t_start:.2f} s")
        model_, state = real_create(config, device=device, state_dict=w0, mesh=mesh)
        state.step = start_step
        spy.recorder = RowRecorder(model_, batch, shape, device)
        log(f"state built at {time.perf_counter() - cell.t_start:.2f} s, at step {state.step}")
        return model_, state

    def make_train_step(*args, **kwargs):
        return spy.wrap(real_make(*args, **kwargs))

    program_train.create_train_state, program_train.make_train_step = (
        create_train_state, make_train_step)
    shutil.rmtree(cell.workdir, ignore_errors=True)
    try:
        program_train.train(config, loader, root=str(cell.workdir), device=device,
                            sample_each_epoch=False, checkpoint_each_epoch=False, prefetch=True)
    finally:
        program_train.create_train_state, program_train.make_train_step = real_create, real_make
    if spy.t0 is None:
        raise RuntimeError("the window never opened: train() ran fewer steps than the warm-up")
    if spy.t_end is None:  # train() ran out of epochs before the window closed
        log("train() returned before the window's time was up")
        spy.close()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    window_s = spy.t_end - spy.t0
    log(f"window: {spy.steps} steps, {spy.images} images in {window_s:.3f} s; "
        f"gathers timed {len(loader.data_ms)}")
    if spy.marks:
        log("device ms a step, by stretches of {} window steps: {}".format(
            MARK_EVERY, " ".join(f"{ms:.3f}" for ms in spy.timeline())))
    log(f"launches so far {program.launches()} | {program.impl_text()}")

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    order = ref_data.permutation(len(images), loader_seed, 0)  # the first epoch's
    expected = [torch.from_numpy(images[order[k * batch:(k + 1) * batch]])
                for k in range(CHECK_STEPS)]
    on_device = [e.to(device) for e in expected]
    with exact_float32():
        draws = reference_draws(cfg, train_seed, batch, shape, device, start_step)
        ref = ref_train.run(w0, model, cfg, on_device, draws, start_step=start_step)

        def grads_at(k, params):
            return ref_train.grads_at(params, model, cfg, on_device[k], draws[k])

        def predict(k, params):
            return ref_train.predict(params, model, ref["x_t"][k], draws[k][0])

        numbers = compare(spy, ref, w0, expected, cfg, grads_at, predict)

    facts = Facts(kind="train", model=model, batch=batch, window_s=window_s, images=spy.images,
                  forwards_per_image=1, flops_fwd=cost.flops_per_image(model, False),
                  flops_train=cost.flops_per_image(model, True),
                  peak_flops=bounds.peak_bf16(torch.cuda.get_device_name(device))
                  if device.type == "cuda" else None,
                  trace=tracer.summary if tracer else None, data_ms=loader.data_ms)
    records = {"kind": "train", "w0": w0, "model": model, "cfg": cfg, "expected": expected,
               "draws": draws, "ref": ref, "device": device, "start_step": start_step}
    return {"attempted": spy.steps, "failed": 0,
            "end_to_end": {"train_imgs_per_s": spy.images / window_s, "setup_s": spy.setup_s},
            "facts": facts, "numbers": numbers, "memory_peak_bytes": memory_peak,
            "records": records}
