"""The control and the planted faults of the comparison that decides
``correct``, read from what one run's comparison read (``run_cell(records=)``).

* Train cells. The control is the reference put in the program's place and
  computed in fp8 (:class:`portbench.reference.precision.FP8`): it follows
  the same three steps from the same weights, rows, t and noise, and its
  losses, predictions, gradients, parameters and EMA are compared with the
  float32 reference's by the cell's own numbers (``drivers/train.py:compare``). The
  faults, planted in the reference put in the program's place, in every
  step or only from the second on (the steps the program replays): half of
  each batch left out, the mean taken over the rest (``half_batch``); the
  first parameter's gradient doubled where it is made (``grad_altered``). A
  state left unchanged reads 1 by the numbers' measure and needs no run.
* Sampling cells. The control's reading is ``eps_gap`` between the fp8 and
  the float32 reference, at the program's own recorded inputs of the kept
  steps: the gap by which the precision below the configuration's moves the
  prediction.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from portbench.lib import spec
from portbench.reference import train as ref_train
from portbench.reference import unet as ref_unet
from portbench.reference.precision import F32, FP8, exact_float32


def _as_program(run: dict, expected: list, seen: list):
    """A reference run dressed as what the train driver's wrapper keeps."""
    return types.SimpleNamespace(
        fed=list(expected), losses=run["losses"], grads=run["grads"], seen=seen,
        before={k: b for k, b in enumerate(run["before"]) if k > 0},
        after=(run["params"], run["ema"]))


def train_readings(rec: dict, fault: str | None = None, prec=FP8, from_step: int = 0) -> dict:
    """The train numbers of the reference in the program's place, in
    ``prec`` (the control), or in float32 with ``fault`` planted in every
    step from ``from_step`` on (1: only in the steps that the program runs as
    replays of its captured graph). Where half of a batch is left out, the
    rows it leaves out keep in the recorded predictions what the step before
    left there (zeros before the first), as the program's buffers would."""
    cfg, dev, model, w0 = rec["cfg"], rec["device"], rec["model"], rec["w0"]
    full = [e.to(dev) for e in rec["expected"]]
    x_ts = rec["ref"]["x_t"]
    batches, draws = list(full), list(rec["draws"])
    alter = None
    if fault is not None:
        prec = F32
    if fault == "half_batch":
        for k in range(from_step, len(batches)):
            half = len(batches[k]) // 2
            batches[k] = batches[k][:half]
            draws[k] = (draws[k][0][:half], draws[k][1][:half])
    elif fault == "grad_altered":
        first = next(iter(w0))

        def alter(step, grads):
            if step < from_step:
                return grads
            return {n: g * 2.0 if n == first else g for n, g in grads.items()}
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    with exact_float32():
        run = ref_train.run(w0, model, cfg, batches, draws, prec, alter,
                            start_step=rec["start_step"])
        seen, last = [], None
        for k, x_t in enumerate(x_ts):
            e = ref_train.predict(w0 if k == 0 else run["before"][k], model, x_t,
                                  rec["draws"][k][0], prec)
            if fault == "half_batch" and k >= from_step:
                half = len(e) // 2
                e[half:] = 0.0 if last is None else last[half:]
            seen.append((x_t, e))
            last = e

        def grads_at(k, params):
            return ref_train.grads_at(params, model, cfg, full[k], rec["draws"][k])

        def predict(k, params):
            return ref_train.predict(params, model, x_ts[k], rec["draws"][k][0])

        return spec.driver("train").compare(_as_program(run, rec["expected"], seen), rec["ref"],
                                            w0, rec["expected"], cfg, grads_at, predict)


def sample_readings(rec: dict, prec=FP8) -> dict:
    """``eps_gap`` and ``eps_gap_image`` of the reference in ``prec`` against
    the float32 one at the recorded inputs."""
    plan, model, w0, dev, block = (rec["plan"], rec["model"], rec["w0"], rec["device"],
                                   rec["block"])
    worst = worst_image = 0.0
    with exact_float32(), torch.no_grad():
        for call, (rows, slots, x, e, _) in rec["kept"].items():
            at = {s: i for i, s in enumerate(slots)}
            steps = rec["steps_of"][call]
            xs = torch.cat([x[at[int(plan.ts[j])]] for j in steps])
            ts = torch.as_tensor(np.repeat(plan.ts[steps], len(rows)), device=dev)
            num = den = 0.0
            for i in range(0, len(xs), block):
                exact = ref_unet.forward(w0, model, xs[i:i + block], ts[i:i + block], F32)
                low = ref_unet.forward(w0, model, xs[i:i + block], ts[i:i + block], prec)
                gap = (low - exact).flatten(1).norm(dim=1) / exact.flatten(1).norm(dim=1)
                worst_image = max(worst_image, float(gap.max()))
                num += float((low - exact).double().square().sum())
                den += float(exact.double().square().sum())
            worst = max(worst, (num / den) ** 0.5)
    return {"eps_gap": worst, "eps_gap_image": worst_image}
