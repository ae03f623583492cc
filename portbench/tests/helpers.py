"""A benchmark folder of tiny cells for the CPU tests.

:func:`tiny_bench` copies the drivers and the metric readers into a
temporary folder and adds a configuration of the 8-px UNet (D-2N's model,
or Config A's) at 20 noise steps, three mixes at small batches, and the
limits of the tiny cells, which are the tiny sizes' own: a sound run reads
under them and a broken one over them.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.lib import spec

TINY_LIMITS = {
    "train": {"rows_bad": 0.0, "xt_gap": 1e-5, "pred_gap": 0.05, "grad_gap": 0.2,
              "change_gap": 0.2, "ema_gap": 0.2},
    "sample": {"start_gap": 0.0, "eps_gap": 0.1, "update_gap": 1e-5, "uint8_levels": 0.0,
               "outputs_bad": 0.0},
}


def tiny_bench(tmp: Path, variant: int = 3) -> dict:
    for folder in ("drivers", "metrics"):
        shutil.copytree(spec.BASE / folder, tmp / folder)
    for folder in ("configs", "mixes", "limits"):
        (tmp / folder).mkdir()
    cfg = spec.config("cifar10-D-2N")
    cfg.update(name="tiny", image_size=8, base_width=8, time_dim=32, noise_steps=20,
               variant=variant)
    if variant == 0:
        cfg["filters"] = None
    mixes = {
        "tr": {"driver": "train", "batch": 4, "dataset_size": 18,
               "warmup_epochs": [[0, 1, 2, 3, -1], [0, -1]], "trace_steps": 1,
               "resume_at_ema_start": True, "max_steps_per_s": 200},
        "dp": {"driver": "ddpm", "n": 6,
               "check": {"rows": 6, "steps": 5, "first_calls": 3, "block": 8},
               "trace_from": 2, "trace_steps": 1},
        "di": {"driver": "ddim", "n": 4, "steps": 5, "eta": 0.0,
               "check": {"rows": 4, "steps": 3, "first_calls": 1, "calls": 2, "call_range": 4,
                         "block": 8}},
    }
    (tmp / "configs" / "tiny.json").write_text(json.dumps(cfg))
    for name, mix in mixes.items():
        (tmp / "mixes" / f"{name}.json").write_text(json.dumps(mix))
    bench = spec.load_benchmark()
    bench["workloads"] = [
        {"name": "tiny-train", "config": "tiny", "traffic": "tr", "chips": 1, "why": "test"},
        {"name": "tiny-ddpm", "config": "tiny", "traffic": "dp", "chips": 1, "why": "test"},
        {"name": "tiny-ddim", "config": "tiny", "traffic": "di", "chips": 1, "why": "test"}]
    for kind in ("end_to_end", "per_layer"):
        for metric in bench[kind]:
            metric.pop("workloads", None)
    for cell, kind in (("tiny-train", "train"), ("tiny-ddpm", "sample"),
                       ("tiny-ddim", "sample")):
        limits = {"numbers": {k: {"limit": v} for k, v in TINY_LIMITS[kind].items()}}
        (tmp / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    return bench
