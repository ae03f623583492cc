"""One run of one cell: what a driver is given, and how its numbers become
``correct``.

A driver's ``run(cell)`` returns a dict:

* ``attempted``, ``failed``: steps or requests of the window, and those that
  raised or returned nothing;
* ``end_to_end``: {metric name: value} of every end-to-end metric it measures;
* ``facts``: what the per-layer readers read (:class:`Facts`);
* ``numbers``: {name: value} of the comparison with the reference;
* ``memory_peak_bytes``, read once the window has closed.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from pathlib import Path

import torch


def log(msg: str) -> None:
    print(f"[portbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # host clock at the start of the process
    workdir: Path  # the run's own directory inside the checkout


@dataclasses.dataclass
class Facts:
    """What a per-layer metric's reader reads."""

    kind: str  # "train" or "sample"
    model: object  # portbench.reference.unet.Model
    batch: int  # rows of one step or one forward
    window_s: float
    images: int  # images trained, or returned, in the window
    forwards_per_image: int  # model evaluations an image: 1 a train step, the steps a sample
    flops_fwd: int  # model FLOPs of one forward of one image
    flops_train: int  # of one forward and backward
    peak_flops: float | None  # the card's dense bf16 peak
    trace: object = None  # portbench.lib.trace.Summary of the traced stretch
    data_ms: list = dataclasses.field(default_factory=list)


def evaluate(numbers: dict, limits: dict) -> tuple[bool, dict, dict]:
    """``correct``, the checks {name: {"value", "limit"}} and the numbers
    reported without a limit. ``correct`` needs every number that the cell's
    limits name present, finite and at most its limit, and at least one such
    number; a number they do not name is reported, not compared."""
    table = limits.get("numbers", {})
    checks = {name: {"value": numbers.get(name), "limit": entry["limit"]}
              for name, entry in sorted(table.items())}
    ok = bool(checks) and all(
        c["value"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    reported = {k: v for k, v in sorted(numbers.items()) if k not in table}
    return ok, checks, reported
