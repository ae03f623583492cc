#!/usr/bin/env python3
"""Readings from which a cell's limits are set, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 11,12,... \
        [--controls 3] [--seconds 3] [--out <file.jsonl>]

runs the cell once for each seed (a short window: the numbers compared do not
depend on its length), then, on the first ``--controls`` seeds, the control
(the reference in fp8 in the program's place) and, in a train cell, the
planted faults, in every step and only in the replayed ones
(:mod:`portbench.lib.control`). One JSON line a reading:
``{"seed", "kind": "program" | "control" | fault name, "numbers", "correct"}``.
The benchmark's own runs never run this; ``PERF.md`` gives the readings each
limit was set from.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


# The planted faults read in a train cell: (fault, the first step it is planted in).
FAULTS = (("half_batch", 0), ("grad_altered", 0), ("half_batch", 1), ("grad_altered", 1))


def readings(workload: str, seed: int, seconds: float, device, controls: bool = True) -> list:
    """One run of the cell, then (with ``controls``) the control's and, in a
    train cell, each planted fault's readings from what that run compared:
    ``[{"seed", "kind", "numbers", ...}, ...]``, the program's first."""
    import torch

    from portbench import run as bench_run
    from portbench.lib import control

    records: dict = {}
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    result = bench_run.run_cell(workload, seed, seconds, False, device,
                                t_start=time.perf_counter(), records=records)
    lines = [{"seed": seed, "kind": "program", "correct": result["correct"],
              "numbers": {**result["reported"],
                          **{k: v["value"] for k, v in result["checks"].items()}},
              "metrics": {k: v["value"] for k, v in result["metrics"].items()}}]
    if controls and records["kind"] == "train":
        lines.append({"seed": seed, "kind": "control",
                      "numbers": control.train_readings(records)})
        for fault, first in FAULTS:
            lines.append({"seed": seed, "kind": fault + ("@replays" if first else ""),
                          "numbers": control.train_readings(records, fault, from_step=first)})
    elif controls:
        lines.append({"seed": seed, "kind": "control",
                      "numbers": control.sample_readings(records)})
    del records
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run as bench_run

    bench_run._fixed_caches()
    import torch

    from portbench.lib.cell import log

    if not torch.cuda.is_available():
        log("calibrate needs a CUDA card")
        return 2
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for line in readings(args.workload, seed, args.seconds, "cuda:0", i < args.controls):
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
