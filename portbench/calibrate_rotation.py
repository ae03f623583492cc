#!/usr/bin/env python3
"""Readings from which a Config-E cell's limits are set, in one process.

    python3 portbench/calibrate_rotation.py --workload rotate-D2N-n16 \
        --seeds 11,12,... [--controls 3] [--seconds 3] [--out <file.jsonl>]

``portbench/calibrate.py`` reads the program and the fp8 control of
``eps_gap``, and leaves the rotation alone. This adds, on the first
``--controls`` seeds, the controls of ``update_gap`` and ``uint8_levels``:
the reference's rotation computed in a precision below the float32 that the
configuration rotates in, at the program's own recorded steps, against the
float64 reference (:func:`rotation_readings`): ``rotation_tf32`` rounds the
operands of its product to TF32 (10 bits of mantissa, what a float32 product
with ``allow_tf32`` takes), ``rotation_bf16`` to bfloat16 and holds its result
in bfloat16. One JSON line a reading, as ``calibrate.py`` writes them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def tf32(x):
    """``x`` rounded to TF32 (to nearest, ties away from zero), in its dtype."""
    import torch

    bits = x.float().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).to(x.dtype)


def bf16(x):
    import torch

    return x.to(torch.bfloat16).to(x.dtype)


PRECISIONS = {"rotation_tf32": (tf32, False), "rotation_bf16": (bf16, True)}


def rotation_readings(rec: dict, kind: str) -> dict:
    """``update_gap`` and ``uint8_levels`` of the reference's rotation in the
    precision ``kind`` (:data:`PRECISIONS`) against the float64 one, after
    the reference's update at the program's recorded steps of each kept
    call (``drivers/rotate.py``'s records)."""
    import numpy as np
    import torch

    from portbench.lib import sampling, seeds
    from portbench.reference import rotation as ref_rotation
    from portbench.reference.diffusion import to_uint8
    from portbench.reference.precision import exact_float32

    operand, round_result = PRECISIONS[kind]
    plan, dev, shape = rec["plan"], rec["device"], rec["shape"]
    upd = levels = 0.0
    with exact_float32(), torch.no_grad():
        for call, (rows, slots, x, e, _) in rec["kept"].items():
            at = {s: i for i, s in enumerate(slots)}
            steps = rec["steps_of"][call]
            degrees = rec["thetas"][call] / plan.schedule.noise_steps
            need = {0} | {plan.noise_of_step(j) for j in steps} - {None}
            z = sampling._noise(seeds.derive(rec["seed"], "noise0"), dev, shape, need)
            r = torch.as_tensor(rows, device=dev)
            for j in steps:
                d = plan.noise_of_step(j)
                nxt = sampling.Plan.update(plan, x[at[int(plan.ts[j])]], e[at[int(plan.ts[j])]],
                                           np.full(len(rows), j),
                                           None if d is None else z[d].index_select(0, r))
                exact = ref_rotation.rotate(nxt, degrees)
                low = ref_rotation.rotate(operand(nxt.double()), degrees, operand)
                if round_result:
                    low = operand(low)
                scale = exact.flatten(1).abs().max(dim=1).values.clamp(min=1e-30)
                rel = (low - exact).flatten(1).abs().max(dim=1).values / scale
                upd = max(upd, float(rel.max()))
                if j == len(plan.ts) - 1:
                    diff = to_uint8(low).int() - to_uint8(exact).int()
                    levels = max(levels, float(diff.abs().max()))
    return {"update_gap": upd, "uint8_levels": levels}


def readings(workload: str, seed: int, seconds: float, device, controls: bool = True) -> list:
    """One run of the cell and, with ``controls``, the fp8 control of
    ``eps_gap`` and the rotation's controls, from what that run compared."""
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
    if controls:
        lines.append({"seed": seed, "kind": "control",
                      "numbers": control.sample_readings(records)})
        for kind in PRECISIONS:
            lines.append({"seed": seed, "kind": kind,
                          "numbers": rotation_readings(records, kind)})
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
    from portbench.lib.cell import log

    bench_run._fixed_caches()
    import torch

    if not torch.cuda.is_available():
        log("calibrate_rotation needs a CUDA card")
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            for line in readings(args.workload, seed, args.seconds, "cuda:0", i < args.controls):
                text = json.dumps(line)
                print(text, flush=True)
                if out:
                    out.write(text + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
