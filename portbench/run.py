#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card this process sees.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell names a configuration and a traffic
mix; the mix names the driver that runs the program under it
(``portbench/lib/spec.py`` says where each part lives). The run warms up
every shape the cell uses (that, with loading and the kernels' build, is
``setup_s``), measures for ``--seconds``, reads the device's memory peak,
frees the program's state, and compares what the timed path produced with
the plain reference (``portbench/reference/``): the numbers and their limits
(``portbench/limits/<workload>.json``) decide ``correct``.

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` a stretch of the window runs under torch.profiler and the
metrics are the cell's per-layer ones, read by ``portbench/metrics/<name>.py``.

Output: the last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, then ``build_s``: the seconds of ``setup_s`` that building
the kernels took, 0 once they are built; ``reported``: numbers of the
comparison that no limit holds, and last ``checks``: each number compared
beside its limit); the last
lines of standard error give the same numbers and limits. Progress,
the kernels' launch counts and the implementation choices go to standard
error before them.

Exit codes: 0 with a result; 2 without a CUDA card, or with fewer cards than
the cell asks for; 3 when a module of JAX, Flax or the JAX package was loaded
by the end of the run; any other failure raises. Build and kernel caches stay
inside the checkout (``build/``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Top-level module names that no run may load: compared whole, since the
# port's own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "aliasfree_diffusion_models_pytorch_tpu")
CACHE = ROOT / "build" / "portbench_cache"


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's own kernels build into ``build/torch_kernels``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def _build_kernels() -> float:
    """Builds every kernel of the program that is not built yet in the
    checkout (the first run there: ``nvcc``), and returns the seconds it
    took, which are part of ``setup_s`` and are logged on their own line."""
    from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels

    from portbench.lib.cell import log

    t0 = time.perf_counter()
    built = [r.name for r in kernels.build() if r.log != "already built"]
    seconds = time.perf_counter() - t0
    log(f"build_s {seconds:.2f}: " + (f"built {built}" if built else "every kernel already built"))
    return seconds


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, bench: dict | None = None,
             base: Path | None = None, t_start: float | None = None,
             records: dict | None = None) -> dict:
    """One run of workload ``name``; returns the result object. ``records``,
    when given, receives what the comparison read (for the control)."""
    import torch

    from portbench.lib import spec
    from portbench.lib.cell import Cell, evaluate, log

    base = base or spec.BASE
    bench = bench or spec.load_benchmark()
    w = spec.workload(bench, name)
    device = torch.device(device)
    cell = Cell(name=name, cfg=spec.config(w["config"], base), mix=spec.mix(w["traffic"], base),
                limits=spec.limits(name, base), seed=int(seed), seconds=float(seconds),
                trace=bool(trace), device=device,
                t_start=T_START if t_start is None else t_start,
                workdir=ROOT / "build" / "portbench" / name)
    log(f"{name}: config {w['config']}, traffic {w['traffic']}, driver {cell.mix['driver']}, "
        f"seed {seed}, {seconds} s, trace {int(trace)}")
    build_s = _build_kernels() if device.type == "cuda" else None
    out = spec.driver(cell.mix["driver"], base).run(cell)
    if records is not None:
        records.update(out["records"])
    correct, checks, reported = evaluate(out["numbers"], cell.limits)
    metrics = {}
    if not trace:
        for m in spec.cell_metrics(bench, name, "end_to_end"):
            value = out["end_to_end"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.cell_metrics(bench, name, "per_layer"):
            value = spec.metric(m["name"], base).read(out["facts"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = device.type == "cuda"
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": w["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": info}
    if trace:
        summary = out["facts"].trace
        if summary is None:
            raise RuntimeError("no traced stretch held the kernels it ran")
        info["busy_s"], info["window_s"] = summary.busy_s, summary.window_s
        result["breakdown"] = summary.breakdown()
    result["build_s"] = build_s
    result["reported"] = reported
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _fixed_caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.lib import spec
    from portbench.lib.cell import log

    bench = spec.load_benchmark()
    chips = spec.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s): torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", bench)
    bad = forbidden_modules()
    if bad:
        log(f"modules loaded that no run may load: {bad}")
        return 3
    for name, value in result["reported"].items():
        print(f"reported, not compared: {name}: {value!r}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
