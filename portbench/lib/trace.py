"""A traced stretch of the window: torch.profiler over a few steps or calls.

:class:`Tracer` starts the profiler after a device synchronisation and stops
it after another, so that the stretch holds whole steps; its host seconds
are ``window_s``. From the device events (kernels and copies, without the
user annotations that show on the device timeline) it takes the busy time
(the union of their intervals), each kernel's summed time, and the idle gaps
between them, each named by the innermost host operation running at the
gap's middle. A trace now and then comes back without device events, or
short of the kernels the stretch ran (``chip_smoke.py``'s ``device_events``
saw both); such a stretch is discarded and the next one traced instead, up to
six times.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

import torch

TRIES = 6
TOP = 10


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    units: int  # train steps, or model forwards, that the stretch held
    kernel_s: dict  # kernel name -> summed seconds
    kernel_n: dict  # kernel name -> events
    gaps: dict  # host operation -> summed idle seconds

    def time_of(self, *parts: str) -> float:
        """Summed seconds of the kernels whose name holds one of ``parts``."""
        return sum(s for name, s in self.kernel_s.items() if any(p in name for p in parts))

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


def summarise(prof, window_s: float, units: int) -> Summary:
    dev, host = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append((tr.start, tr.end, e.name))
    kernel_s, kernel_n = {}, {}
    for start, end, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (end - start) * 1e-6
        kernel_n[name] = kernel_n.get(name, 0) + 1
    merged = []
    for start, end, _ in sorted(dev):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy = sum(end - start for start, end in merged) * 1e-6
    host.sort()
    starts = [h[0] for h in host]
    gaps: dict = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        label, width = "no host operation", None
        last = bisect.bisect_right(starts, mid)
        for s, e, name in (host[i] for i in range(max(0, last - 256), last)):
            if mid <= e and (width is None or e - s < width):
                label, width = name, e - s
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    return Summary(window_s=window_s, busy_s=busy, units=units, kernel_s=kernel_s,
                   kernel_n=kernel_n, gaps=gaps)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Tracer:
    """Traces a stretch of steps or calls: :meth:`begin` before the first of
    them and :meth:`end` after the last, with the model forwards (train: the
    steps) the stretch held. ``launches()`` counts the program's kernel
    launches so far: a trace that holds fewer device events than the stretch
    launched is short."""

    def __init__(self, launches, log):
        self.launches, self.log = launches, log
        self.tries, self.summary, self._prof, self._t0, self._n0 = 0, None, None, 0.0, 0

    @property
    def active(self) -> bool:
        return self._prof is not None

    @property
    def done(self) -> bool:
        return self.summary is not None or self.tries >= TRIES

    def begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        _sync()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._n0 = sum(self.launches().values())
        self._t0 = time.perf_counter()

    def end(self, units: int) -> None:
        _sync()
        window = time.perf_counter() - self._t0
        self._prof.stop()
        launched = sum(self.launches().values()) - self._n0
        summary = summarise(self._prof, window, units)
        self._prof = None
        self.tries += 1
        if units > 0 and sum(summary.kernel_n.values()) >= max(1, launched):
            self.summary = summary
        else:
            self.log(f"trace {self.tries}: {sum(summary.kernel_n.values())} device events, "
                     "short of the stretch's kernels; tracing the next stretch")
