"""The port's spans and counters, live only while a torch.profiler session
records.

A session is the time between a ``torch.profiler`` start and its stop: the
window of ``train(profile_dir=)``, a traced stretch of the benchmark, any
session an operator opens. Every site tests one module bool that PyTorch
keeps (``torch.autograd.profiler._is_profiler_enabled``). Off, that test is
all a site does, besides noting that it found no session: no allocation, no
clock read, no CUDA call. No setting turns the spans on or off.

Spans. ``with SPAN:`` on a :class:`Span` made once at import enters
``torch.profiler.record_function(name)``, so the span lies on the
profiler's clock beside the kernels in its trace, and appends
``[name, start_ns, end_ns, parent]`` to :data:`SESSION` (``time.perf_counter_ns``;
``parent`` is the index of the enclosing span, -1 for none). A span whose
start found no session is not recorded, even if a session starts before it
ends; one whose start found a session is ended in the record even if the
session stops first. A span must not be entered again inside itself.

Counters. ``SESSION.counters[name]`` lists the values counted in the
session, in order. ``graph.lead`` (:func:`count_lead`, counted by
``utils/graphs.py:GraphedStep`` before each graph replay): how many earlier
replays the card had not finished when the host launched this one. 0 means
the card had finished every launched replay and waited for this launch.

The record holds the latest session only: the first site that finds a
session after a site found none starts it afresh. The profiler is one per
process, so the record is too; its sites run on the thread that steps.

Readers: ``portbench/metrics/batch_wait_ms.train.py`` (``train.batch``),
``host_ahead.train.py`` and ``host_ahead.sample.py`` (``graph.lead``).
"""

from __future__ import annotations

import time

import torch
from torch.autograd import profiler as _profiler

RING = 64  # completion events of the latest replays; a lead reads at most this


class Session:
    """What the latest profiler session recorded (see the module docstring)."""

    def __init__(self):
        self.spans: list[list] = []  # [name, start_ns, end_ns or None while open, parent]
        self.counters: dict[str, list[int]] = {}
        self.open: list[tuple] = []  # (Span, its index in spans, its record_function)
        self.stale = True  # a site found no session: the next one to find one starts afresh

    def start(self) -> None:
        """Enter a session: the first site that finds one clears the record."""
        if self.stale:
            self.spans, self.counters, self.open, self.stale = [], {}, [], False

    def durations(self, name: str) -> list[float]:
        """Seconds of each ended span ``name``, in order."""
        return [(end - start) * 1e-9 for n, start, end, _ in self.spans
                if n == name and end is not None]


SESSION = Session()


class Span:
    """A named span, made once and entered with ``with`` (module docstring)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        if not _profiler._is_profiler_enabled:
            SESSION.stale = True
            return
        SESSION.start()
        parent = SESSION.open[-1][1] if SESSION.open else -1
        annotation = _profiler.record_function(self.name)
        annotation.__enter__()
        SESSION.spans.append([self.name, time.perf_counter_ns(), None, parent])
        SESSION.open.append((self, len(SESSION.spans) - 1, annotation))

    def __exit__(self, *exc) -> None:
        if SESSION.open and SESSION.open[-1][0] is self:
            _, index, annotation = SESSION.open.pop()
            SESSION.spans[index][2] = time.perf_counter_ns()
            annotation.__exit__(None, None, None)


class LeadRing:
    """Completion events of the latest graph replays on one device's current
    stream, made at the first count. The replays finish in the order they
    were launched on it: the unfinished ones are the newest."""

    def __init__(self):
        self.events: list[torch.cuda.Event] = []
        self.launched = self.finished = 0

    def pending(self) -> int:
        """Replays launched whose event has not fired (``query`` does not block)."""
        while self.finished < self.launched and self.events[self.finished % RING].query():
            self.finished += 1
        return self.launched - self.finished

    def launched_one(self) -> None:
        """Record the event that fires once the replay just launched finishes."""
        if not self.events:
            self.events = [torch.cuda.Event() for _ in range(RING)]
        if self.launched - self.finished == RING:
            self.finished += 1  # the oldest event's slot is taken over: a lead reads RING at most
        self.events[self.launched % RING].record()
        self.launched += 1


_RINGS: dict[int, LeadRing] = {}  # CUDA device index -> its ring


def count_lead() -> LeadRing | None:
    """Before a graph replay on the current device: under a session and
    outside a capture, count ``graph.lead`` and return the ring, whose
    :meth:`~LeadRing.launched_one` the caller calls after the replay; else None."""
    if not _profiler._is_profiler_enabled:
        SESSION.stale = True
        return None
    if torch.cuda.is_current_stream_capturing():
        return None
    SESSION.start()
    device = torch.cuda.current_device()
    ring = _RINGS.get(device)
    if ring is None:
        ring = _RINGS[device] = LeadRing()
    SESSION.counters.setdefault("graph.lead", []).append(ring.pending())
    return ring
