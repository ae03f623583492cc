"""CUDA graphs for the port's step loops: its counterpart of the JAX
package's compiled sampler scan and jitted train step.

A :class:`GraphedStep` runs one step, its :meth:`~GraphedStep.step` method,
which a subclass defines and which reads and writes only buffers that the
object holds (the static buffers), so that the same launches with the same
pointers do the same work on every call. On the card:

* the first call of a variant runs the step eagerly on a side stream: the
  warm-up that PyTorch asks for before a capture. Libraries are loaded, the
  kernels' shared-memory limits raised, cuBLAS' workspaces and cuDNN's
  algorithms settled, and the optimizer's state made there. It is a real step
  and its launches count as such;
* the second call captures the variant into a ``torch.cuda.CUDAGraph`` and
  replays it, and every later call replays it. A capture or replay that
  fails raises: nothing falls back to the eager step.

``variant`` names a branch that the host chooses between calls (a DDPM step
with or without noise, an accumulating or an updating train step): one graph
each. A branch that a loop takes once (the DDPM sampler's last step, which
draws no noise) is run by calling :meth:`~GraphedStep.step` directly: a
capture (a device synchronisation, a fresh memory pool, the graph's
instantiation) costs more than one replay saves. With ``graphs=False``, or on
the CPU, every call runs the step eagerly: the same function, without
capture.

Launch counts. The kernel wrappers count their launches in Python
(``utils/kernels.py:COUNTED``). A capture runs the wrappers once and launches
nothing, so the counts the capture added are taken back and added again on
every replay: a count reads the launches the card made.

Tracing (``utils/spans.py``). While a torch.profiler session records, the
warm-up and the capture run in the spans ``graph.warmup`` and
``graph.capture`` (a capture in the middle of a run is a stall), and each
replay counts ``graph.lead``: the earlier replays the card had not finished
when the host launched it.

Randomness. The step draws from :attr:`GraphedStep.generator`, which every
graph registers (``CUDAGraph.register_generator_state``): a replay advances
its Philox offset as an eager step does. :meth:`GraphedStep.drawing_from`
hands it the caller's generator state for a run of steps and gives the state
back at the end, so the caller's generator moves as if it had drawn the
steps' noise itself.
"""

from __future__ import annotations

import contextlib
from typing import Hashable

import torch

from aliasfree_diffusion_models_pytorch_tpu_torch.utils import kernels, spans

_WARMUP = spans.Span("graph.warmup")
_CAPTURE = spans.Span("graph.capture")


def default_generator(device: torch.device) -> torch.Generator:
    """The generator that a draw without one uses on ``device``."""
    if device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        return torch.cuda.default_generators[index]
    return torch.default_generator


class GraphedStep:
    """:meth:`step` run eagerly, then as one CUDA graph per variant (see the
    module docstring). ``graphs`` is ignored off the card."""

    def __init__(self, device, graphs: bool = True):
        self.device = torch.device(device)
        self.graphs = bool(graphs) and self.device.type == "cuda"
        self.generator = torch.Generator(device=self.device)
        self._warm: set = set()
        # variant -> (graph, launches per replay of each wrapper in kernels.COUNTED)
        self._captured: dict = {}

    def step(self, variant: Hashable) -> None:
        """One step on the static buffers: the subclass's."""
        raise NotImplementedError

    @property
    def captured(self) -> tuple:
        """The variants that run as graphs."""
        return tuple(self._captured)

    @contextlib.contextmanager
    def drawing_from(self, generator: torch.Generator | None):
        """Steps inside the block draw on from ``generator``'s state (the
        device's default generator for None), which then takes the state the
        steps left."""
        caller = generator if generator is not None else default_generator(self.device)
        self.generator.set_state(caller.get_state())
        try:
            yield
        finally:
            caller.set_state(self.generator.get_state())

    def __call__(self, variant: Hashable = None) -> None:
        if not self.graphs:
            self.step(variant)
        elif variant in self._captured:
            self._replay(variant)
        elif variant in self._warm:
            with _CAPTURE:
                self._captured[variant] = self._capture(variant)
            self._replay(variant)
        else:
            with _WARMUP:
                self._warm_up(variant)

    def _warm_up(self, variant) -> None:
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self.step(variant)
        stream.wait_stream(side)
        self._warm.add(variant)

    def _capture(self, variant):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = [wrapper.launches for wrapper in kernels.COUNTED]
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(graph):
                self.step(variant)
            per_replay = [w.launches - b for w, b in zip(kernels.COUNTED, before)]
        finally:
            for wrapper, count in zip(kernels.COUNTED, before):
                wrapper.launches = count  # the capture launched nothing
        return graph, per_replay

    def _replay(self, variant) -> None:
        graph, per_replay = self._captured[variant]
        ring = spans.count_lead()
        graph.replay()
        if ring is not None:
            ring.launched_one()
        for wrapper, count in zip(kernels.COUNTED, per_replay):
            wrapper.launches += count
