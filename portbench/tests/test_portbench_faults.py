"""A run with the timed path broken underneath comes out not ``correct``.

Each test drives the rest of a run (``run.run_cell``) of a tiny cell on the
CPU, past the harness's look for a card, with one fault planted in the
program: a step that returns its state unchanged; half of the batch left
out, the mean taken over the rest; an answer altered where it is produced;
in a train cell also half of the batch and a gradient altered only in the
steps that replay the captured graph.
No cell runs on more than one chip, so none has an exchange between chips to
leave out. The sound run of the same cell comes out ``correct``.
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench import run as bench_run
from portbench.tests.helpers import tiny_bench


@pytest.fixture()
def tiny(tmp_path):
    bench = tiny_bench(tmp_path)

    def run(cell: str) -> dict:
        return bench_run.run_cell(cell, 2**31 + 77, 0.3, False, "cpu", bench=bench,
                                  base=tmp_path, t_start=time.perf_counter())
    return run


def _train_fault(fault: str):
    """The program's train step with ``fault`` planted: in every call, or,
    for the ``…_replays`` faults, from the second call on, as a fault in the
    captured graph alone would act (the first call runs the step eagerly,
    later calls replay the graph)."""
    from aliasfree_diffusion_models_pytorch_tpu_torch import train as program_train

    real_make = program_train.make_train_step

    def make(model, *args, **kwargs):
        real = real_make(model, *args, **kwargs)
        calls = [0]

        def step(state, batch, *a, **k):
            calls[0] += 1
            late = calls[0] > 1
            if fault == "unchanged":
                return state, torch.ones(())
            if fault == "half_batch" or (fault == "half_batch_replays" and late):
                return real(state, batch[: len(batch) // 2], *a, **k)
            if fault == "grad_altered_replays" and calls[0] == 2:
                # the first parameter's gradient doubled where it is made
                next(model.parameters()).register_hook(lambda g: g * 2.0)
            if fault != "altered":
                return real(state, batch, *a, **k)
            # the answer altered: the first parameter's update doubled
            first = next(iter(state.params.values()))
            before = first.clone()
            state, loss = real(state, batch, *a, **k)
            with torch.no_grad():
                first.add_(first - before)
            return state, loss
        return step
    return make


def _sampler_fault(fault: str, monkeypatch):
    from aliasfree_diffusion_models_pytorch_tpu_torch import diffusion

    if fault == "altered":
        real = diffusion.Diffusion.to_uint8

        def to_uint8(x):
            out = real(x)
            out[0, 0, 0, 0] += 64
            return out
        monkeypatch.setattr(diffusion.Diffusion, "to_uint8", staticmethod(to_uint8))
        return

    def finish(self, x):
        if fault == "half_batch":
            half = x.shape[0] // 2
            self.x[:half].copy_(x[:half])
        # "unchanged": the state is left as it was

    monkeypatch.setattr(diffusion._Sampler, "_finish", finish)


def test_sound_train_run_is_correct(tiny):
    assert tiny("tiny-train")["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "half_batch_replays",
                                   "grad_altered_replays"])
def test_broken_train_step_is_not_correct(tiny, fault, monkeypatch):
    from aliasfree_diffusion_models_pytorch_tpu_torch import train as program_train

    monkeypatch.setattr(program_train, "make_train_step", _train_fault(fault))
    result = tiny("tiny-train")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", ["tiny-ddpm", "tiny-ddim"])
def test_sound_sampling_run_is_correct(tiny, cell):
    assert tiny(cell)["correct"]


@pytest.mark.parametrize("cell", ["tiny-ddpm", "tiny-ddim"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_broken_sampler_is_not_correct(tiny, cell, fault, monkeypatch):
    _sampler_fault(fault, monkeypatch)
    result = tiny(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-ddpm"])
def test_a_traced_run_without_device_events_fails(tmp_path, cell):
    """The CPU gives the profiler no device events: every traced stretch is
    short, six are tried after the window, and the run raises rather than
    print per-layer metrics without a trace."""
    bench = tiny_bench(tmp_path)
    with pytest.raises(RuntimeError, match="no traced stretch"):
        bench_run.run_cell(cell, 5, 0.2, True, "cpu", bench=bench, base=tmp_path,
                           t_start=time.perf_counter())
