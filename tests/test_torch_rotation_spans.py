"""The rotation's span and counter (``ops/rotation.py:build_rotation``,
``utils/spans.py``): ``rotation.build`` around each build of the per-step
rotation operand, ``rotation.built`` 1 when it was built and 0 when a cache
served it, recorded only while a torch.profiler session records; and their
reader, ``portbench/metrics/rot_build_ms.sample.py``.

On the CPU at 8 px, with a stand-in model that predicts zeros and 5 noise
steps. Every test takes an angle that no other test in the process builds,
so that the operators' caches hold it only where the test put it there.
"""

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aliasfree_diffusion_models_pytorch_tpu_torch.diffusion import Diffusion
from aliasfree_diffusion_models_pytorch_tpu_torch.ops import rotation
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import spans
from portbench.lib import spec

SIZE = 8


def _zeros(x, t):
    return torch.zeros_like(x)


def _diffusion() -> Diffusion:
    return Diffusion(noise_steps=5, img_size=SIZE, device="cpu")


def _off():
    """A site that finds no session: the next one to find a session starts
    the record afresh."""
    with spans.Span("test.off"):
        pass


def _builds(session) -> list:
    return [name for name, *_ in session.spans if name == "rotation.build"]


def test_no_session_records_nothing(monkeypatch):
    monkeypatch.setattr(spans, "SESSION", spans.Session())
    _diffusion().sample(_zeros, n=2, image_channels=1, theta=41.0173)
    _diffusion().sample_ddim(_zeros, n=2, image_channels=1, steps=3, theta=41.0173)
    assert spans.SESSION.spans == [] and spans.SESSION.counters == {}


def test_sample_records_a_build_then_a_cache_hit():
    _off()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _diffusion().sample(_zeros, n=2, image_channels=1, theta=37.3911)
    session = spans.SESSION
    assert _builds(session) == ["rotation.build"]
    assert session.counters["rotation.built"] == [1]
    (name, start, end, parent), = [s for s in session.spans if s[0] == "rotation.build"]
    assert end >= start and parent == -1
    assert "rotation.build" in {e.name for e in prof.events()}
    _off()
    with profile(activities=[ProfilerActivity.CPU]):
        _diffusion().sample(_zeros, n=2, image_channels=1, theta=37.3911)  # the same angle
    assert _builds(spans.SESSION) == ["rotation.build"]
    assert spans.SESSION.counters["rotation.built"] == [0]


def test_sample_ddim_records_its_build():
    _off()
    with profile(activities=[ProfilerActivity.CPU]):
        _diffusion().sample_ddim(_zeros, n=2, image_channels=1, steps=3, theta=-53.2207)
        _diffusion().sample_ddim(_zeros, n=2, image_channels=1, steps=3, theta=-53.2207)
    assert _builds(spans.SESSION) == ["rotation.build"] * 2
    assert spans.SESSION.counters["rotation.built"] == [1, 0]


@pytest.mark.parametrize("size", [SIZE, 72])  # the dense operator; the gather plan above 64
def test_build_rotation_counts_either_operand(size):
    _off()
    with profile(activities=[ProfilerActivity.CPU]):
        first = rotation.build_rotation(size, 0.0611 + size, 3, "cpu")
        again = rotation.build_rotation(size, 0.0611 + size, 3, "cpu")
    assert isinstance(first, torch.Tensor) == (size <= 64)
    assert _builds(spans.SESSION) == ["rotation.build"] * 2
    assert spans.SESSION.counters["rotation.built"] == [1, 0]
    assert type(first) is type(again)


def _facts(kind="sample", trace=object()):
    return types.SimpleNamespace(kind=kind, trace=trace)


def test_reader_takes_the_median_of_the_builds(monkeypatch):
    session = spans.Session()
    session.stale = False
    monkeypatch.setattr(spans, "SESSION", session)
    ms = 1_000_000  # ns
    session.spans = [["rotation.build", 0, 230 * ms, -1], ["rotation.build", 300 * ms, 301 * ms, -1],
                     ["rotation.build", 400 * ms, 650 * ms, -1]]
    session.counters["rotation.built"] = [1, 0, 1]
    read = spec.metric("rot_build_ms.sample").read
    assert read(_facts()) == pytest.approx(240.0)  # the cache hit left out
    assert read(_facts(trace=None)) is None
    assert read(_facts(kind="train")) is None
    session.counters["rotation.built"] = [0, 0, 0]
    assert read(_facts()) is None


def test_reader_returns_none_without_the_span(monkeypatch):
    session = spans.Session()
    session.stale = False
    monkeypatch.setattr(spans, "SESSION", session)
    session.counters["graph.lead"] = [0, 1]  # a traced DDPM stretch with no rotation
    assert spec.metric("rot_build_ms.sample").read(_facts()) is None
