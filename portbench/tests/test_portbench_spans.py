"""The readers of the program's spans and counters: ``batch_wait_ms.train``,
``host_ahead.train`` and ``host_ahead.sample`` read the program's latest
profiler session (``utils/spans.py``) only in a traced run of their kind,
and read nothing from a program without the spans."""

from __future__ import annotations

import builtins
import types

import pytest

from aliasfree_diffusion_models_pytorch_tpu_torch.utils import spans
from portbench.lib import spec

TRACE = object()  # any trace summary: the readers only test that one exists


def _facts(kind: str, trace=TRACE):
    return types.SimpleNamespace(kind=kind, trace=trace)


@pytest.fixture
def session(monkeypatch):
    session = spans.Session()
    session.stale = False
    monkeypatch.setattr(spans, "SESSION", session)
    return session


def test_batch_wait_reads_the_median_train_batch_span(session):
    ms = 1_000_000  # ns
    session.spans = [["train.batch", 0, 2 * ms, -1], ["train.step", 2 * ms, 30 * ms, -1],
                     ["train.batch", 30 * ms, 30 * ms + ms // 10, -1],
                     ["train.batch", 40 * ms, 40 * ms + ms // 5, -1],
                     ["train.batch", 50 * ms, None, -1]]  # still open: left out
    read = spec.metric("batch_wait_ms.train").read
    assert read(_facts("train")) == pytest.approx(0.2)
    assert read(_facts("train", trace=None)) is None
    assert read(_facts("sample")) is None
    session.spans = []
    assert read(_facts("train")) is None


@pytest.mark.parametrize("name, kind", [("host_ahead.train", "train"),
                                        ("host_ahead.sample", "sample")])
def test_host_ahead_leaves_out_the_first_launch(session, name, kind):
    read = spec.metric(name).read
    session.counters["graph.lead"] = [0, 1, 2, 0, 3]  # the first follows the tracer's sync
    assert read(_facts(kind)) == pytest.approx(75.0)
    session.counters["graph.lead"] = [0, 0]
    assert read(_facts(kind)) == 0.0
    session.counters["graph.lead"] = [5, 1]
    assert read(_facts(kind)) == 100.0
    assert read(_facts(kind, trace=None)) is None
    assert read(_facts("train" if kind == "sample" else "sample")) is None
    session.counters["graph.lead"] = [0]
    assert read(_facts(kind)) is None
    session.counters = {}
    assert read(_facts(kind)) is None


@pytest.mark.parametrize("name", ["batch_wait_ms.train", "host_ahead.train",
                                  "host_ahead.sample"])
def test_a_program_without_spans_reads_nothing(monkeypatch, name):
    real_import = builtins.__import__

    def no_spans(module, globals=None, locals=None, fromlist=(), level=0):
        if module.endswith(".utils") and "spans" in (fromlist or ()):
            raise ImportError("cannot import name 'spans'")
        return real_import(module, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_spans)
    kind = "sample" if name.endswith(".sample") else "train"
    assert spec.metric(name).read(_facts(kind)) is None
