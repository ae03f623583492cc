"""The port's spans and counters (``utils/spans.py``): recorded only while a
torch.profiler session records, the latest session only.

On the CPU at a tiny size (Config A, image 8, base width 8, 12 rows at batch
4: three steps an epoch, two epochs, a log point every second step):

* with no profiler, ``train`` leaves the session empty and the log's
  ``device_ms_per_step`` null;
* under ``torch.profiler.profile(activities=[CPU])`` the session holds
  ``train.batch``, ``train.step``, ``train.log`` and ``train.epoch_end``,
  each ended, with a valid parent and a duration of at least 0, and the
  profiler's events hold the same names;
* two sessions with untraced steps between them: only the second's records
  remain;
* ``train(profile_dir=..., profile_steps=(0, 3))`` at two steps an epoch
  writes a Chrome trace that holds the span names;
* the lead's bookkeeping (:class:`spans.LeadRing`) with stand-in events whose
  ``query()`` is scripted: 0, 1 and 2 replays pending, events taken over
  past ``RING``, a count off a session and under a capture;
* on a card (``cuda``-marked), ``graph.lead`` on real replays of a graphed
  step.
"""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aliasfree_diffusion_models_pytorch_tpu_torch import train as ttrain
from aliasfree_diffusion_models_pytorch_tpu_torch.config import TrainConfig
from aliasfree_diffusion_models_pytorch_tpu_torch.data import Dataloader, synthetic_dataset
from aliasfree_diffusion_models_pytorch_tpu_torch.utils import graphs, spans

TRAIN_SPANS = ("train.batch", "train.step", "train.log", "train.epoch_end")
CONFIG = dict(run_name="spans", epochs=2, batch_size=4, image_size=8, base_width=8,
              image_channels=1, noise_steps=10, variant=0, seed=0, time_dim=32, image_gen_n=1)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several worker processes run the suite at once; two threads each keep
    their OpenMP barriers from spinning against each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _loader(rows: int = 12):
    return Dataloader(synthetic_dataset(n=rows, image_size=8, channels=1, seed=5), batch_size=4,
                      seed=0)


def _train(root, rows: int = 12, **kw):
    kw.setdefault("sample_each_epoch", False)
    kw.setdefault("checkpoint_each_epoch", False)
    return ttrain.train(TrainConfig(**CONFIG), _loader(rows), root=str(root), device="cpu",
                        log_every=2, **kw)


def _names(session) -> set:
    return {name for name, *_ in session.spans}


def _off():
    """A site that finds no session: the next one to find a session starts
    the record afresh."""
    with spans.Span("test.off"):
        pass


def test_no_profiler_leaves_the_session_empty(tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "SESSION", spans.Session())
    _train(tmp_path)
    assert spans.SESSION.spans == [] and spans.SESSION.counters == {}
    assert not torch.autograd.profiler._is_profiler_enabled
    with open(os.path.join(TrainConfig(**CONFIG).runs_dir(str(tmp_path)), "metrics.jsonl")) as f:
        records = [r for r in map(json.loads, f) if "loss" in r]
    assert len(records) == 3
    assert all(r["device_ms_per_step"] is None for r in records)  # off the card


def test_a_profiled_train_records_its_spans(tmp_path):
    _off()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(tmp_path, sample_each_epoch=True, checkpoint_each_epoch=True)
    session = spans.SESSION
    assert set(TRAIN_SPANS) <= _names(session)
    counts = {name: sum(1 for n, *_ in session.spans if n == name) for name in TRAIN_SPANS}
    assert counts == {"train.batch": 8, "train.step": 6, "train.log": 3, "train.epoch_end": 2}
    for i, (name, start, end, parent) in enumerate(session.spans):
        assert end is not None and end >= start, name
        assert -1 <= parent < i, name
        if parent >= 0:  # a child lies inside its parent
            _, p_start, p_end, _ = session.spans[parent]
            assert p_start <= start and end <= p_end, name
    assert session.open == []
    assert all(d >= 0.0 for d in session.durations("train.batch"))
    assert {n for n, *_ in session.spans if n.startswith("train.")} == set(TRAIN_SPANS)
    assert all(p == -1 for n, _, _, p in session.spans if n in TRAIN_SPANS)
    assert set(TRAIN_SPANS) <= {e.name for e in prof.events()}


def test_only_the_latest_session_remains(tmp_path):
    _off()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.Span("first.session"):
            pass
        with spans.Span("first.other"):
            pass
    assert _names(spans.SESSION) == {"first.session", "first.other"}
    _train(tmp_path / "between")  # untraced steps
    assert _names(spans.SESSION) == {"first.session", "first.other"}  # nothing added off
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.Span("second.session"):
            with spans.Span("second.child"):
                pass
    assert [(n, p) for n, _, _, p in spans.SESSION.spans] == [("second.session", -1),
                                                              ("second.child", 0)]


def test_a_span_opened_off_a_session_is_not_recorded():
    outer, inner = spans.Span("t.outer"), spans.Span("t.inner")
    _off()
    with outer:
        with profile(activities=[ProfilerActivity.CPU]):
            with inner:
                pass
    assert [(n, p) for n, _, _, p in spans.SESSION.spans] == [("t.inner", -1)]
    # one opened under a session is ended in the record after the session stops
    _off()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with outer:
        prof.stop()
    (name, start, end, _), = spans.SESSION.spans
    assert name == "t.outer" and end >= start and spans.SESSION.open == []


def test_profile_dir_trace_holds_the_spans(tmp_path):
    # two steps an epoch: the window of steps 0-2 holds a log point and an epoch end
    _train(tmp_path / "run", rows=8, profile_dir=str(tmp_path / "prof"), profile_steps=(0, 3))
    path = tmp_path / "prof" / f"trace_{CONFIG['run_name']}.json"
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert set(TRAIN_SPANS) <= names


class _Event:
    """A stand-in for ``torch.cuda.Event`` whose ``query()`` reads a script."""

    def __init__(self, done: set, index: int):
        self.done, self.index, self.records = done, index, 0

    def query(self) -> bool:
        return self.index in self.done

    def record(self) -> None:
        self.records += 1


def _ring(done: set) -> spans.LeadRing:
    ring = spans.LeadRing()
    ring.events = [_Event(done, i) for i in range(spans.RING)]
    return ring


@pytest.mark.parametrize("pending", [0, 1, 2])
def test_lead_counts_the_replays_not_finished(pending):
    done: set = set()
    ring = _ring(done)
    assert ring.pending() == 0  # nothing launched yet
    for _ in range(5):
        ring.launched_one()
    done.update(range(5 - pending))  # the card finished the oldest, in order
    assert ring.pending() == pending
    assert ring.finished == 5 - pending
    done.update(range(5))
    assert ring.pending() == 0


def test_lead_takes_over_the_oldest_event_past_the_ring():
    done: set = set()
    ring = _ring(done)
    for _ in range(spans.RING + 3):
        ring.launched_one()
    assert ring.pending() == spans.RING  # the most a lead reads
    assert ring.events[0].records == 2 and ring.events[3].records == 1
    done.update(range(spans.RING))  # slots 0-2 hold the three newest replays
    assert ring.pending() == 0


def test_count_lead_records_only_under_a_session(monkeypatch):
    calls = []
    ring = _ring(set())
    ring.launched_one()  # one replay the card has not finished
    monkeypatch.setattr(spans, "_RINGS", {0: ring})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: calls.append(1))
    _off()
    assert spans.count_lead() is None and calls == []  # off: the flag alone is read
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.count_lead() is ring
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        assert spans.count_lead() is None  # under a capture: nothing counted
    assert spans.SESSION.counters == {"graph.lead": [1]}


@pytest.mark.cuda
def test_graph_lead_on_real_replays():
    """On a card: a graphed step's replays count ``graph.lead``; the first
    after a synchronisation reads 0, and replays of a long step launched one
    behind another read 1 or more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graph replays exist only on a card")
    device = torch.device("cuda")

    class Busy(graphs.GraphedStep):
        def __init__(self):
            super().__init__(device)
            self.x = torch.randn(2048, 2048, device=device)
            self.y = torch.empty_like(self.x)

        def step(self, variant):
            for _ in range(20):
                torch.matmul(self.x, self.x, out=self.y)

    busy = Busy()
    busy(None)  # warm-up
    with profile(activities=[ProfilerActivity.CPU]):
        busy(None)  # capture and the first replay
        torch.cuda.synchronize()
        for _ in range(5):
            busy(None)
        torch.cuda.synchronize()
    leads = spans.SESSION.counters["graph.lead"]
    assert len(leads) == 6
    assert leads[1] == 0  # the first replay after the synchronisation
    assert max(leads[2:]) >= 1  # the host ran ahead of the card
    assert "graph.capture" in _names(spans.SESSION)
