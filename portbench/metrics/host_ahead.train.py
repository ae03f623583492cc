"""host_ahead.train (%): the share of the traced train steps' graph launches
made while the card still ran an earlier one: the program's
``graph.lead`` counts (``utils/graphs.py:GraphedStep._replay``,
``utils/spans.py``) of its latest torch.profiler session, which is the
stretch the tracer kept, that read 1 or more. The session's first launch
follows the tracer's synchronisation and is left out. Nothing to read in a
program without the counter."""


def read(f):
    if f.kind != "train" or f.trace is None:
        return None
    try:
        from aliasfree_diffusion_models_pytorch_tpu_torch.utils import spans
    except ImportError:
        return None
    leads = spans.SESSION.counters.get("graph.lead", [])[1:]
    return 100.0 * sum(n >= 1 for n in leads) / len(leads) if leads else None
