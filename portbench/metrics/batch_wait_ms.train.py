"""batch_wait_ms.train (ms): the median host milliseconds that ``train.train``
waited on its loader (``data.PrefetchLoader``) for a batch in the traced
stretch: the program's ``train.batch`` spans of its latest torch.profiler
session (``utils/spans.py``), which is the stretch the tracer kept. The
median, so that a stretch holding an epoch's first batch, which nothing
prefetched, does not jump. Nothing to read in a program without the spans."""

import statistics


def read(f):
    if f.kind != "train" or f.trace is None:
        return None
    try:
        from aliasfree_diffusion_models_pytorch_tpu_torch.utils import spans
    except ImportError:
        return None
    waits = spans.SESSION.durations("train.batch")
    return 1e3 * statistics.median(waits) if waits else None
