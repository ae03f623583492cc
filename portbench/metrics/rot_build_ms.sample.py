"""rot_build_ms.sample (ms): the host milliseconds that the program took to
make a Config-E call's rotation operand on the card (the cache lookup, the
build on the host, the copy to the device): the median ``rotation.build``
span (``ops/rotation.py:build_rotation``, ``utils/spans.py``) among those
whose ``rotation.built`` counted 1, in the program's latest torch.profiler
session, which is the stretch the tracer kept. A span that a cache served
(``rotation.built`` 0) is left out. Nothing to read in a program without the
span or the counter, nor in a session that built nothing."""

import statistics


def read(f):
    if f.kind != "sample" or f.trace is None:
        return None
    try:
        from aliasfree_diffusion_models_pytorch_tpu_torch.utils import spans
    except ImportError:
        return None
    built = spans.SESSION.counters.get("rotation.built", [])
    builds = [d for d, b in zip(spans.SESSION.durations("rotation.build"), built) if b]
    return 1e3 * statistics.median(builds) if builds else None
