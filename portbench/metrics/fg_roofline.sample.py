"""fg_roofline.sample (%): the least time of the filtered GELUs of the traced
forwards (every call's forward at the request's (N, C, H, W), bf16:
``portbench/lib/bounds.py``) over the device time of the kernels whose name
holds one of KERNELS (``csrc/filtered_gelu.cu``) in the trace. Nothing to
read in a model without filtered GELUs."""

import math

from portbench.lib import bounds
from portbench.reference import unet as ref_unet

KERNELS = ("filtered_gelu",)


def read(f):
    if f.kind != "sample" or f.trace is None:
        return None
    shapes = ref_unet.filtered_gelu_shapes(f.model, f.batch)
    seconds = f.trace.time_of(*KERNELS)
    if not shapes or seconds <= 0:
        return None
    k = dict(f.model.filters)["kernel_size"]
    times = [bounds.fg(math.prod(shape), k, False)
             for shape, calls in shapes.items() for _ in range(calls)]
    return 100.0 * bounds.bound(times) * f.trace.units / seconds
