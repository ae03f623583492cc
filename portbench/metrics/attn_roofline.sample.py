"""attn_roofline.sample (%): the least time of the attention cores of the
traced forwards (the six attention layers' forward at the request's
(B·H, S, D), bf16: ``portbench/lib/bounds.py``) over the device time of the
kernels whose name holds one of KERNELS (``csrc/flash_fwd.cu``) in the trace."""

from portbench.lib import bounds
from portbench.reference import unet as ref_unet

KERNELS = ("flash_fwd",)


def read(f):
    if f.kind != "sample" or f.trace is None:
        return None
    seconds = f.trace.time_of(*KERNELS)
    if seconds <= 0:
        return None
    times = [bounds.attention_fwd(bh, s, d)
             for _, bh, s, d in ref_unet.attention_shapes(f.model, f.batch)]
    return 100.0 * bounds.bound(times) * f.trace.units / seconds
