"""attn_roofline.train (%): the least time of the attention cores of the
traced train steps (each of the six attention layers' forward, keeping the
row statistics, and backward at the step's (B·H, S, D), bf16:
``portbench/lib/bounds.py``) over the device time of the kernels whose name
holds one of KERNELS (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) in the
trace."""

from portbench.lib import bounds
from portbench.reference import unet as ref_unet

KERNELS = ("flash_fwd", "flash_bwd")


def read(f):
    if f.kind != "train" or f.trace is None:
        return None
    seconds = f.trace.time_of(*KERNELS)
    if seconds <= 0:
        return None
    times = []
    for _, bh, s, d in ref_unet.attention_shapes(f.model, f.batch):
        times += [bounds.attention_fwd(bh, s, d, stats=True), bounds.attention_bwd(bh, s, d)]
    return 100.0 * bounds.bound(times) * f.trace.units / seconds
