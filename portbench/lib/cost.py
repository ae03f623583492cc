"""Model FLOPs, counted over the benchmark's own reference model.

The method of ``bench_torch.py:step_flops``: ``torch.utils.flop_counter``'s
``FlopCounterMode`` over one forward (and, for training, one backward) at
batch 1, on fake float32 tensors, so nothing is computed or allocated. It
counts the convolutions (the FIR layers' depthwise ones among them, the
zero-stuffed samples of the up FIR included), the linear layers, the
bilinear layer's matrix products and the attention cores, these by PyTorch's
SDPA formula: two products forward, five backward
(:class:`portbench.reference.unet._CountedAttention`). Elementwise work,
norms, the optimizer and the EMA count nothing. The count is of the model,
so it does not change with the route the program takes.
"""

from __future__ import annotations

import functools

import torch

from portbench.reference import unet as ref_unet


@functools.lru_cache(maxsize=8)
def flops_per_image(model: ref_unet.Model, backward: bool) -> int:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    with FakeTensorMode():
        params = {n: torch.empty(s).requires_grad_(backward)
                  for n, s in ref_unet.param_shapes(model).items()}
        x = torch.zeros((1, model.image_size, model.image_size, model.channels))
        t = torch.ones((1,), dtype=torch.long)
        counter = FlopCounterMode(display=False)
        with counter:
            eps = ref_unet.forward(params, model, x, t, count_attention=True)
            if backward:
                torch.autograd.grad(eps.square().mean(), list(params.values()))
    return int(counter.get_total_flops())
