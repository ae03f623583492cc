"""Seeded weights, made on the device in float32 from one draw.

One standard-normal draw of every parameter's entries from a generator on
the device, cut into the parameters of :func:`portbench.reference.unet.param_shapes`
(the port's ``state_dict`` names), then scaled: convolution and linear
weights by 1/sqrt(fan-in), biases by 0.02, norm scales as 1 + 0.1·z and norm
shifts as 0.1·z. No bias and no norm is left at a constant, so every leaf has
a gradient of its own. Both sides get these tensors.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import unet as ref_unet


def make(model: ref_unet.Model, seed: int, device) -> dict[str, torch.Tensor]:
    shapes = ref_unet.param_shapes(model)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        leaf = z[at:at + n].view(shape)
        at += n
        if name.endswith("bias"):
            is_norm = ".gn." in name or ".ln." in name or "_ln." in name
            leaf = leaf * (0.1 if is_norm else 0.02)
        elif len(shape) == 1:  # a norm's scale
            leaf = 1.0 + 0.1 * leaf
        else:
            leaf = leaf * (1.0 / math.sqrt(math.prod(shape[1:])))
        out[name] = leaf
    return out
