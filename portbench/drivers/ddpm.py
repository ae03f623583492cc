"""DDPM sampling requests: ``Diffusion.sample`` over every noise step (see
:mod:`portbench.lib.sampling`)."""

from portbench.lib import sampling


def run(cell):
    return sampling.run(cell, "ddpm")
