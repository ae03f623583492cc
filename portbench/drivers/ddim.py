"""DDIM sampling requests: ``Diffusion.sample_ddim`` over the mix's steps at
its η (see :mod:`portbench.lib.sampling`)."""

from portbench.lib import sampling


def run(cell):
    return sampling.run(cell, "ddim")
