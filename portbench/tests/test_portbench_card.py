"""On the card: every cell's sound runs come out ``correct``, and its control
(the reference in fp8 in the program's place) and, in a train cell, each
planted fault fail one of its numbers, at the cell's own size on three seeds.

    python -m pytest portbench/tests -m cuda

The decision whether a card is there is made in a fixture; without one the
tests skip.
"""

from __future__ import annotations

import pytest

from portbench import calibrate
from portbench.lib import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEEDS = (2**31 + 1009, 424242, 7)


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return "cuda:0"


def _fails(readings: dict, limits: dict) -> bool:
    return any(readings[k] is None or readings[k] > limits[k]["limit"]
               for k in readings if k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_where_the_program_passes(card, cell):
    limits = spec.limits(cell)["numbers"]
    for seed in SEEDS:
        program, *others = calibrate.readings(cell, seed, 3.0, card)
        assert program["correct"], program["numbers"]
        for line in others:
            assert _fails(line["numbers"], limits), (line["kind"], line["numbers"])
