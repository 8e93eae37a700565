"""On the card: the control (the reference one precision step below
bf16, its products in fp8) and, in train cells, half of the batch left
out fail at least one of the cell's numbers on three seeds, at the
cell's own sizes. Skips without a card.

    python -m pytest portbench/tests/test_portbench_control.py -m card
"""
import pytest

from portbench.core.control import readings
from portbench.core.spec import find_cell, load_benchmark

CELLS = [w["name"] for w in load_benchmark()["workloads"]]
SEEDS = (2 ** 31 + 901, 2 ** 31 + 902, 2 ** 31 + 903)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = find_cell(load_benchmark(), name)
    limits = cell.workload["limits"]
    kinds = ["fp8"] if cell.entry == "serve" else ["fp8", "half"]
    for seed in SEEDS:
        for kind, nums in readings(cell, seed, kinds, "cuda:0").items():
            print(name, seed, kind, nums)
            over = [k for k, v in nums.items()
                    if k in limits and v > limits[k]]
            assert over, (name, seed, kind, nums, limits)
