"""The controls fail the comparison, at a size a test run holds (tiny
widths on the CPU; PERF.md gives their readings at the cells' own sizes
on the card): the program's int8 merge path, and the reference with
fp8 products, over half of each batch, and with one leaf left
unmoved."""
import pytest
import torch

import tiny
from portbench import control
from portbench.run import judge


def _held(cell, values):
    return {k: (v, cell.limits[k]) for k, v in values.items()}


def test_int8_merge_path_is_not_correct():
    cell = tiny.cell("phi3-merge-sweep", sample_width=64, sample_blocks=2)
    vals = control.merge_control(cell, 5, torch.device("cpu"), requests=4)
    assert not judge(_held(cell, vals)), vals


@pytest.mark.parametrize("workload", ["mamba2-finetune", "phi3-finetune"])
def test_training_controls_are_not_correct(workload):
    cell = tiny.cell(workload, seq_len=64)
    rows = control.train_readings(cell, 5, torch.device("cpu"),
                                  ["fp8", "half", "frozen"])
    for what, vals, _ in rows:
        assert not judge(_held(cell, vals)), (what, vals)
