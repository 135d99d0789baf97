"""The control fails the cell's limits: the plain reference in the port's
place, its float32 products in TF32, from the cell's seeded inputs. On a
card only (TF32 exists there alone), at the 25x25 cell's own size."""
import time

import pytest
import torch

from portbench import cells, compare


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["dgyre25.steady", "dgyre25.campaign"])
def test_the_control_is_not_correct(cuda_device, workload):
    from portbench.control import control_values
    from portbench import entries

    cell = cells.cell(workload)
    out = entries.find(cell["traffic"]["entry"])(cell, 2**31 + 99, 1.0, False, [cuda_device],
                                                 time.perf_counter())
    correct, _ = compare.judge(control_values(cell, out, cuda_device), cell["limits"])
    assert not correct
    torch.cuda.empty_cache()
