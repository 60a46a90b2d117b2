"""The control at each cell's own size, on the card: the program's run passes
the cell's limits and the control (the program's w4a8 path, int8
activations: the nearest precision below the configurations' bf16) fails
one of them. Skips without a CUDA card. On the card, from the repository's
root:

    python3 -m pytest portbench/tests/test_portbench_chip.py -m chip -q

(several minutes a cell: each builds its model at the published widths).
"""
import time

import pytest
import torch

from portbench import calibrate, correct, registry

CELLS = [w["name"] for w in registry.manifest()["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their published widths")
    cell = registry.cell(name)
    seconds = 4
    r = calibrate.readings(cell, 424242, seconds, torch.device("cuda", 0), True,
                           time.perf_counter())
    assert correct.all_ok(correct.judge({k: r[k] for k in cell.limits}, cell.limits)), r
    control = {k: r["w4a8"][k] for k in cell.limits if k in r["w4a8"]}
    assert not correct.all_ok(correct.judge(control, cell.limits)), r["w4a8"]
