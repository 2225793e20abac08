"""The control of `correct` on the card: the plain reference put in the
program's place, in TF32 and with every float32 value rounded to
bfloat16, fails a limit of the cell, at the cell's own size with a short
window (`portbench/control.py` takes the readings over many seeds)."""

import copy
import time

import pytest
import torch

from portbench.lib import harness, manifest


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs the reference on the card, in TF32")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["demo16_live_30hz", "demo16_offline_replay"])
def test_control_fails_a_limit(card, workload):
    cell = manifest.load_cell(workload)
    driver = manifest.driver(cell.mix["driver"])
    run = harness.Run(cell, 2**31 + 31, 2.0, False, time.perf_counter(), card)
    out = driver.run(run)
    program, _ = out.case.check()
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    assert all(program[k] <= limits[k] for k in limits), program
    for arith in ("tf32", "bf16"):
        numbers, _ = driver.control(copy.copy(out.case), card, arith).check()
        assert any(not numbers[k] <= limits[k] for k in limits), (arith, numbers)
