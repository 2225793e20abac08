"""portbench/control_dome.py reads, for the program, the numbers the
judge's check reads (lib/judge.py OfflineCase.check): a tiny offline run
on the host, its case read both ways."""

import time

import torch

from portbench import control_dome
from portbench.lib import harness, manifest
from portbench.tests import tiny


def test_program_readings_are_the_checks():
    torch.set_num_threads(1)
    cell = tiny.cell("offline")
    run = harness.Run(cell, 7, 1.0, False, time.perf_counter(), torch.device("cpu"))
    case = manifest.driver(cell.mix["driver"]).run(run).case
    want, _ = case.check()
    line = control_dome.readings(case, 7, [], torch.device("cpu"))
    assert line["program"] == want
    assert set(line["reference_s"]) == {"fusion", "smoothing", "tracker", "feedback"}
    assert line["sampled_frames"] == sorted(line["sampled_frames"])
    assert len(line["sampled_frames"]) == cell.check["sample_frames"]
