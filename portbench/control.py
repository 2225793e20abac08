"""The control of `correct`, and the readings its limits are set from.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --seconds <s> \
        [--precision tf32,bf16] [--no-control]

For each seed it runs the cell as a benchmark run does (the port on the
card, a window of `--seconds`), reads the numbers the check compares
(the program's readings, the lower ends of the limits), and then puts the
control in the program's place on the same inputs, once for each
precision (portbench/lib/precision.py): the plain reference in TF32 on
the card, and the plain reference with every float32 value rounded to
bfloat16. Its numbers must fail a limit (the upper ends). One JSON line
per seed on standard output. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the control of a cell's check")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--precision", default="tf32,bf16", help="comma-separated")
    p.add_argument("--no-control", action="store_true", help="the program's readings only")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench.lib import harness, manifest

    cell = manifest.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    torch.set_num_threads(1)
    driver = manifest.driver(cell.mix["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(cell, seed, args.seconds, False, time.perf_counter(), dev)
        out = driver.run(run)
        program, _ = out.case.check()
        line = {"workload": args.workload, "seed": seed, "program": program}
        for arith in [] if args.no_control else args.precision.split(","):
            t0 = time.perf_counter()
            try:
                line[f"control.{arith}"], _ = driver.control(copy.copy(out.case), dev,
                                                             arith).check()
            except Exception as e:  # a control that crashes has failed, with no reading
                line[f"control.{arith}"] = {"error": repr(e)[:500]}
            line[f"control.{arith}_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del out, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
