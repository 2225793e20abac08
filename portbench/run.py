"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It reads BENCHMARK.json, makes the
cell's inputs from the seed, runs the port (smartedgesensor3dhumanpose_tpu_torch)
on the card, checks what the timed path produced against the plain
reference in portbench/reference/, and prints one JSON line last on
standard output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer metrics), `device`,
with `--trace 1` a `breakdown`, and last `checks`, each number compared
beside its limit (also the last lines on standard error).

It exits with 2 and prints no result where no CUDA device is visible or
fewer than the cell asks for, and with 3 where the process has loaded JAX
or the JAX package. See portbench/README.md.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from portbench.lib import harness, manifest

    cell = manifest.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.note(f"{args.workload} needs {chips} CUDA device(s); {seen} visible")
        return 2
    # One host thread for torch's own pools: the live loop's producer and
    # consumer are the process's threads.
    torch.set_num_threads(1)
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace), T_START,
                      torch.device("cuda", 0))
    result, checks = harness.execute(run)
    found = harness.forbidden_loaded()
    if found:
        harness.note(f"the run loaded {', '.join(found)}, which the port must not use")
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
