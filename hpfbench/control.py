"""Readings for a cell's correctness limits, on the card.

    python3 -m hpfbench.control --workload <cell> --arm <arm> \\
        --seeds <n> [<n> ...] [--seconds <s>]

For each seed, in one process: the cell's set-up, a window of ``--seconds``
(0: one call, the least a window holds) at the cell's own sizes, and the
numbers that ``run.py`` compares, printed as one JSON line a seed.  The
arms: ``program``, the program as the benchmark runs it; ``control``, the
precision below the configuration's in the program's place (each kind
says how); ``fault:<name>``, the program with a fault of
``hpfbench.faults`` planted.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(workload: str, arm: str, seeds, seconds: float = 0.0, device: str = "cuda",
             cfg=None, traffic=None, patch=setattr):
    """Run the cell's timed path for each seed and return its numbers; a
    fault arm plants its fault with ``patch``."""
    from hpfbench import faults, spec

    if cfg is None or traffic is None:
        w = spec.workload(spec.load_spec(), workload)
        cfg = cfg or spec.config(w["config"])
        traffic = traffic or spec.traffic(w["traffic"])
    kind = spec.kind(traffic["kind"])
    if arm.startswith("fault:"):
        faults.ALL[arm.split(":", 1)[1]](patch)
        cell_arm = "program"
    else:
        cell_arm = arm
    rows = []
    for j, seed in enumerate(seeds):
        t0 = time.perf_counter()
        cell = kind.Cell(cfg, traffic, seed, device=device, arm=cell_arm)
        cell.setup(warm=j == 0)
        cell.window(seconds)
        calls = cell.attempted
        iterations = [f.iterations for f in getattr(cell, "fits", [])]
        cell.release()
        numbers = cell.numbers()
        row = {"workload": workload, "arm": arm, "seed": int(seed), "calls": calls,
               "iterations": iterations, "numbers": numbers,
               "reference_llks": getattr(cell, "reference_llks", None),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del cell
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--arm", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    from hpfbench import faults

    fault = args.arm.startswith("fault:") and args.arm[len("fault:"):] in faults.ALL
    if args.arm not in ("program", "control") and not fault:
        ap.error("--arm: program, control or fault:<%s>" % "|".join(faults.ALL))
    import torch

    if not torch.cuda.is_available():
        print("hpfbench.control: CUDA is not available", file=sys.stderr)
        return 2
    readings(args.workload, args.arm, args.seeds, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
