"""The cost of one empty phase span of ``utils.profiling`` (a ``FitStats``
phase with no device, and a ``TopNStats`` phase), off and under a CPU
``torch.profiler``, over a loop of ``--n`` spans; one JSON line.

    python3 scripts/span_overhead.py [--n 100000]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from hpfrec_tpu_torch.utils.profiling import FitStats, TopNStats  # noqa: E402


def per_span_us(stats, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        with stats.phase("gather"):
            pass
    return 1e6 * (time.perf_counter() - t0) / n


def bare_loop_us(n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        pass
    return 1e6 * (time.perf_counter() - t0) / n


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    n = ap.parse_args().n
    out = {"n": n, "loop_us": bare_loop_us(n)}
    for name, make in (("fit", FitStats), ("topn", TopNStats)):
        out[name + "_off_us"] = per_span_us(make(), n)
        with profile(activities=[ProfilerActivity.CPU]):
            out[name + "_profiled_us"] = per_span_us(make(), n)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
