"""Run one cell of the benchmark once and print its result line.

    python3 -m hpfbench.run --workload <config>.<mix> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from the start of this process to the window's start):
the imports, the card's start, the cell's inputs made from the seed and one
warm call of every shape the window uses.  Then the window: ``--seconds``
of the cell's traffic.  With ``--trace 1`` the window runs under the
profiler and the line carries the per-layer metrics, ``busy_s`` /
``window_s`` and a ``breakdown``; else the end-to-end metrics.  After the
window the device's peak memory is read, the program's state is freed, and
the cell's numbers are compared with the plain reference, each beside its
limit (``limits/<workload>.json``), on standard error and as the line's
last key.  The last line of standard output is the result's JSON.

Exits 2 without a result where the card is missing or the cell asks for
more cards than there are, and 3 where a module of JAX or of the JAX
package is loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Run:
    """What the metric readers read: the cell (its records), the set-up
    time, and with ``--trace 1`` the window's trace and its bounds."""

    def __init__(self, cell, setup_s, trace=None, window=None):
        self.cell, self.setup_s, self.trace, self.window = cell, setup_s, trace, window


def read_metrics(entries, run) -> dict:
    from hpfbench import spec

    out = {}
    for m in entries:
        value = spec.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name: every one at or under its limit; one that is not finite
    fails."""
    checks, ok = {}, True
    for name, lim in limits.items():
        value = float(numbers[name])
        checks[name] = {"value": value, "limit": float(lim["limit"])}
        ok &= math.isfinite(value) and value <= float(lim["limit"])
    return ok, checks


def run_cell(bench, w, seed, seconds, trace=False, device="cuda", cfg=None, traffic=None,
             limits=None) -> dict:
    """Set up, run and judge one cell (``w``, an entry of ``workloads``);
    returns the result line.  ``cfg`` / ``traffic`` / ``limits`` replace
    the cell's files (the tests run cells at small sizes on the CPU)."""
    from hpfbench import guard, spec
    from hpfbench.trace import DeviceTrace, breakdown, busy, within

    cfg = cfg or spec.config(w["config"])
    traffic = traffic or spec.traffic(w["traffic"])
    limits = limits or spec.limits(w["name"])
    cuda = str(device).startswith("cuda")
    if cuda:
        import torch
    cell = spec.kind(traffic["kind"]).Cell(cfg, traffic, seed, device=device, trace=trace)
    cell.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    if trace:
        from torch.profiler import record_function

        with DeviceTrace() as dt:
            with record_function("hpfbench.window"):
                cell.window(seconds)
            torch.cuda.synchronize()
        tr = dt.trace
        win = next(a for a in tr.annotations if a.name == "hpfbench.window")
        cell.finish(tr)
        run = Run(cell, setup_s, tr, (win.start, win.end))
    else:
        cell.window(seconds)
        if cuda:
            torch.cuda.synchronize()
        run = Run(cell, setup_s)
    guard.check("after the window")
    if cuda:
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                       "count": int(w["chips"]),
                       "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    metrics = read_metrics(spec.metrics(bench, w["name"], trace), run)
    result = {}
    if trace:
        lo, hi = run.window
        device_info["busy_s"] = busy(within(tr.device, lo, hi), lo, hi)
        device_info["window_s"] = hi - lo
        result["breakdown"] = breakdown(tr, lo, hi, owners=cell.owners(tr))
    t_window = time.perf_counter() - T0 - setup_s
    cell.release()
    t_ref = time.perf_counter()
    correct, checks = judge(cell.numbers(), limits)
    print("hpfbench: %s" % cell.describe(), file=sys.stderr)
    print("hpfbench: set-up %.3f s, window %.3f s (%d calls), reference %.3f s"
          % (setup_s, t_window, cell.attempted, time.perf_counter() - t_ref), file=sys.stderr)
    guard.check("before the result")
    for name, c in checks.items():
        print("%s %r limit %r" % (name, c["value"], c["limit"]), file=sys.stderr)
    return {"correct": bool(correct), "attempted": cell.attempted, "failed": 0,
            "metrics": metrics, "device": device_info, **result, "checks": checks}


def main(argv=None) -> int:
    args = parse(argv)
    from hpfbench import guard, spec

    guard.check("at the start")
    bench = spec.load_spec()
    w = spec.workload(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print("hpfbench: the cell needs %d CUDA device(s); %s" % (
            w["chips"], "found %d" % torch.cuda.device_count()
            if torch.cuda.is_available() else "CUDA is not available"), file=sys.stderr)
        return 2
    line = run_cell(bench, w, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
