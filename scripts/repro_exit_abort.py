"""Count the runs of a single-process ``distributed.initialize`` that abort at
interpreter exit, for one tree of hpfrec_tpu_torch, on the CPU.

    python3 scripts/repro_exit_abort.py TREE [RUNS] [AT_ONCE] [BUSY]

Each run is a fresh interpreter, in TREE, executing what the import test
(``tests/test_torch_imports.py``, the ``parallel.distributed`` case) runs:
``initialize(device='cpu')`` (a gloo group of one), one exchange, exit.
RUNS runs (300 by default), AT_ONCE at a time (12), beside BUSY processes
that spin (2), to load the machine.  A run fails when it exits non-zero or
prints "terminate called" (a gloo group whose threads outlive the
interpreter's teardown aborts the process with that message).  Prints one
line of counts, and the first failures' exit codes and messages.
"""

import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

CODE = (
    "import warnings, torch\n"
    "from hpfrec_tpu_torch.parallel import distributed, engine\n"
    "with warnings.catch_warnings():\n"
    "    warnings.simplefilter('ignore')\n"
    "    mesh = distributed.initialize(device='cpu')\n"
    "assert engine.all_gather_rows(mesh, torch.ones(2, 3)).shape == (2, 3)\n")


def main():
    tree = sys.argv[1]
    given = [int(a) for a in sys.argv[2:5]]
    runs, at_once, busy = given + [300, 12, 2][len(given):]

    def one(_):
        p = subprocess.run([sys.executable, "-c", CODE], cwd=tree, capture_output=True, text=True)
        return p.returncode, p.stderr[-300:]

    spinners = [subprocess.Popen([sys.executable, "-c", "while True: pass"]) for _ in range(busy)]
    t0 = time.time()
    try:
        with ThreadPoolExecutor(at_once) as pool:
            results = list(pool.map(one, range(runs)))
    finally:
        for p in spinners:
            p.kill()
            p.wait()
    failed = [(rc, err) for rc, err in results if rc != 0 or "terminate called" in err]
    print("tree %s: %d runs, %d at a time, %d busy processes: %d failed (%.1f s)"
          % (tree, runs, at_once, busy, len(failed), time.time() - t0))
    for rc, err in failed[:5]:
        print("  exit %d: %s" % (rc, err.strip().splitlines()[-1] if err.strip() else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
