"""``distributed.initialize`` tears down at exit the process group that it
created, and only that one (gloo on the CPU, each case in a fresh
interpreter):

- after ``initialize(device='cpu')`` and an exchange, the exit handlers
  leave no group, and the process exits 0 without an abort (in one
  process, and in two ranks over a ``file://`` rendezvous that exit
  without destroying their group);
- a group the caller made before ``initialize`` is left as it was;
- the handler is harmless after an explicit ``destroy_process_group()``,
  and leaves alone a group the caller makes after that.
"""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = str(Path(__file__).resolve().parents[1])

PRELUDE = """
import atexit, sys, warnings
import torch
import torch.distributed as dist
from hpfrec_tpu_torch.parallel import distributed, engine

def exchange(mesh):
    assert engine.all_gather_rows(mesh, torch.ones(2, 3)).shape == (2 * mesh.world_size, 3)

def init_alone():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return distributed.initialize(device="cpu")

def caller_group():
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    return dist.group.WORLD
"""

CASES = {
    # the group initialize made is gone once the exit handlers have run
    "created_is_destroyed": """
mesh = init_alone()
exchange(mesh)
assert dist.is_initialized()
atexit._run_exitfuncs()
assert not dist.is_initialized()
print("ok")
""",
    # the handler runs at the real exit, with the group still up
    "created_is_destroyed_at_exit": """
mesh = init_alone()
exchange(mesh)
print("ok")
""",
    # a group the caller made first is left alone, at the handlers and after
    "callers_group_left_alone": """
g = caller_group()
mesh = init_alone()
exchange(mesh)
assert dist.group.WORLD is g
atexit._run_exitfuncs()
assert dist.is_initialized() and dist.group.WORLD is g
exchange(mesh)
dist.destroy_process_group()
print("ok")
""",
    # destroyed by the caller first: the handler does nothing, and a group
    # the caller makes afterwards is not the one it was registered for
    "harmless_after_explicit_destroy": """
mesh = init_alone()
exchange(mesh)
dist.destroy_process_group()
atexit._run_exitfuncs()
assert not dist.is_initialized()
g = caller_group()
atexit._run_exitfuncs()
assert dist.is_initialized() and dist.group.WORLD is g
dist.destroy_process_group()
print("ok")
""",
}


def _run(code, *args, timeout=120):
    return subprocess.run([sys.executable, "-c", PRELUDE + code, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("case", sorted(CASES))
def test_initialize_tears_down_only_its_own_group(case):
    p = _run(CASES[case])
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.split() == ["ok"], p.stdout
    assert "terminate called" not in p.stderr, p.stderr[-3000:]


def test_two_gloo_ranks_exit_without_destroying(tmp_path):
    """Two ranks that exchange and exit with their group up: the handler
    destroys it in each, and both exit 0."""
    code = """
rank, init = int(sys.argv[1]), sys.argv[2]
mesh = distributed.initialize(init, num_processes=2, process_id=rank,
                              initialization_timeout=60, device="cpu")
exchange(mesh)
print("ok")
"""
    init = "file://" + str(tmp_path / "rendezvous")
    procs = [subprocess.Popen([sys.executable, "-c", PRELUDE + code, str(r), init], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert out.split() == ["ok"], out
        assert "terminate called" not in err, err[-3000:]
