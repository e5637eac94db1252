"""The import check: JAX and the JAX package are found by whole top-level
names, the port is not mistaken for the JAX package, and the reference
loads nothing of the port."""

import ast
import pathlib
import subprocess
import sys

from hpfbench import guard

HERE = pathlib.Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def test_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "hpfrec_tpu",
             "hpfrec_tpu.ops.ell", "hpfrec_tpu_torch", "hpfrec_tpu_torch.ops.ell", "jaxtyping",
             "numpy", "hpfrec_tpuX"]
    assert guard.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "hpfrec_tpu",
         "hpfrec_tpu.ops.ell"])


def test_check_exits_when_a_forbidden_module_is_loaded(monkeypatch, capsys):
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    try:
        guard.check("in the test")
    except SystemExit as e:
        assert e.code == 3
    else:
        raise AssertionError("no exit")
    assert "jax" in capsys.readouterr().err


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return out.stdout.split()


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded_after("import hpfbench.reference.hpf, hpfbench.reference.topn")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"hpfrec_tpu_torch", "hpfrec_tpu", "jax", "jaxlib", "flax"}


def test_a_cell_run_on_the_cpu_loads_no_jax():
    mods = _loaded_after(
        "from hpfbench import spec\n"
        "from hpfbench.kinds import cavi_fit\n"
        "from hpfbench.tests.small import config, traffic\n"
        "c = cavi_fit.Cell(config('tasteprofile-k50'), traffic('cavi'), 1, device='cpu')\n"
        "c.setup(); c.window(0); c.release(); c.numbers()\n")
    assert "hpfrec_tpu_torch" in {m.split(".")[0] for m in mods}
    assert guard.forbidden_modules(mods) == []


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not
                     node.level else [])
            for n in names:
                assert n.split(".")[0] not in guard.FORBIDDEN, (path, n)
                if path.parent.name == "reference":
                    assert n.split(".")[0] != "hpfrec_tpu_torch", (path, n)
