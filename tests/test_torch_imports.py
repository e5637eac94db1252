"""Import hygiene of the port: no file of hpfrec_tpu_torch imports jax or
the JAX package hpfrec_tpu, names a path inside hpfrec_tpu/, or builds
from a source outside its own package."""

import ast
import pathlib
import re

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "hpfrec_tpu_torch"
FILES = sorted(PKG.rglob("*.py"))
# a path component "hpfrec_tpu" (the JAX package's directory), as in
# "hpfrec_tpu/_native" or os.path.join(..., "hpfrec_tpu", ...)
_JAX_PKG_PATH = re.compile(r"(^|[/\\])hpfrec_tpu([/\\]|$)")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_package_has_files():
    assert len(FILES) >= 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_or_hpfrec_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for mod in _imported_modules(tree):
        top = mod.split(".")[0]
        assert top != "jax", f"{path.name} imports {mod}"
        assert top not in ("jaxlib", "hpfrec_tpu"), f"{path.name} imports {mod}"


@pytest.mark.parametrize("module", ["hpfrec_tpu_torch.compat", "hpfrec_tpu_torch.utils.io",
                                    "hpfrec_tpu_torch.parallel.distributed",
                                    "hpfrec_tpu_torch.parallel.table_sharded"])
def test_module_loads_neither_jax_nor_the_jax_package(module):
    """Importing the module and calling it (a checkpoint round trip, a
    batch gather, a single-process ``initialize`` and an exchange, the
    sharded layouts of two ranks and a rank's share of them) in a fresh
    interpreter loads no jax and no hpfrec_tpu module."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import importlib, tempfile, numpy as np\n"
        f"m = importlib.import_module({module!r})\n"
        "if hasattr(m, 'save_checkpoint'):\n"
        "    from hpfrec_tpu_torch.models.state import VariationalState\n"
        "    d = tempfile.mkdtemp()\n"
        "    z = np.ones((2, 2))\n"
        "    m.save_checkpoint(d, VariationalState(z, z, z, z, z[:, :1], z[:, :1]), 3,\n"
        "                      rng=np.random.default_rng(1))\n"
        "    m.load_checkpoint(d)\n"
        "elif hasattr(m, 'initialize'):\n"
        "    import warnings, torch\n"
        "    from hpfrec_tpu_torch.parallel import engine\n"
        "    with warnings.catch_warnings():\n"
        "        warnings.simplefilter('ignore')\n"
        "        mesh = m.initialize(device='cpu')\n"
        "    assert engine.all_gather_rows(mesh, torch.ones(2, 3)).shape == (2, 3)\n"
        "elif hasattr(m, 'prepare_table_sharded'):\n"
        "    ip, ind, dat = np.array([0, 1, 3]), np.array([0, 1, 2], np.int32), np.ones(3)\n"
        "    ipt, indt = np.array([0, 1, 2, 3]), np.array([0, 1, 1], np.int32)\n"
        "    plan = m.prepare_table_sharded(ip, ind, dat, ipt, indt, dat, 2, 3, 2, 2, 4)\n"
        "    assert m.rank_share(plan.se_u, 1, 'cpu', plan.perm_u, 2).n_real == 1\n"
        "else:\n"
        "    m.get_unique_items_batch(np.array([0]), np.array([0, 2]), np.array([1, 0]), 1)\n"
        "bad = [n for n in set(sys.modules) - before\n"
        "       if n.split('.')[0] in ('jax', 'jaxlib', 'hpfrec_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=PKG.parent)


def test_chip_smoke_imports_no_jax():
    path = PKG.parent / "chip_smoke.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    for mod in _imported_modules(tree):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "hpfrec_tpu"), mod


def _code_strings(tree):
    """String constants of a module other than its docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.value


@pytest.mark.parametrize("path", [*FILES, PKG.parent / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(PKG.parent)))
def test_no_path_into_the_jax_package(path):
    """No code string of the port (build scripts included) names a path
    under hpfrec_tpu/; citations in docstrings and comments are fine, and
    chip_smoke's "replaces" entries name the reference file, not a path it
    reads."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for text in _code_strings(tree):
        if path.name == "chip_smoke.py" and re.fullmatch(r"hpfrec_tpu/[\w/]+\.py:\d+", text):
            continue
        assert not _JAX_PKG_PATH.search(text), f"{path.name} names {text!r}"


def test_native_build_reads_only_the_ports_source(monkeypatch):
    """The host helpers are compiled from the port's own csr_ops.cpp and
    nothing else; with OpenMP the object is linked against the runtime
    that PyTorch loaded, by its path."""
    from hpfrec_tpu_torch._native import build

    seen = []
    monkeypatch.setattr(build, "cached_build",
                        lambda cmd, sources, stem, key="", suffix=".so":
                        seen.append(list(sources)) or stem + suffix)
    built = build.build_native()
    src = PKG / "_native" / "csr_ops.cpp"
    assert seen[0] == [str(src)]
    assert src.is_file()
    if built.runtime == "openmp":
        assert seen[1:] == [["csr_ops_omp.o", build.torch_openmp()]]
    else:
        assert seen[1:] == []


def test_cuda_build_reads_only_the_ports_sources():
    from hpfrec_tpu_torch._cuda import build

    assert pathlib.Path(build.CSRC).resolve() == PKG / "csrc"
    assert {p.suffix for p in (PKG / "csrc").iterdir()} <= {".cu", ".cuh"}


TWINS = ["example/northstar_e2e_torch.py", "example/millionsong_scale_torch.py",
         "example/quickstart_torch.py", "scripts/quality_oracle_parity_torch.py"]
# what each twin runs in the subprocess check, at a tiny size on the CPU
_TWIN_CALLS = {
    "northstar_e2e_torch": "m.run_northstar(300, 200, 4_000, k=4, maxiter=4, device='cpu', "
                           "check_every=2, verbose=False)",
    "millionsong_scale_torch": "m.synth_tasteprofile(300, 200, 4_000)",
    "quickstart_torch": "m.sample_split(m.make_synthetic(300, 200, 4_000))",
    "quality_oracle_parity_torch": "m.run_parity(300, 200, 4_000, 4, 2, None, device='cpu')",
}


@pytest.mark.parametrize("relpath", TWINS)
def test_entry_point_twins_load_neither_jax_nor_the_jax_package(relpath):
    """The port's twins of the JAX repo's examples and quality script import
    no jax and no hpfrec_tpu, by their source and when run in a fresh
    interpreter."""
    import subprocess
    import sys

    path = PKG.parent / relpath
    tree = ast.parse(path.read_text(), filename=str(path))
    for mod in _imported_modules(tree):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "hpfrec_tpu"), mod
    code = (
        "import sys, importlib.util\n"
        "before = set(sys.modules)\n"
        f"spec = importlib.util.spec_from_file_location('twin', {str(path)!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        f"{_TWIN_CALLS[path.stem]}\n"
        "bad = [n for n in set(sys.modules) - before\n"
        "       if n.split('.')[0] in ('jax', 'jaxlib', 'hpfrec_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=PKG.parent, timeout=300)
