"""Nothing a run loads is JAX or the JAX package (top-level names
compared whole: ``repro_torch`` is not ``repro``), the references import
nothing of the program, and nothing reads the old ``benchmarks/``."""
import ast
import subprocess
import sys

from conftest import ROOT

BENCH = ROOT / "perfbench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _top(name):
    return name.split(".")[0]


def test_no_jax_or_jax_package_in_sources():
    for path in BENCH.rglob("*.py"):
        tops = {_top(n) for n in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        assert "benchmarks" not in tops, path
        if path.parent.name != "tests":
            assert "benchmarks/" not in path.read_text(), path


def test_references_import_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {_top(n) for n in _imports(path)}
        assert "repro_torch" not in tops, path
        assert not {n for n in _imports(path)
                    if n.startswith("perfbench.drivers")}, path


def test_top_level_names_compared_whole():
    sys.path.insert(0, str(BENCH))
    import importlib.util
    spec = importlib.util.spec_from_file_location("pb_run", BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert "repro_torch" not in mod.FORBIDDEN
    assert {"jax", "repro"} <= mod.FORBIDDEN


def test_a_run_loads_no_jax():
    """A whole run of the training cell at a small size on the CPU, in a
    process of its own, then the run's own check of ``sys.modules``."""
    code = f"""
import sys
sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(ROOT / 'src')!r}, {str(ROOT)!r}]
from conftest import tiny, TRAIN
from perfbench import run
cfg, traffic = tiny(TRAIN)
res = run.execute(TRAIN, 7, 0.1, False, "cpu", config=cfg, traffic=traffic)
assert res["correct"], res
print("FORBIDDEN", run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
