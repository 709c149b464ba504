"""Nothing the benchmark runs imports jax, jaxlib, flax or the JAX package
hlod_gaussians_tpu, compared by the whole top-level name (the port's name
begins with the JAX package's): an AST scan of every source under
benchmark/, and the modules loaded by a tiny run in a fresh interpreter."""

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

from benchmark.harness.core import FORBIDDEN

SOURCES = sorted((ROOT / "benchmark").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_forbidden(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names = [node.args[0].value]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, node.lineno)


def test_a_run_loads_nothing_forbidden():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, "
        f"{str(ROOT / 'benchmark' / 'tests')!r}]\n"
        "from conftest import TINY\n"
        "from benchmark.harness import core\n"
        "for cell in sorted(TINY):\n"
        "    core.run_cell(cell, 1, 0.2, False, device='cpu',\n"
        "                  overrides=TINY[cell])\n"
        "bad = core.forbidden_modules()\n"
        "print(sorted(m for m in sys.modules if m.startswith('hlod')), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert "hlod_gaussians_torch" in proc.stdout


def test_the_check_compares_whole_names():
    from benchmark.harness import core
    sys.modules.setdefault("hlod_gaussians_tpu_lookalike", sys)
    try:
        assert "hlod_gaussians_tpu_lookalike" not in core.forbidden_modules()
    finally:
        del sys.modules["hlod_gaussians_tpu_lookalike"]
