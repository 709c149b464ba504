"""The PyTorch port stands alone: no module of hlod_gaussians_torch, and
none of chip_smoke.py, bench_torch.py and the scripts
torch_frame_profile.py, torch_pipeline_full_steps.py and
torch_merge_bisect.py, imports jax or hlod_gaussians_tpu — checked by an
AST scan of the sources and by importing every module in a fresh
interpreter and reading its sys.modules."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "hlod_gaussians_torch"
FORBIDDEN = ("jax", "jaxlib", "hlod_gaussians_tpu")


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "bench_torch.py",
        ROOT / "scripts" / "torch_frame_profile.py",
        ROOT / "scripts" / "torch_pipeline_full_steps.py",
        ROOT / "scripts" / "torch_merge_bisect.py"]


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names = [node.args[0].value]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, node.lineno,
                                                         name)


def test_importing_the_port_loads_no_jax():
    mods = _modules()
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(mods) >= 14
