"""The port imports neither JAX nor anything of the JAX package.

Checked in a fresh interpreter (this test process already imported jax
through the root conftest): every module of pydcop_tpu_torch is
imported, then ``sys.modules`` must hold no ``jax*`` module and no
``pydcop_tpu``/``pydcop_tpu.*`` module.  The sources of the package,
of chip_smoke.py and of chip_compare.py are also scanned for such
imports.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (imported first: JAX stays on the CPU)
import pytest

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import pydcop_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    pydcop_tpu_torch.__path__, "pydcop_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k.startswith("jaxlib")
             or k == "pydcop_tpu" or k.startswith("pydcop_tpu."))
print(json.dumps({"modules": len(names), "bad": bad}))
"""


def test_no_jax_or_reference_module_is_loaded():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["modules"] >= 15
    assert out["bad"] == [], f"the port pulled in: {out['bad']}"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


SOURCES = sorted(
    str(p.relative_to(REPO))
    for p in list((REPO / "pydcop_tpu_torch").rglob("*.py"))
    + [REPO / "chip_smoke.py", REPO / "chip_compare.py"]
)


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_neither_jax_nor_the_reference(source):
    for name in _imported_roots(REPO / source):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "pydcop_tpu"), (source, name)
