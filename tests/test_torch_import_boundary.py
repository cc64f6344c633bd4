"""The port imports neither JAX nor anything of the JAX package.

Checked in a fresh interpreter (this test process already imported jax
through the root conftest): every module of pydcop_tpu_torch is
imported (among them the resilience modules, the PRNG, the
delegating algorithms, the fused per-edge update and the observability
modules), then ``sys.modules`` must hold no ``jax*``
module and no ``pydcop_tpu``/``pydcop_tpu.*`` module.  The sources of
the package, of chip_smoke.py, chip_compare.py and
chip_var_update_compare.py are also scanned for such imports.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (imported first: JAX stays on the CPU)
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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
print(json.dumps({"modules": names, "bad": bad}))
"""

# Modules that must be among those imported (the later slices' too).
REQUIRED = [
    "pydcop_tpu_torch.resilience.checkpoint",
    "pydcop_tpu_torch.resilience.recovery",
    "pydcop_tpu_torch.utils.prng",
    "pydcop_tpu_torch.utils.tree",
    "pydcop_tpu_torch.algorithms.amaxsum",
    "pydcop_tpu_torch.algorithms.maxsum_dynamic",
    "pydcop_tpu_torch.ops.var_update",
    "pydcop_tpu_torch.ops.flush",
    "pydcop_tpu_torch.observability",
    "pydcop_tpu_torch.observability.trace",
    "pydcop_tpu_torch.observability.metrics",
    "pydcop_tpu_torch.observability.flight",
    "pydcop_tpu_torch.observability.profiler",
    "pydcop_tpu_torch.observability.engine_probe",
    "pydcop_tpu_torch.observability.efficiency",
    "pydcop_tpu_torch.observability.server",
    "pydcop_tpu_torch.engine.roofline",
    "pydcop_tpu_torch.utils.cleanenv",
    "pydcop_tpu_torch.commands.trace",
    "pydcop_tpu_torch.commands.profile",
]


def test_no_jax_or_reference_module_is_loaded():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["modules"]) >= 15
    missing = [m for m in REQUIRED if m not in out["modules"]]
    assert missing == [], f"not imported: {missing}"
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
    + [REPO / "chip_smoke.py", REPO / "chip_compare.py",
       REPO / "chip_var_update_compare.py"]
)


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_neither_jax_nor_the_reference(source):
    for name in _imported_roots(REPO / source):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "pydcop_tpu"), (source, name)
