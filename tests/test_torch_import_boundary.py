"""The port imports neither JAX nor anything of the JAX package.

Checked in a fresh interpreter (this test process already imported jax
through the root conftest): every module of pydcop_tpu_torch is
imported (among them the resilience modules, the PRNG, the
delegating algorithms, the fused per-edge update, the observability
modules, the local-search slice: its algorithms, ops, the threefry
kernel's wrapper and the copied computation graphs, and the exact
slice: DPOP's ops, engine and algorithm, SyncBB, NCBB, the pseudo-tree
and ordered graph, and the window sum's wrapper, and the portfolio and
dynamic slice: the autotuner, the dynamic engine, the scenario model and
the YAML writers, and the batch and lane slice: the binning copy, the
lane ops and belief sum, the batched engine and the batch command,
and the serving slice: the service, scheduler, sessions, journal,
admission, retry, speculation, migration, link-fault seam, fleet trace,
HTTP front end, library cache and the serve and debug commands, and
the partitioned slice: the partitioner, the sharded engine's device
side, the multihost join and the halo reduction's wrapper, and the
fleet slice: the router, the phi-accrual estimator and the fleet
command, and the generators slice: the problem generators, the factor
graph, the rest of the graph helpers and the generate and graph
commands), then
``sys.modules`` must hold no ``jax*``
module and no ``pydcop_tpu``/``pydcop_tpu.*`` module.  The sources of
the package, of chip_smoke.py, chip_compare.py,
chip_var_update_compare.py and of the card-only test files of the local
search, the exact slice, the dynamic slice, the batch slice, the
serving slice, the partitioned slice, the fleet slice and the generated
problems are also
scanned for such
imports (the scan reads the imports inside functions too, such as the
portfolio racer's).
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
    "pydcop_tpu_torch.computations_graph.objects",
    "pydcop_tpu_torch.computations_graph.constraints_hypergraph",
    "pydcop_tpu_torch.ops.threefry",
    "pydcop_tpu_torch.ops.localsearch",
    "pydcop_tpu_torch.ops.dsa",
    "pydcop_tpu_torch.ops.mgm",
    "pydcop_tpu_torch.ops.mgm2",
    "pydcop_tpu_torch.algorithms.dsa",
    "pydcop_tpu_torch.algorithms.adsa",
    "pydcop_tpu_torch.algorithms.dsatuto",
    "pydcop_tpu_torch.algorithms.mgm",
    "pydcop_tpu_torch.algorithms.mgm2",
    "pydcop_tpu_torch.ops.window_sum",
    "pydcop_tpu_torch.ops.dpop",
    "pydcop_tpu_torch.engine.dpop",
    "pydcop_tpu_torch.algorithms.dpop",
    "pydcop_tpu_torch.algorithms.syncbb",
    "pydcop_tpu_torch.algorithms.ncbb",
    "pydcop_tpu_torch.computations_graph.pseudotree",
    "pydcop_tpu_torch.computations_graph.ordered_graph",
    "pydcop_tpu_torch.utils.graphs",
    "pydcop_tpu_torch.infrastructure.computations",
    "pydcop_tpu_torch.engine.autotune",
    "pydcop_tpu_torch.engine.dynamic",
    "pydcop_tpu_torch.dcop.scenario",
    "pydcop_tpu_torch.dcop.yamldcop",
    "pydcop_tpu_torch.serving.binning",
    "pydcop_tpu_torch.ops.maxsum_lane",
    "pydcop_tpu_torch.ops.lane_sum",
    "pydcop_tpu_torch.ops.lane_var_update",
    "pydcop_tpu_torch.engine.batch",
    "pydcop_tpu_torch.commands.batch",
    "pydcop_tpu_torch.resilience.retry",
    "pydcop_tpu_torch.serving",
    "pydcop_tpu_torch.serving.admission",
    "pydcop_tpu_torch.serving.journal",
    "pydcop_tpu_torch.serving.netfault",
    "pydcop_tpu_torch.observability.fleettrace",
    "pydcop_tpu_torch.serving.migration",
    "pydcop_tpu_torch.serving.sessions",
    "pydcop_tpu_torch.serving.scheduler",
    "pydcop_tpu_torch.serving.speculate",
    "pydcop_tpu_torch.serving.service",
    "pydcop_tpu_torch.serving.http",
    "pydcop_tpu_torch.engine.aotcache",
    "pydcop_tpu_torch.commands.serve",
    "pydcop_tpu_torch.commands.debug",
    "pydcop_tpu_torch.engine.partition",
    "pydcop_tpu_torch.engine.sharding",
    "pydcop_tpu_torch.engine.multihost",
    "pydcop_tpu_torch.ops.halo_sum",
    "pydcop_tpu_torch.serving.router",
    "pydcop_tpu_torch.resilience.health",
    "pydcop_tpu_torch.commands.fleet",
    "pydcop_tpu_torch.utils.various",
    "pydcop_tpu_torch.distribution.objects",
    "pydcop_tpu_torch.computations_graph.factor_graph",
    "pydcop_tpu_torch.generators",
    "pydcop_tpu_torch.generators.graphs",
    "pydcop_tpu_torch.generators.graphcoloring",
    "pydcop_tpu_torch.generators.ising",
    "pydcop_tpu_torch.generators.iot",
    "pydcop_tpu_torch.generators.smallworld",
    "pydcop_tpu_torch.generators.meetingscheduling",
    "pydcop_tpu_torch.generators.secp",
    "pydcop_tpu_torch.generators.agents_gen",
    "pydcop_tpu_torch.generators.scenario_gen",
    "pydcop_tpu_torch.commands._utils",
    "pydcop_tpu_torch.commands.generate",
    "pydcop_tpu_torch.commands.graph",
]

# The partitioned slice's modules, each scanned on its own below.
PARTITIONED_SLICE = [
    "pydcop_tpu_torch/engine/partition.py",
    "pydcop_tpu_torch/engine/sharding.py",
    "pydcop_tpu_torch/engine/multihost.py",
    "pydcop_tpu_torch/ops/halo_sum.py",
    "chip_smoke.py",
    "tests/test_torch_gpu_sharding.py",
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
       REPO / "chip_var_update_compare.py",
       REPO / "tests" / "test_torch_gpu_localsearch.py",
       REPO / "tests" / "test_torch_gpu_dpop.py",
       REPO / "tests" / "test_torch_gpu_dynamic.py",
       REPO / "tests" / "test_torch_gpu_batch.py",
       REPO / "tests" / "test_torch_gpu_serve.py",
       REPO / "tests" / "test_torch_gpu_sharding.py",
       REPO / "tests" / "test_torch_gpu_fleet.py",
       REPO / "tests" / "test_torch_gpu_fleet_elastic.py",
       REPO / "tests" / "test_torch_gpu_generated.py"]
)


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_neither_jax_nor_the_reference(source):
    for name in _imported_roots(REPO / source):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "pydcop_tpu"), (source, name)


@pytest.mark.parametrize("source", PARTITIONED_SLICE)
def test_partitioned_slice_imports_neither_jax_nor_the_reference(source):
    """The partitioned slice's modules exist and import neither JAX nor
    the JAX package (its partitioner is a copy, not an import)."""
    path = REPO / source
    assert path.exists(), source
    assert source in SOURCES
    roots = {name.split(".")[0] for name in _imported_roots(path)}
    assert not roots & {"jax", "jaxlib", "pydcop_tpu"}, (source, roots)


# The fleet slice's modules, each scanned on its own.
FLEET_SLICE = [
    "pydcop_tpu_torch/serving/router.py",
    "pydcop_tpu_torch/resilience/health.py",
    "pydcop_tpu_torch/commands/fleet.py",
    "pydcop_tpu_torch/observability/efficiency.py",
    "pydcop_tpu_torch/api.py",
    "chip_smoke.py",
    "tests/test_torch_gpu_fleet.py",
]


@pytest.mark.parametrize("source", FLEET_SLICE)
def test_fleet_slice_imports_neither_jax_nor_the_reference(source):
    """The fleet slice's modules exist and import neither JAX nor the
    JAX package (the router, its estimator and the forensics command
    are copies, not imports)."""
    path = REPO / source
    assert path.exists(), source
    assert source in SOURCES
    roots = {name.split(".")[0] for name in _imported_roots(path)}
    assert not roots & {"jax", "jaxlib", "pydcop_tpu"}, (source, roots)


# The elastic slice's modules, each scanned on its own.
ELASTIC_SLICE = [
    "pydcop_tpu_torch/serving/router.py",
    "pydcop_tpu_torch/serving/migration.py",
    "pydcop_tpu_torch/serving/netfault.py",
    "pydcop_tpu_torch/engine/multihost.py",
    "pydcop_tpu_torch/commands/serve.py",
    "pydcop_tpu_torch/api.py",
    "chip_smoke.py",
    "tests/test_torch_gpu_fleet_elastic.py",
]


@pytest.mark.parametrize("source", ELASTIC_SLICE)
def test_elastic_slice_imports_neither_jax_nor_the_reference(source):
    """The elastic slice's modules exist and import neither JAX nor the
    JAX package (the autoscaler, remote membership and the join
    announcement are copies, not imports), and none still refuses the
    elastic fleet."""
    path = REPO / source
    assert path.exists(), source
    assert source in SOURCES
    roots = {name.split(".")[0] for name in _imported_roots(path)}
    assert not roots & {"jax", "jaxlib", "pydcop_tpu"}, (source, roots)
    text = path.read_text(encoding="utf-8")
    for word in ("5(c)", "ELASTIC_NOT_PORTED", "refuse_elastic"):
        assert word not in text, (source, word)


# The generators and graph tooling slice's modules, each scanned on its
# own: no JAX, no JAX package, and no networkx outside the two bridge
# functions of utils/graphs.py, which import it inside themselves.
GENERATORS_SLICE = sorted(
    str(p.relative_to(REPO))
    for p in (REPO / "pydcop_tpu_torch" / "generators").glob("*.py")
) + [
    "pydcop_tpu_torch/utils/graphs.py",
    "pydcop_tpu_torch/utils/various.py",
    "pydcop_tpu_torch/computations_graph/factor_graph.py",
    "pydcop_tpu_torch/commands/_utils.py",
    "pydcop_tpu_torch/commands/generate.py",
    "pydcop_tpu_torch/commands/graph.py",
    "pydcop_tpu_torch/dcop_cli.py",
    "chip_smoke.py",
    "tests/test_torch_gpu_generated.py",
]


@pytest.mark.parametrize("source", GENERATORS_SLICE)
def test_generators_slice_imports_neither_jax_nor_networkx(source):
    """The generators and graph tooling exist, import neither JAX nor
    the JAX package, and import networkx only inside a function."""
    path = REPO / source
    assert path.exists(), source
    assert source in SOURCES
    roots = {name.split(".")[0] for name in _imported_roots(path)}
    assert not roots & {"jax", "jaxlib", "pydcop_tpu"}, (source, roots)
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in tree.body:
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        assert not any(n.split(".")[0] == "networkx" for n in names), source
