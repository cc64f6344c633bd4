"""DBA: Distributed Breakout Algorithm — constraint satisfaction.

Port of the device path of ``pydcop_tpu/algorithms/dba.py`` (pyDCOP's
dba.py: infinity 10000, max_distance 50, stop_cycle; the parameters are
declared exactly as the reference declares them).  The solve compiles
the DCOP, places it on ``device`` and runs ``ops/dba.py::run_dba``
through ``engine/runner.py::run_device_fn``.  As the reference, it
refuses ``objective="max"`` and accepts ``stop_cycle`` without using
it (the run ends at its termination counters or ``max_cycles``).
"""

from functools import partial

from pydcop_tpu_torch.algorithms import AlgoParameterDef, AlgorithmDef
from pydcop_tpu_torch.algorithms.mgm import lexic_ranks
from pydcop_tpu_torch.computations_graph import constraints_hypergraph as chg
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.engine.compile import (
    compile_dcop,
    validated_aggregation,
)
from pydcop_tpu_torch.engine.runner import DeviceRunResult, run_device_fn
from pydcop_tpu_torch.ops.dba import run_dba

GRAPH_TYPE = "constraints_hypergraph"

HEADER_SIZE = 100
UNIT_SIZE = 5

algo_params = [
    # Variable aggregation of the shared reductions (see dsa).
    AlgoParameterDef(
        "aggregation", "str", ["scatter", "ell"], "scatter"
    ),
    AlgoParameterDef("infinity", "int", None, 10000),
    AlgoParameterDef("max_distance", "int", None, 50),
    AlgoParameterDef("stop_cycle", "int", None, 0),
    AlgoParameterDef("seed", "int", None, 0),
]


def computation_memory(node) -> float:
    return chg.computation_memory(node)


def communication_load(src, target: str) -> float:
    # ok/improve messages carry a value and an improvement (dba.py:92).
    return 2 * UNIT_SIZE + HEADER_SIZE


def solve_on_device(dcop: DCOP, algo_def: AlgorithmDef,
                    max_cycles: int = 1000, mesh=None, n_devices=None,
                    warmup: bool = False,
                    device: DeviceLike = "cuda") -> DeviceRunResult:
    if dcop.objective != "min":
        raise ValueError(
            "DBA is a constraint satisfaction algorithm and only "
            "supports minimization (reference dba.py:295)"
        )
    params = algo_def.params
    pad_to = mesh.size if mesh is not None else (n_devices or 1)
    graph, meta = compile_dcop(
        dcop, pad_to=pad_to,
        aggregation=validated_aggregation(params, pad_to))
    fn = partial(
        run_dba,
        max_cycles=max_cycles,
        infinity=float(params.get("infinity", 10000)),
        max_distance=int(params.get("max_distance", 50)),
        lexic_ranks=lexic_ranks(meta),
        seed=params.get("seed", 0),
    )
    return run_device_fn(graph, meta, fn, mesh=mesh, n_devices=n_devices,
                         warmup=warmup, device=device)
