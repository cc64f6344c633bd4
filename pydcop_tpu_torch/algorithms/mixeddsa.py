"""MixedDSA: DSA for DCOPs mixing hard and soft constraints.

Port of the device path of ``pydcop_tpu/algorithms/mixeddsa.py``
(pyDCOP's mixeddsa.py: variant A/B/C, proba_hard 0.7, proba_soft 0.5,
stop_cycle; the parameters are declared exactly as the reference
declares them).  The solve compiles the DCOP, places it on ``device``
and runs ``ops/mixeddsa.py::run_mixeddsa`` through
``engine/runner.py::run_device_fn``.  Unlike DBA and GDBA it honours
``stop_cycle`` (the run's length, status FINISHED), as the reference.
"""

from functools import partial

from pydcop_tpu_torch.algorithms import AlgoParameterDef, AlgorithmDef
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.engine.compile import (
    compile_dcop,
    validated_aggregation,
)
from pydcop_tpu_torch.engine.runner import DeviceRunResult, run_device_fn
from pydcop_tpu_torch.ops.mixeddsa import run_mixeddsa

GRAPH_TYPE = "constraints_hypergraph"

HEADER_SIZE = 100
UNIT_SIZE = 5

algo_params = [
    # Variable aggregation of the shared reductions (see dsa); the
    # candidate sums scatter under either, as the reference's do.
    AlgoParameterDef(
        "aggregation", "str", ["scatter", "ell"], "scatter"
    ),
    AlgoParameterDef("proba_hard", "float", None, 0.7),
    AlgoParameterDef("proba_soft", "float", None, 0.5),
    AlgoParameterDef("variant", "str", ["A", "B", "C"], "B"),
    AlgoParameterDef("stop_cycle", "int", None, 0),
    AlgoParameterDef("seed", "int", None, 0),
]


def computation_memory(node) -> float:
    # One value per neighbour (reference mixeddsa.py:92).
    return len(node.neighbors) * UNIT_SIZE


def communication_load(src, target: str) -> float:
    # Value messages carry a single value (reference mixeddsa.py:116).
    return UNIT_SIZE + HEADER_SIZE


def solve_on_device(dcop: DCOP, algo_def: AlgorithmDef,
                    max_cycles: int = 1000, mesh=None, n_devices=None,
                    warmup: bool = False,
                    device: DeviceLike = "cuda") -> DeviceRunResult:
    params = algo_def.params
    pad_to = mesh.size if mesh is not None else (n_devices or 1)
    graph, meta = compile_dcop(
        dcop, pad_to=pad_to,
        aggregation=validated_aggregation(params, pad_to))
    cycles = params.get("stop_cycle") or max_cycles
    fn = partial(
        run_mixeddsa,
        max_cycles=cycles,
        variant=params.get("variant", "B"),
        proba_hard=float(params.get("proba_hard", 0.7)),
        proba_soft=float(params.get("proba_soft", 0.5)),
        seed=params.get("seed", 0),
    )
    return run_device_fn(
        graph, meta, fn, mesh=mesh, n_devices=n_devices, warmup=warmup,
        finished=bool(params.get("stop_cycle")), device=device,
    )
