"""DSA: Distributed Stochastic Algorithm (variants A/B/C).

Port of the device path of ``pydcop_tpu/algorithms/dsa.py`` (pyDCOP's
dsa.py: probability 0.7, p_mode fixed/arity, variant B, stop_cycle; the
parameters are declared exactly as the reference declares them).  The
solve compiles the DCOP, places it on ``device`` and runs
``ops/dsa.py::run_dsa`` through ``engine/runner.py::run_device_fn``.
"""

from functools import partial

import numpy as np

from pydcop_tpu_torch.algorithms import AlgoParameterDef, AlgorithmDef
from pydcop_tpu_torch.computations_graph import constraints_hypergraph as chg
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.engine.compile import (
    compile_dcop,
    validated_aggregation,
)
from pydcop_tpu_torch.engine.runner import DeviceRunResult, run_device_fn
from pydcop_tpu_torch.ops.dsa import run_dsa

GRAPH_TYPE = "constraints_hypergraph"

HEADER_SIZE = 0
UNIT_SIZE = 1

algo_params = [
    # Variable aggregation of the shared reductions (ops/localsearch.py):
    # "scatter" (the hand kernel's positional sum on the card) or "ell"
    # (dense gathers through the compiled ELL lists).
    AlgoParameterDef(
        "aggregation", "str", ["scatter", "ell"], "scatter"
    ),
    AlgoParameterDef("probability", "float", None, 0.7),
    AlgoParameterDef("p_mode", "str", ["fixed", "arity"], "fixed"),
    AlgoParameterDef("variant", "str", ["A", "B", "C"], "B"),
    AlgoParameterDef("stop_cycle", "int", None, 0),
    AlgoParameterDef("seed", "int", None, 0),
]


def computation_memory(node) -> float:
    return chg.computation_memory(node)


def communication_load(src, target: str) -> float:
    return chg.communication_load(src, target)


def _arity_probabilities(graph, probability: float) -> np.ndarray:
    """p_mode=arity: p = 1.2 / sum(arity-1 over incident constraints)
    (pyDCOP's dsa.py:257-263), [V+1] float32 from the compiled graph."""
    n = graph.var_costs.shape[0]
    n_count = np.zeros(n, dtype=np.float64)
    for b in graph.buckets:
        arity = b.var_ids.shape[1]
        if arity < 2:
            continue
        for p in range(arity):
            np.add.at(n_count, np.asarray(b.var_ids[:, p]), arity - 1)
    probs = np.full(n, probability, dtype=np.float32)
    mask = n_count > 0
    probs[mask] = 1.2 / n_count[mask]
    return probs


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
    probability = params.get("probability", 0.7)
    if params.get("p_mode") == "arity":
        probability = _arity_probabilities(graph, probability)
    fn = partial(
        run_dsa,
        max_cycles=cycles,
        variant=params.get("variant", "B"),
        probability=probability,
        seed=params.get("seed", 0),
    )
    return run_device_fn(
        graph, meta, fn, mesh=mesh, n_devices=n_devices, warmup=warmup,
        finished=bool(params.get("stop_cycle")), device=device,
    )
