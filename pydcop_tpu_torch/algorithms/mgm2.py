"""MGM2: coordinated 2-opt local search (Maheswaran et al. 2004).

Port of the device path of ``pydcop_tpu/algorithms/mgm2.py`` (pyDCOP's
mgm2.py: threshold 0.5, favor unilateral/no/coordinated, stop_cycle).
The solve runs ``ops/mgm2.py::run_mgm2`` through
``engine/runner.py::run_device_fn``.
"""

from functools import partial

from pydcop_tpu_torch.algorithms import AlgoParameterDef, AlgorithmDef
from pydcop_tpu_torch.algorithms.mgm import lexic_ranks
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.engine.compile import (
    compile_dcop,
    validated_aggregation,
)
from pydcop_tpu_torch.engine.runner import DeviceRunResult, run_device_fn
from pydcop_tpu_torch.ops.mgm2 import run_mgm2

GRAPH_TYPE = "constraints_hypergraph"

HEADER_SIZE = 100
UNIT_SIZE = 5

algo_params = [
    # Variable aggregation of the shared reductions (see dsa).
    AlgoParameterDef(
        "aggregation", "str", ["scatter", "ell"], "scatter"
    ),
    AlgoParameterDef("threshold", "float", None, 0.5),
    AlgoParameterDef(
        "favor", "str", ["unilateral", "no", "coordinated"], "unilateral"
    ),
    AlgoParameterDef("stop_cycle", "int", None, 0),
    AlgoParameterDef("seed", "int", None, 0),
]


def computation_memory(node) -> float:
    # Two values kept per neighbour: value + gain (mgm2.py:88).
    return len(node.neighbors) * 2 * UNIT_SIZE


def communication_load(src, target: str) -> float:
    # Offer messages carry up to |d_src|*|d_target| (val, val, gain)
    # triples (mgm2.py:91-124).
    target_dom = None
    for c in src.constraints:
        for v in c.dimensions:
            if v.name == target:
                target_dom = len(v.domain)
    if target_dom is None:
        raise ValueError(
            f"target {target!r} is not a neighbor of {src.name}"
        )
    nb_pairs = target_dom * len(src.variable.domain)
    return nb_pairs * UNIT_SIZE * 3 + HEADER_SIZE


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
        run_mgm2,
        max_cycles=cycles,
        threshold=float(params.get("threshold", 0.5)),
        favor=params.get("favor", "unilateral"),
        lexic_ranks=lexic_ranks(meta),
        seed=params.get("seed", 0),
    )
    return run_device_fn(
        graph, meta, fn, mesh=mesh, n_devices=n_devices, warmup=warmup,
        finished=bool(params.get("stop_cycle")), device=device,
    )
