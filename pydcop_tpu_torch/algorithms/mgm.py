"""MGM: Maximum Gain Message — monotone distributed local search.

Port of the device path of ``pydcop_tpu/algorithms/mgm.py`` (pyDCOP's
mgm.py: break_mode lexic/random, stop_cycle).  The solve runs
``ops/mgm.py::run_mgm`` through ``engine/runner.py::run_device_fn``.
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
from pydcop_tpu_torch.ops.mgm import run_mgm

GRAPH_TYPE = "constraints_hypergraph"

HEADER_SIZE = 0
UNIT_SIZE = 1

algo_params = [
    # Variable aggregation of the shared reductions (see dsa).
    AlgoParameterDef(
        "aggregation", "str", ["scatter", "ell"], "scatter"
    ),
    AlgoParameterDef("break_mode", "str", ["lexic", "random"], "lexic"),
    AlgoParameterDef("stop_cycle", "int", None, 0),
    AlgoParameterDef("seed", "int", None, 0),
]


def computation_memory(node) -> float:
    return chg.computation_memory(node)


def communication_load(src, target: str) -> float:
    return chg.communication_load(src, target)


def lexic_ranks(meta) -> np.ndarray:
    """Rank of each variable in lexical name order ([V+1] float32,
    sentinel +inf) — pyDCOP's sorted-name tie-break (mgm.py:571)."""
    order = {name: i for i, name in enumerate(sorted(meta.var_names))}
    ranks = np.empty(len(meta.var_names) + 1, dtype=np.float32)
    for i, name in enumerate(meta.var_names):
        ranks[i] = order[name]
    ranks[-1] = np.inf
    return ranks


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
        run_mgm,
        max_cycles=cycles,
        lexic_ranks=lexic_ranks(meta),
        break_mode=params.get("break_mode", "lexic"),
        seed=params.get("seed", 0),
    )
    return run_device_fn(
        graph, meta, fn, mesh=mesh, n_devices=n_devices, warmup=warmup,
        finished=bool(params.get("stop_cycle")), device=device,
    )
