"""A-DSA: asynchronous DSA, clock-driven.

Port of the device path of ``pydcop_tpu/algorithms/adsa.py`` (pyDCOP's
adsa.py: variant, probability, period 0.5), whose docstring gives the
measured semantics of its two schedules:

- ``schedule=lockstep`` (default): every variable is evaluated each
  superstep — the dsa solve with ``p_mode`` fixed (``period`` is
  accepted for compatibility);
- ``schedule=staggered``: the variable graph is greedily coloured
  (``ops/dsa.py::greedy_classes``) and each superstep only one colour
  class may flip; one adsa cycle is a full sweep over the classes, so
  the budget is scaled by the class count and reported in sweeps
  (``metrics['schedule']``, ``['n_classes']``, ``['supersteps']``).
"""

from functools import partial

from pydcop_tpu_torch.algorithms import AlgoParameterDef, AlgorithmDef
from pydcop_tpu_torch.algorithms import dsa as _dsa
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.engine.compile import (
    compile_dcop,
    validated_aggregation,
)
from pydcop_tpu_torch.engine.runner import DeviceRunResult, run_device_fn
from pydcop_tpu_torch.ops.dsa import greedy_classes, run_dsa

GRAPH_TYPE = "constraints_hypergraph"

algo_params = [
    # Variable aggregation of the shared reductions (see dsa).
    AlgoParameterDef(
        "aggregation", "str", ["scatter", "ell"], "scatter"
    ),
    AlgoParameterDef("probability", "float", None, 0.7),
    AlgoParameterDef("variant", "str", ["A", "B", "C"], "B"),
    AlgoParameterDef("period", "float", None, 0.5),
    AlgoParameterDef("stop_cycle", "int", None, 0),
    AlgoParameterDef("seed", "int", None, 0),
    AlgoParameterDef("schedule", "str", ["lockstep", "staggered"],
                     "lockstep"),
]

computation_memory = _dsa.computation_memory
communication_load = _dsa.communication_load


def solve_on_device(dcop: DCOP, algo_def: AlgorithmDef,
                    max_cycles: int = 1000, mesh=None, n_devices=None,
                    warmup: bool = False,
                    device: DeviceLike = "cuda") -> DeviceRunResult:
    params = algo_def.params
    if params.get("schedule", "lockstep") == "staggered":
        return _solve_staggered(
            dcop, algo_def, max_cycles=max_cycles, mesh=mesh,
            n_devices=n_devices, warmup=warmup, device=device,
        )
    inner = AlgorithmDef(
        "dsa",
        {
            "probability": params.get("probability", 0.7),
            "p_mode": "fixed",
            "variant": params.get("variant", "B"),
            "stop_cycle": params.get("stop_cycle", 0),
            "seed": params.get("seed", 0),
        },
        algo_def.mode,
    )
    return _dsa.solve_on_device(
        dcop, inner, max_cycles=max_cycles, mesh=mesh,
        n_devices=n_devices, warmup=warmup, device=device,
    )


def _solve_staggered(dcop: DCOP, algo_def: AlgorithmDef, *,
                     max_cycles: int, mesh, n_devices, warmup,
                     device: DeviceLike) -> DeviceRunResult:
    """Graph-coloured schedule: one superstep flips one colour class;
    one cycle (the budget unit) is a full sweep over the classes."""
    params = algo_def.params
    pad_to = mesh.size if mesh is not None else (n_devices or 1)
    graph, meta = compile_dcop(
        dcop, pad_to=pad_to,
        aggregation=validated_aggregation(params, pad_to))
    classes, n_classes = greedy_classes(graph)
    cycles = params.get("stop_cycle") or max_cycles
    fn = partial(
        run_dsa,
        max_cycles=cycles * n_classes,
        variant=params.get("variant", "B"),
        probability=params.get("probability", 0.7),
        seed=params.get("seed", 0),
        classes=classes,
        n_classes=n_classes,
    )
    res = run_device_fn(
        graph, meta, fn, mesh=mesh, n_devices=n_devices, warmup=warmup,
        finished=bool(params.get("stop_cycle")), device=device,
    )
    res.metrics["schedule"] = "staggered"
    res.metrics["n_classes"] = n_classes
    res.metrics["supersteps"] = res.cycles
    # Report budget-comparable cycles (full sweeps).
    res.cycles = res.cycles // n_classes
    return res
