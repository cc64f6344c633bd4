"""DSA-tuto: the minimal tutorial DSA.

Port of the device path of ``pydcop_tpu/algorithms/dsatuto.py`` (pyDCOP's
dsatuto.py: DSA-A at a fixed probability of 0.7): the full dsa solve
pinned to variant A.
"""

from pydcop_tpu_torch.algorithms import AlgoParameterDef, AlgorithmDef
from pydcop_tpu_torch.algorithms import dsa as _dsa
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.engine.runner import DeviceRunResult

GRAPH_TYPE = "constraints_hypergraph"

algo_params = [
    AlgoParameterDef("variant", "str", ["A"], "A"),
    AlgoParameterDef("stop_cycle", "int", None, 0),
    AlgoParameterDef("seed", "int", None, 0),
]

computation_memory = _dsa.computation_memory
communication_load = _dsa.communication_load


def solve_on_device(dcop: DCOP, algo_def: AlgorithmDef,
                    max_cycles: int = 1000, mesh=None, n_devices=None,
                    warmup: bool = False,
                    device: DeviceLike = "cuda") -> DeviceRunResult:
    inner = AlgorithmDef(
        "dsa",
        {
            "probability": 0.7,
            "p_mode": "fixed",
            "variant": "A",
            "stop_cycle": algo_def.params.get("stop_cycle", 0),
            "seed": algo_def.params.get("seed", 0),
        },
        algo_def.mode,
    )
    return _dsa.solve_on_device(
        dcop, inner, max_cycles=max_cycles, mesh=mesh,
        n_devices=n_devices, warmup=warmup, device=device,
    )
