"""A-MaxSum: asynchronous MaxSum.

Port of the device path of ``pydcop_tpu/algorithms/amaxsum.py``.  On
the batched engine, asynchrony has no meaning — every message row
updates each superstep, the "fully fired" schedule of the asynchronous
execution — so the device solve is MaxSum's, with MaxSum's parameters.
"""

from typing import Optional

from pydcop_tpu_torch.algorithms import AlgorithmDef
from pydcop_tpu_torch.algorithms import maxsum as _maxsum
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.engine.runner import DeviceRunResult

algo_params = list(_maxsum.algo_params)

GRAPH_TYPE = "factor_graph"

# Same engine as maxsum, so partitioned sharding (shards=) comes
# through the shared build_engine.
SUPPORTS_SHARDS = True


def solve_on_device(dcop: DCOP, algo_def: AlgorithmDef,
                    max_cycles: int = 1000, mesh=None,
                    n_devices: Optional[int] = None,
                    shards: Optional[int] = None,
                    warmup: bool = False,
                    device: DeviceLike = "cuda") -> DeviceRunResult:
    return _maxsum.solve_on_device(
        dcop, algo_def, max_cycles=max_cycles, mesh=mesh,
        n_devices=n_devices, shards=shards, warmup=warmup, device=device,
    )
