"""MaxSum: synchronous belief propagation on the factor graph.

Port of the device path of ``pydcop_tpu/algorithms/maxsum.py``.  The
parameters are declared exactly as the reference declares them, so a
parameter set valid there is valid here; the ones whose machinery is
not ported yet (decimation, the lane layout, multi-device runs and
partitioned shards) raise ``NotImplementedError`` instead of being
silently ignored.  ``aggregation="auto"`` measures the strategies on
the compiled graph (``engine/autotune.py``) or replays a stored
decision before compiling.
"""

import time
from functools import partial
from typing import Optional

from pydcop_tpu_torch.algorithms import AlgoParameterDef, AlgorithmDef
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.engine.compile import (
    compile_dcop,
    validated_aggregation,
)
from pydcop_tpu_torch.engine.runner import DeviceRunResult, MaxSumEngine

STABILITY_COEFF = 0.1

algo_params = [
    AlgoParameterDef("damping", "float", None, 0.5),
    AlgoParameterDef(
        "damping_nodes", "str", ["vars", "factors", "both", "none"], "both"
    ),
    AlgoParameterDef("stability", "float", None, STABILITY_COEFF),
    AlgoParameterDef("noise", "float", None, 0.01),
    # The batched engine fires every factor and variable each cycle
    # (start_messages=all semantics); accepted for compatibility.
    AlgoParameterDef(
        "start_messages", "str", ["leafs", "leafs_vars", "all"], "all"
    ),
    AlgoParameterDef("decimation", "int", None, 0),
    AlgoParameterDef("decimation_margin", "float", None, 0.0),
    AlgoParameterDef("prune", "bool", None, False),
    AlgoParameterDef(
        "aggregation", "str",
        ["scatter", "sorted", "ell", "auto"], "scatter"
    ),
    AlgoParameterDef("layout", "str", ["edge", "lane"], "edge"),
]


def _replay_auto_choice(dcop: DCOP, device: DeviceLike):
    """A stored autotune decision, looked up before compiling by the
    DCOP's shape key on this device's backend.  Returns
    ``(aggregation to compile with, metrics or None)``: on a miss,
    scatter and None (the caller compiles and measures)."""
    from pydcop_tpu_torch.engine.autotune import (
        cached_choice,
        dcop_shape_key,
    )

    key = dcop_shape_key(dcop, resolve_device(device).type)
    choice = cached_choice(key)
    if choice is None:
        return "scatter", None
    return choice, {
        "aggregation": choice,
        "aggregation_source": "cache",
        "aggregation_key": key,
    }


def build_engine(dcop: DCOP, params: dict, mesh=None,
                 n_devices: Optional[int] = None,
                 shards: Optional[int] = None,
                 device: DeviceLike = "cuda") -> MaxSumEngine:
    """Compile + construct the engine from validated algo params.

    ``aggregation="auto"`` replays a stored decision when there is one;
    otherwise it compiles with scatter, measures the strategies on the
    compiled graph on ``device`` (``engine/autotune.py``) and swaps in
    the winner's arrays.  Either way the engine's results report the
    decision in their metrics."""
    if shards is not None and shards > 1:
        raise NotImplementedError(
            "partitioned sharding (shards=) is not ported yet")
    if params.get("decimation", 0) or params.get("decimation_margin", 0.0):
        raise NotImplementedError("decimation is not ported yet")
    pad_to = 1
    if mesh is not None:
        pad_to = mesh.size
    elif n_devices:
        pad_to = n_devices
    auto = params.get("aggregation") == "auto"
    aggregation = validated_aggregation(params, pad_to)
    agg_info = None
    if aggregation == "auto":
        aggregation = "scatter"
    elif auto:
        agg_info = {"aggregation": "scatter",
                    "aggregation_source": "mesh"}
    if auto and agg_info is None:
        aggregation, agg_info = _replay_auto_choice(dcop, device)
    graph, meta = compile_dcop(
        dcop, noise_level=params.get("noise", 0.01), pad_to=pad_to,
        aggregation=aggregation,
    )
    if auto and agg_info is None:
        from pydcop_tpu_torch.engine.autotune import (
            apply_aggregation,
            autotune_aggregation,
        )

        agg_info = autotune_aggregation(graph, pad_to=pad_to,
                                        device=device)
        if agg_info["aggregation"] != "scatter":
            # The winner was built while it was timed, so its builder
            # does not refuse it here.
            graph = apply_aggregation(graph, agg_info["aggregation"])
    engine = MaxSumEngine(
        graph, meta,
        damping=params.get("damping", 0.5),
        damping_nodes=params.get("damping_nodes", "both"),
        stability=params.get("stability", STABILITY_COEFF),
        mesh=mesh, n_devices=n_devices,
        layout=params.get("layout", "edge"),
        prune=bool(params.get("prune", False)),
        device=device,
    )
    if agg_info is not None:
        engine.extra_metrics.update(agg_info)
    return engine


def solve_on_device(dcop: DCOP, algo_def: AlgorithmDef,
                    max_cycles: int = 1000, mesh=None,
                    n_devices: Optional[int] = None,
                    shards: Optional[int] = None,
                    warmup: bool = False,
                    device: DeviceLike = "cuda") -> DeviceRunResult:
    """Batched BSP MaxSum on one torch device."""
    engine = build_engine(dcop, algo_def.params, mesh=mesh,
                          n_devices=n_devices, shards=shards,
                          device=device)
    run = partial(engine.run, max_cycles=max_cycles)
    if warmup:
        # Build the kernels and fill the caching allocator first, so
        # the timed run is steady-state (each run starts from fresh
        # messages, so re-running is side-effect free).
        t0 = time.perf_counter()
        run()
        warm_s = time.perf_counter() - t0
        res = run()
        res.metrics["warmup_time_s"] = warm_s
        return res
    return run()
