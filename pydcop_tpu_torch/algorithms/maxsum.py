"""MaxSum: synchronous belief propagation on the factor graph.

Port of the device path of ``pydcop_tpu/algorithms/maxsum.py``.  The
parameters are declared exactly as the reference declares them, so a
parameter set valid there is valid here.  ``shards=N`` runs the
partitioned engine (``engine/sharding.py``); the replicated-variable
mesh (``mesh``/``n_devices``) is not ported yet and raises
``NotImplementedError`` instead of being silently ignored.
``layout="lane"`` runs the lane-major ops (``ops/maxsum_lane.py``).
``aggregation="auto"`` measures the strategies on the compiled graph
(``engine/autotune.py``) or replays a stored decision before
compiling.  ``decimation`` / ``decimation_margin`` run the
segmented solve (``MaxSumEngine.run_checkpointed``) with a
``DecimationPlan``.
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
from pydcop_tpu_torch.engine.runner import (
    DecimationPlan,
    DeviceRunResult,
    MaxSumEngine,
    ShardedMaxSumEngine,
)

GRAPH_TYPE = "factor_graph"

STABILITY_COEFF = 0.1

# The partitioned engine (shards=) runs this algorithm.
SUPPORTS_SHARDS = True

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


def decimation_plan_from_params(params: dict) -> Optional[DecimationPlan]:
    """The ``decimation`` / ``decimation_margin`` params as a
    :class:`DecimationPlan` (None = off).

    ``decimation:N`` alone is the classic schedule: the top N % of free
    variables by belief margin clamped per round until everything is
    fixed.  ``decimation_margin:M`` switches to threshold mode: only
    variables whose margin exceeds M clamp (at most N % per round when
    both are given), and nothing is forced."""
    n = int(params.get("decimation", 0) or 0)
    margin = float(params.get("decimation_margin", 0.0) or 0.0)
    if n <= 0 and margin <= 0:
        return None
    return DecimationPlan(
        margin=margin,
        frac_per_round=(n / 100.0) if n > 0 else 1.0,
        force_progress=margin <= 0,
    )


def build_engine(dcop: DCOP, params: dict, mesh=None,
                 n_devices: Optional[int] = None,
                 shards: Optional[int] = None,
                 device: DeviceLike = "cuda") -> MaxSumEngine:
    """Compile + construct the engine from validated algo params.

    ``aggregation="auto"`` replays a stored decision when there is one;
    otherwise it compiles with scatter, measures the strategies on the
    compiled graph on ``device`` (``engine/autotune.py``) and swaps in
    the winner's arrays.  Either way the engine's results report the
    decision in their metrics.

    ``shards=N`` (N >= 2) builds the PARTITIONED engine
    (:class:`ShardedMaxSumEngine` on ``multihost.partitioned_mesh``):
    a min-edge-cut partition assigns variables and factors to shards
    and only cut-edge (halo) state crosses shards per superstep.  It
    refuses, in the reference's order, ``mesh``/``n_devices``, the
    lane layout, decimation and a non-scatter aggregation."""
    if shards is not None and shards > 1:
        if mesh is not None or n_devices:
            raise ValueError(
                "shards= (partitioned engine) and mesh=/n_devices= "
                "(replicated sharding) are mutually exclusive")
        if params.get("layout", "edge") == "lane":
            raise ValueError(
                "layout='lane' is single-device; the partitioned "
                "engine uses the edge layout")
        if decimation_plan_from_params(params) is not None:
            raise ValueError(
                "decimation clamps the single-device var_costs "
                "table; run without shards=")
        # The partitioned superstep aggregates locally with scatter:
        # the mesh aggregation policy (auto -> scatter, anything else
        # refused).
        aggregation = validated_aggregation(params, max(shards, 2))
        from pydcop_tpu_torch.engine.multihost import partitioned_mesh

        graph, meta = compile_dcop(
            dcop, noise_level=params.get("noise", 0.01),
            aggregation=aggregation,
        )
        return ShardedMaxSumEngine(
            graph, meta,
            mesh=partitioned_mesh(shards, device),
            damping=params.get("damping", 0.5),
            damping_nodes=params.get("damping_nodes", "both"),
            stability=params.get("stability", STABILITY_COEFF),
            prune=bool(params.get("prune", False)),
            device=device,
        )
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
    if auto and agg_info is None and params.get("layout", "edge") == "lane":
        # The lane layout carries its own scatter aggregation; nothing
        # to tune.
        agg_info = {"aggregation": "scatter",
                    "aggregation_source": "lane"}
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
    """Batched BSP MaxSum on one torch device.  A decimated solve runs
    segmented, one round per segment; ``warmup`` does not apply to it
    (its ``cycles_per_s`` already leaves the kernels' build out)."""
    engine = build_engine(dcop, algo_def.params, mesh=mesh,
                          n_devices=n_devices, shards=shards,
                          device=device)
    plan = decimation_plan_from_params(algo_def.params)
    if plan is not None:
        return engine.run_checkpointed(
            max_cycles=max_cycles,
            segment_cycles=plan.cycles_per_round,
            decimation=plan,
        )
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
