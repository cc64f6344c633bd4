"""High-level solve API of the port.

Port of the device backend of ``pydcop_tpu/api.py`` ``solve``: compile
the DCOP, run the algorithm's device engine, and score the assignment
on the host with ``DCOP.solution_cost``.  The result carries the same
keys as the reference's device solve.  ``device`` defaults to
``"cuda"``; without a card it raises unless ``device="cpu"`` is passed.
Checkpointing, recovery, decimation and observation route the solve
through the engine's segmented loop (``MaxSumEngine.run_checkpointed``),
as the reference's ``_solve`` does.
"""

import time
from typing import Any, Dict, Optional, Union

from pydcop_tpu_torch.algorithms import AlgorithmDef, load_algorithm_module
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike, resolve_device


class SolveResult(dict):
    """Dict-like result: assignment, cost, violations, cycles, times."""

    @property
    def assignment(self) -> Dict[str, Any]:
        return self["assignment"]

    @property
    def cost(self) -> float:
        return self["cost"]


def solve(dcop: DCOP, algo_def: Union[str, AlgorithmDef],
          max_cycles: int = 1000,
          algo_params: Optional[Dict[str, Any]] = None,
          warmup: bool = False,
          checkpoint_dir: Optional[str] = None,
          checkpoint_every: Optional[int] = None,
          checkpoint_async: bool = True,
          checkpoint_keep: int = 2,
          resume: bool = False,
          recovery=None,
          trace: Optional[str] = None,
          trace_format: str = "chrome",
          metrics_file: Optional[str] = None,
          metrics_every: Optional[int] = None,
          serve_metrics: Optional[int] = None,
          device: DeviceLike = "cuda") -> SolveResult:
    """Solve a DCOP on one torch device and return assignment +
    quality metrics.

    Keys: ``status`` (FINISHED when the messages converged, else
    TIMEOUT), ``assignment``, ``cost``, ``violations``, ``cycles``,
    ``time`` (engine wall time, see ``DeviceRunResult``),
    ``compile_time``, ``total_time``, ``metrics``, ``backend``.
    ``warmup=True`` runs the solve once untimed first.

    Resilience knobs (the reference's): ``checkpoint_dir`` chunks the
    solve into ``checkpoint_every``-cycle segments (default 100) with
    an NPZ snapshot between segments; ``resume=True`` continues from
    the newest valid snapshot there (same final result as the
    uninterrupted solve).  ``checkpoint_async`` (default True) copies
    and writes each snapshot off the solve loop; ``checkpoint_keep``
    bounds the snapshots kept (default 2).  ``recovery`` (a
    ``resilience.recovery.RecoveryPolicy``) arms the segment-boundary
    guards: NaN/Inf scan, optional cost-divergence window, rollback
    with escalating intervention, ``RecoveryExhausted`` once the
    restart budget is spent.  A decimated MaxSum solve is segmented
    too.  ``warmup=True`` keeps the plain path.

    Observability knobs (the reference's): ``trace`` records the whole
    solve on the process tracer and writes a Chrome ``trace_event``
    JSON (``trace_format="chrome"``) or line-delimited JSON
    (``"jsonl"``) to that path.  ``metrics_file`` activates the
    metrics registry, appends a JSONL snapshot per
    ``metrics_every``-cycle engine segment (default 100) and writes a
    Prometheus text dump to ``<metrics_file>.prom`` when the solve
    ends; ``serve_metrics`` (a port; 0 = OS-assigned) serves
    ``/metrics``, ``/healthz``, ``/events`` and ``/profile`` over HTTP
    while the solve runs.  An observed solve runs segmented with an
    engine probe and returns ``metrics['cost_curve']`` (cycle, cost
    per segment; the last point is the solve's cost) and
    ``metrics['convergence_curve']`` (cycle, mean |Δ| of the f2v
    messages, flip rate per segment from the second on); with
    metrics, the first call of each segment key is also profiled
    (``metrics['xla_cost']``: the card's kernels from
    ``torch.profiler``, or an unavailable marker on the CPU).  With
    ``checkpoint_dir`` the segments follow ``checkpoint_every``;
    ``warmup=True`` keeps the plain path, traced but without curves.
    All default off and cost nothing while off."""
    resolve_device(device)
    if isinstance(algo_def, str):
        algo_def = AlgorithmDef.build_with_default_param(
            algo_def, algo_params or {}, mode=dcop.objective
        )
    module = load_algorithm_module(algo_def.algo)
    if resume and checkpoint_dir is None:
        raise ValueError(
            "resume=True needs checkpoint_dir: there is no snapshot "
            "location to resume from"
        )
    session = None
    if (trace is not None or metrics_file is not None
            or serve_metrics is not None):
        from pydcop_tpu_torch.observability import ObservabilitySession

        session = ObservabilitySession(
            trace, trace_format, metrics_file,
            serve_port=serve_metrics,
        ).start()
    try:
        from pydcop_tpu_torch.observability.trace import tracer

        with tracer.span("solve", "api", algo=algo_def.algo,
                         backend="device", max_cycles=max_cycles):
            return _solve(
                dcop, algo_def, module, max_cycles=max_cycles,
                warmup=warmup, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every,
                checkpoint_async=checkpoint_async,
                checkpoint_keep=checkpoint_keep, resume=resume,
                recovery=recovery, observing=session is not None,
                metrics_file=metrics_file, metrics_every=metrics_every,
                device=device)
    finally:
        if session is not None:
            session.finish()


def _solve(dcop: DCOP, algo_def: AlgorithmDef, module, *,
           max_cycles: int, warmup: bool, checkpoint_dir, checkpoint_every,
           checkpoint_async: bool, checkpoint_keep: int, resume: bool,
           recovery, observing: bool, metrics_file: Optional[str],
           metrics_every: Optional[int], device: DeviceLike) -> SolveResult:
    """The device solve (the reference's ``_solve``, device backend):
    segmented when checkpointing, recovering, decimating or observed
    (the engine probe needs segment boundaries; ``warmup=True`` keeps
    the plain path), else the algorithm's one-loop solve."""
    t0 = time.perf_counter()
    decim_plan = None
    if hasattr(module, "decimation_plan_from_params"):
        decim_plan = module.decimation_plan_from_params(algo_def.params)
    probed = observing and not warmup and hasattr(module, "build_engine")
    if checkpoint_dir is not None or probed or recovery is not None \
            or (decim_plan is not None and not warmup):
        res = _solve_segmented(
            dcop, algo_def, module, max_cycles=max_cycles,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            checkpoint_async=checkpoint_async,
            checkpoint_keep=checkpoint_keep, resume=resume,
            recovery=recovery, decim_plan=decim_plan, probed=probed,
            metrics_file=metrics_file, metrics_every=metrics_every,
            device=device)
    else:
        res = module.solve_on_device(
            dcop, algo_def, max_cycles=max_cycles, warmup=warmup,
            device=device,
        )
    cost, violations = dcop.solution_cost(res.assignment)
    return SolveResult(
        status="FINISHED" if res.converged else "TIMEOUT",
        assignment=res.assignment,
        cost=cost,
        violations=violations,
        cycles=res.cycles,
        time=res.time_s,
        compile_time=res.compile_time_s,
        total_time=time.perf_counter() - t0,
        metrics=res.metrics,
        backend="device",
    )


def _solve_segmented(dcop: DCOP, algo_def: AlgorithmDef, module, *,
                     max_cycles: int, checkpoint_dir: Optional[str],
                     checkpoint_every: Optional[int],
                     checkpoint_async: bool, checkpoint_keep: int,
                     resume: bool, recovery, decim_plan,
                     probed: bool = False,
                     metrics_file: Optional[str] = None,
                     metrics_every: Optional[int] = None,
                     device: DeviceLike = "cuda"):
    """The segmented solve: the algorithm's engine, run by
    ``run_checkpointed`` or resumed by ``resume_from_checkpoint``, with
    an engine probe when ``probed`` (its curves folded into the
    result's metrics)."""
    if not hasattr(module, "build_engine"):
        raise NotImplementedError(
            f"Algorithm {algo_def.algo} has no segmentable engine: "
            "checkpointing/recovery supports maxsum-family solves"
        )
    from pydcop_tpu_torch.resilience.checkpoint import (
        CheckpointManager,
        resume_from_checkpoint,
    )

    engine = module.build_engine(dcop, algo_def.params, device=device)
    probe = None
    if probed:
        from pydcop_tpu_torch.observability.engine_probe import EngineProbe

        # Snapshots fire at segment boundaries; with checkpointing the
        # segment is the checkpoint cadence.
        probe = EngineProbe(engine, metrics_path=metrics_file,
                            metrics_every=metrics_every or 1)
    manager = None
    segment_cycles = None
    if checkpoint_dir is not None:
        manager = CheckpointManager(
            checkpoint_dir, every=checkpoint_every or 100,
            keep=checkpoint_keep,
        )
    elif decim_plan is not None:
        # Decimation rounds set the boundaries unless an explicit
        # metrics cadence asks for finer points.
        segment_cycles = metrics_every or decim_plan.cycles_per_round
    else:
        segment_cycles = metrics_every or 100
    if resume:
        res = resume_from_checkpoint(
            engine, manager, max_cycles=max_cycles, probe=probe,
            checkpoint_async=checkpoint_async, recovery=recovery,
            decimation=decim_plan,
        )
    else:
        res = engine.run_checkpointed(
            max_cycles=max_cycles, manager=manager,
            segment_cycles=segment_cycles, probe=probe,
            checkpoint_async=checkpoint_async, recovery=recovery,
            decimation=decim_plan,
        )
    if probe is not None:
        from pydcop_tpu_torch.observability.engine_probe import (
            attach_result_metrics,
        )

        attach_result_metrics(res, probe)
    return res
