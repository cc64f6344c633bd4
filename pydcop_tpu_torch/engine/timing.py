"""Device timing for torch tensors, and the engine's timed call.

Port of the part of ``pydcop_tpu/engine/timing.py`` the aggregation
autotuner needs.  A CUDA call returns before the card has finished, so
a host clock stops only after :func:`sync`; on the card a call is timed
between two CUDA events recorded around it, then synchronised, so the
window holds the device's work and not the time spent enqueueing it.

:func:`timed_engine_call` is the port of the reference's
``engine/runner.py timed_jit_call``: the one chokepoint every engine
call goes through, with its ``jit_compile``/``engine_call`` spans, the
``pydcop_jit_calls_total``/``pydcop_jit_compile_seconds_total``
counters, the efficiency tracker's cold/warm accounting and the
profiler's capture.  Eager torch compiles nothing, so "compile" reads
as the first call of each key, which builds the CUDA kernels and runs
the aggregation autotuner where they have not run yet.
"""

import time
from typing import Any, Callable, Tuple

import torch

from pydcop_tpu_torch.observability.efficiency import (
    note_backend,
    tracker as efficiency_tracker,
)
from pydcop_tpu_torch.observability.metrics import registry as metrics_registry
from pydcop_tpu_torch.observability.profiler import profiler
from pydcop_tpu_torch.observability.trace import tracer


def sync(out: Any) -> Any:
    """Wait until every CUDA device holding ``out`` (a tensor, or a
    tuple or list of tensors) has finished its queued work; return
    ``out`` unchanged.  A no-op for CPU tensors."""
    tensors = out if isinstance(out, (tuple, list)) else (out,)
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out


def timed_call(fn: Callable, *args: Any,
               device: torch.device = torch.device("cpu")
               ) -> Tuple[Any, float]:
    """``(out, seconds)`` for one completed call of ``fn``.  On a CUDA
    ``device`` the seconds are the elapsed time between CUDA events
    recorded before and after the call on the current stream; on the
    CPU, the host clock around the call."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            end.synchronize()
            return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = sync(fn(*args))
    return out, time.perf_counter() - t0


def _stream_sync(device: torch.device):
    """Wait for the current stream of ``device`` (not the whole card:
    a side stream, such as the asynchronous checkpoint writer's copy,
    runs on)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _account_jit_call(skey: str, first: bool, elapsed: float):
    """Per-key call accounting (registry.active only: the key label is
    unbounded across engines): warm-vs-cold call counts and the cold
    wall seconds, under the reference's metric names."""
    metrics_registry.counter(
        "pydcop_jit_calls_total",
        "Engine jit dispatches by cache key and warmth",
    ).inc(key=skey, warmth="cold" if first else "warm")
    if first:
        metrics_registry.counter(
            "pydcop_jit_compile_seconds_total",
            "Wall seconds of cold engine dispatches (trace+compile+"
            "first run) by cache key",
        ).inc(elapsed, key=skey)


def timed_engine_call(warm: set, key, fn: Callable, device: torch.device,
                      cycles: int = 0) -> Tuple[Any, float, float]:
    """Run ``fn()`` (an engine call on ``device``), splitting compile
    from run time the reference's way: the first call per ``key``
    reports its whole interval as BOTH compile and run time (the
    overlapping-fields convention), later calls (0, elapsed).  The
    interval ends with a synchronise of the device's current stream.

    While the profiler is on, the first call of a key is preceded,
    outside the timed interval, by a profiled throwaway call of ``fn``
    (``cycles`` cycles; ``observability/profiler.py``).  The call runs
    inside a ``jit_compile`` (first) or ``engine_call`` (warm) span: a
    first call whenever the tracer is active (the flight recorder
    included), a warm one only under a file session.

    Returns (out, compile_s, run_s)."""
    first = key not in warm
    entry = None
    if first and profiler.enabled:
        entry = profiler.capture(key, fn, device, cycles)
    t0 = time.perf_counter()
    span = None
    if tracer.enabled or (first and tracer.active):
        span = tracer.span("jit_compile" if first else "engine_call",
                           "engine", key=str(key))
        with span:
            out = fn()
            _stream_sync(device)
    else:
        out = fn()
        _stream_sync(device)
    elapsed = time.perf_counter() - t0
    if entry is not None and span is not None:
        span.args["xla_cost"] = {
            k: v for k, v in entry.items()
            if k not in ("capture_s", "kernels")
        }
    if metrics_registry.active:
        _account_jit_call(str(key), first, elapsed)
    note_backend(device)
    efficiency_tracker.record_jit(str(key), first, elapsed)
    if first:
        warm.add(key)
        return out, elapsed, elapsed
    return out, 0.0, elapsed
