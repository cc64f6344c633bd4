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

from pydcop_tpu_torch.engine import aotcache
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
    # Library-cache attribution (engine/aotcache.py): a cold call that
    # found every kernel library it loaded in the cache reports the
    # load time, not its whole interval, as its compile.
    cache_before = aotcache.counters() if first and aotcache.enabled() \
        else None
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
    if first:
        warm.add(key)
        cached_compile = None
        if cache_before is not None:
            cached_compile = aotcache.split_cold_call(
                elapsed, cache_before, aotcache.counters())
        efficiency_tracker.record_jit(str(key), first, elapsed,
                                      compile_s=cached_compile)
        if cached_compile is not None:
            return out, cached_compile, elapsed
        return out, elapsed, elapsed
    efficiency_tracker.record_jit(str(key), first, elapsed)
    return out, 0.0, elapsed


# One side stream per card for launched dispatches (launch_engine_call).
_LAUNCH_STREAMS: dict = {}


class Launched:
    """A dispatch queued by :func:`launch_engine_call`: its outputs'
    host copies (pinned memory, filled by the card) and the event
    recorded after them (None on the CPU, where the call ran
    synchronously)."""

    def __init__(self, host, event, keep):
        self.host = host
        self.event = event
        # Device tensors the queued work reads or writes: held until
        # the event has passed.
        self.keep = keep


def launch_engine_call(warm: set, key, fn: Callable, device: torch.device
                       ) -> Launched:
    """Queue a WARM engine call without waiting for it (the port of the
    reference's ``launch_jit_call``).  ``fn()`` runs on a side stream
    of the card and returns a tuple of device tensors; each is copied
    into pinned host memory on that stream and an event is recorded
    after the copies.  Nothing here synchronises the host, provided
    ``fn`` reads nothing back.  :func:`finish_engine_call` waits on the
    event.  A cold key raises: a cold call builds kernels, which the
    synchronous :func:`timed_engine_call` accounts."""
    if key not in warm:
        raise RuntimeError(
            f"launch_engine_call on cold key {key!r}: cold dispatches "
            "must go through timed_engine_call")
    if device.type != "cuda":
        return Launched(tuple(fn()), None, None)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = _LAUNCH_STREAMS.get(index)
    if stream is None:
        stream = _LAUNCH_STREAMS[index] = torch.cuda.Stream(index)
    with torch.cuda.device(index), torch.cuda.stream(stream):
        out = fn()
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in out)
        for h, t in zip(host, out):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return Launched(host, event, out)


def finish_engine_call(key, launched: Launched, t_launch: float
                       ) -> Tuple[Any, float]:
    """Wait for a :func:`launch_engine_call` dispatch and account it as
    a warm call (the port of ``finish_jit_call``).  Returns (the host
    tensors, seconds from ``t_launch`` to completion)."""
    if launched.event is not None:
        launched.event.synchronize()
    elapsed = time.perf_counter() - t_launch
    launched.keep = None
    if metrics_registry.active:
        _account_jit_call(str(key), False, elapsed)
    efficiency_tracker.record_jit(str(key), False, elapsed)
    return launched.host, elapsed
