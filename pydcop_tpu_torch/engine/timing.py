"""Device timing for torch tensors.

Port of the part of ``pydcop_tpu/engine/timing.py`` the aggregation
autotuner needs.  A CUDA call returns before the card has finished, so
a host clock stops only after :func:`sync`; on the card a call is timed
between two CUDA events recorded around it, then synchronised, so the
window holds the device's work and not the time spent enqueueing it.
"""

import time
from typing import Any, Callable, Tuple

import torch


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
