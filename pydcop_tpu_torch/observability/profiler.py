"""Device cost attribution per engine segment, keyed by the engine's
segment key.

Port of ``pydcop_tpu/observability/profiler.py``.  The reference reads
XLA's ``cost_analysis``/``memory_analysis`` off a throwaway AOT compile
of each segment program; eager torch has no compiled program to ask.
Here the first (cold) call of each segment key is captured instead by
``torch.profiler`` on a throwaway run of the same segment on the same
inputs: the CUDA kernels it launched (name, count, device time), the
kernels per cycle, the device time per cycle, and the peak device
memory of that run (``torch.cuda.max_memory_allocated``).  The entry
lands where the reference's does — ``DeviceRunResult.metrics
['xla_cost']`` keyed by the segment key, the ``xla_cost`` trace
instant and the metrics registry — with a ``source`` field saying which
tool made the numbers (``"torch.profiler"``).

Capture discipline, as in the reference: the capture runs BEFORE the
timed call and outside its interval, and reads its inputs only (a
segment never writes into its input state), so the measured rates and
the trajectory are unchanged.  It costs one extra segment per key
while profiling is on.  On the CPU, or where the profiler records no
device time, the entry is the reference's explicit ``{"available":
False, "reason": ...}`` marker, so "not profiled" stays distinguishable
from "profiled, nothing measured".

Enablement: :class:`~pydcop_tpu_torch.observability.ObservabilitySession`
turns the profiler on for solves with metrics; ``PYDCOP_XLA_PROFILE=1``
forces it on, ``=0`` off regardless of session (the reference's
variable).
"""

import os
import threading
import time
from typing import Any, Callable, Dict, Optional

SOURCE = "torch.profiler"


def _env_override() -> Optional[bool]:
    raw = os.environ.get("PYDCOP_XLA_PROFILE")
    if raw is None:
        return None
    return raw not in ("0", "false", "no", "")


def key_str(key: Any) -> str:
    """Canonical string form of a segment key (the metrics label and
    the ``metrics['xla_cost']`` key)."""
    return str(key)


def _device_us(event) -> float:
    return float(getattr(event, "self_device_time_total",
                         getattr(event, "self_cuda_time_total", 0.0)))


class DeviceCostProfiler:
    """Captures the per-segment kernel profile, keyed by the engine's
    segment key.  :meth:`capture` is called on the cold call of each
    key; entries accumulate in :attr:`entries` until :meth:`clear`.
    Failures fold into unavailable markers: profiling never breaks a
    solve."""

    def __init__(self):
        self._enabled = False
        self._lock = threading.Lock()
        self.entries: Dict[str, Dict[str, Any]] = {}

    @property
    def enabled(self) -> bool:
        env = _env_override()
        return self._enabled if env is None else env

    @enabled.setter
    def enabled(self, value: bool):
        self._enabled = bool(value)

    # -- capture -------------------------------------------------------- #

    def capture(self, key: Any, run: Callable[[], Any], device,
                cycles: int) -> Dict[str, Any]:
        """Profile one throwaway ``run()`` (a segment of ``cycles``
        cycles on ``device``) and record the entry under ``key``.
        Never raises; returns the entry."""
        t0 = time.perf_counter()
        try:
            entry = self._analyze(run, device, cycles)
        except Exception as exc:  # noqa: BLE001 — never fail a solve
            entry = {
                "available": False,
                "reason": f"{type(exc).__name__}: {exc}"[:200],
            }
        entry["source"] = SOURCE
        entry["capture_s"] = round(time.perf_counter() - t0, 6)
        skey = key_str(key)
        with self._lock:
            self.entries[skey] = entry
        self._export_metrics(skey, entry)
        return entry

    @staticmethod
    def _analyze(run, device, cycles: int) -> Dict[str, Any]:
        import torch

        if getattr(device, "type", str(device)) != "cuda":
            return {"available": False,
                    "reason": "CPU tensors: torch.profiler records no "
                              "device kernels there"}
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with torch.cuda.device(device):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        kernels: Dict[str, Dict[str, float]] = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or _device_us(e) <= 0:
                continue
            kernels[e.key[:120]] = {"count": int(e.count),
                                    "device_us": _device_us(e)}
        if not kernels:
            return {"available": False,
                    "reason": "torch.profiler recorded no device time",
                    "peak_bytes": float(peak)}
        launches = sum(k["count"] for k in kernels.values())
        device_s = sum(k["device_us"] for k in kernels.values()) / 1e6
        per = max(int(cycles), 1)
        return {
            "available": True,
            "kernels": kernels,
            "kernel_launches": launches,
            "kernels_per_cycle": launches / per,
            "device_s": device_s,
            "device_ms_per_cycle": device_s / per * 1e3,
            "cycles": int(cycles),
            "peak_bytes": float(peak),
        }

    def _export_metrics(self, skey: str, entry: Dict[str, Any]):
        from pydcop_tpu_torch.observability.metrics import registry
        from pydcop_tpu_torch.observability.trace import tracer

        if tracer.enabled:
            tracer.instant("xla_cost", "engine", key=skey, **{
                k: v for k, v in entry.items()
                if k not in ("capture_s", "kernels")
            })
        # Key-labelled series are opt-in detail (registry.active), as
        # in the reference.
        if not registry.active:
            return
        if entry.get("available"):
            registry.counter(
                "pydcop_profiled_kernel_launches_total",
                "CUDA kernel launches of profiled segments "
                "(torch.profiler, one capture per cold segment key)",
            ).inc(entry["kernel_launches"], key=skey)
            registry.gauge(
                "pydcop_xla_peak_bytes",
                "Peak device bytes of a profiled segment "
                "(torch.cuda.max_memory_allocated)",
            ).set(entry["peak_bytes"], key=skey)
        else:
            registry.counter(
                "pydcop_xla_analysis_unavailable_total",
                "Cold segments whose device profile was unavailable",
            ).inc()

    # -- readback ------------------------------------------------------- #

    def get(self, key: Any) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self.entries.get(key_str(key))

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self.entries.items()}

    def clear(self):
        with self._lock:
            self.entries = {}


profiler = DeviceCostProfiler()


def get_profiler() -> DeviceCostProfiler:
    return profiler
