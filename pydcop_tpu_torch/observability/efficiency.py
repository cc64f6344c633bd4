"""Device-efficiency accounting: the solve-side tracker that one solve,
``GET /profile`` and ``profile report`` read.

Port of ``pydcop_tpu/observability/efficiency.py``, its keys and
document shape unchanged: utilization attainment per dispatch (from a
cost entry with ``flops``/``bytes_accessed`` — the port's profiler
measures kernel times, not counts, so attainment stays None unless
such counts are supplied), request time ledgers (:func:`make_ledger`,
the components summing to the measured total), and the
where-the-time-went rollup with the cold/warm dispatch accounting every
engine call feeds (:meth:`EfficiencyTracker.record_jit`).

**Backend honesty**: every rollup and exported metric is labelled with
the backend the solve's tensors ran on — ``cuda`` or ``cpu``, noted by
the engine from its device (:func:`note_backend`) — plus the
accelerator-probe outcome from ``utils.cleanenv.diag_events``.

The serving, batch, envelope and session ledgers (the reference's
``pooled_rollup`` and the dispatch recorders' callers) wait for the
batched-solving and serving slices.  ``PYDCOP_EFFICIENCY=0`` disables
recording entirely.
"""

import os
import threading
from typing import Any, Dict, List, Optional

from pydcop_tpu_torch.observability.metrics import registry as metrics_registry

# Ledger components, in wall-clock order.  ``make_ledger`` accepts any
# subset; the invariant is components-sum-to-total, not all-present
# (an expired request has no execute component to report).
LEDGER_COMPONENTS = ("submit", "queue", "plan", "prep", "compile",
                     "execute", "decode")

# Per-backend peak (flops/s, bytes/s) used for attainment when no env
# override is given: cuda = NVIDIA's H100 SXM datasheet (989.4 TFLOP/s
# dense bf16, 3.35 TB/s HBM3; specifications, not measurements); cpu =
# a few vector cores' worth, deliberately coarse.  The rollup reports
# ``peak_source`` so consumers know whether the denominator was
# calibrated (env) or a default.
BACKEND_PEAKS: Dict[str, Any] = {
    "cuda": (9.894e14, 3.35e12),
    "cpu": (1.0e11, 5.0e10),
}
DEFAULT_PEAK = (1.0e11, 5.0e10)

PEAK_FLOPS_ENV = "PYDCOP_PEAK_FLOPS"
PEAK_BYTES_ENV = "PYDCOP_PEAK_BYTES_PER_S"
ENABLE_ENV = "PYDCOP_EFFICIENCY"


def _env_float(name: str) -> Optional[float]:
    raw = os.environ.get(name)
    if raw is None:
        return None
    try:
        value = float(raw)
    except ValueError:
        return None
    return value if value > 0 else None


def backend_peaks(backend: str) -> Dict[str, Any]:
    """``{flops_per_s, bytes_per_s, source}`` for one backend —
    env-calibrated when ``PYDCOP_PEAK_FLOPS``/``PYDCOP_PEAK_BYTES_PER_S``
    are set, the coarse :data:`BACKEND_PEAKS` default otherwise.
    ``source`` is ``env`` only when BOTH peaks are calibrated;
    calibrating one resource reports ``mixed`` — an attainment whose
    binding resource was judged against a default peak must never
    read as calibrated."""
    flops, bw = BACKEND_PEAKS.get(backend, DEFAULT_PEAK)
    env_flops = _env_float(PEAK_FLOPS_ENV)
    env_bw = _env_float(PEAK_BYTES_ENV)
    if env_flops is not None:
        flops = env_flops
    if env_bw is not None:
        bw = env_bw
    calibrated = sum(1 for v in (env_flops, env_bw) if v is not None)
    source = ("env" if calibrated == 2
              else "mixed" if calibrated == 1 else "default")
    return {"flops_per_s": flops, "bytes_per_s": bw, "source": source}


_backend_cache: Dict[str, Any] = {}
_backend_lock = threading.Lock()


def note_backend(device) -> None:
    """Record the device type (``cuda``/``cpu``) of the tensors a solve
    runs on: the label every efficiency record carries."""
    kind = getattr(device, "type", str(device))
    with _backend_lock:
        _backend_cache["backend"] = kind


def resolved_backend(refresh: bool = False) -> Dict[str, Any]:
    """The backend the last solve's tensors ran on (``unknown`` before
    any), the number of CUDA devices, and the accelerator-probe outcome
    (re-read per call: failures can accumulate while a process runs).
    ``refresh`` is accepted for the reference's signature."""
    del refresh
    with _backend_lock:
        out = {"backend": _backend_cache.get("backend", "unknown")}
    try:
        import torch

        out["n_devices"] = (torch.cuda.device_count()
                            if torch.cuda.is_available() else 0)
    except Exception as exc:  # noqa: BLE001 — must answer anyway
        out["n_devices"] = 0
        out["error"] = f"{type(exc).__name__}: {exc}"[:120]
    try:
        from pydcop_tpu_torch.utils.cleanenv import (
            diag_events,
            is_probe_failure,
        )

        failures = [e for e in diag_events() if is_probe_failure(e)]
        out["probe_failures"] = len(failures)
        out["probe_ok"] = not failures
        if failures:
            out["last_probe_error"] = failures[-1].get("error")
    except Exception:  # noqa: BLE001
        out["probe_failures"] = 0
        out["probe_ok"] = None
    return out


def backend_name() -> str:
    """The backend label alone, the per-dispatch form (no probe-log
    parse)."""
    with _backend_lock:
        return _backend_cache.get("backend", "unknown")


def structure_label(graph) -> str:
    """Low-cardinality structure label for the rollup's cell key
    (duck-typed over a CompiledFactorGraph: ``var_costs`` +
    ``buckets``).  ONE definition — the batched, lane and dynamic
    dispatch paths must never drift into splitting the same structure
    across two rollup cells."""
    rows = "_".join(
        f"a{b.arity}x{b.costs.shape[0]}" for b in graph.buckets)
    return (f"v{graph.var_costs.shape[0] - 1}"
            f"d{graph.var_costs.shape[1]}_{rows or 'nofactors'}")


def split_device_time(time_s: float, compile_s: float
                      ) -> Dict[str, float]:
    """Disjoint ``{compile, execute}`` from the DeviceRunResult
    overlapping-fields convention (cold: ``compile_time_s == time_s``
    — trace+compile+first run are one unseparable interval, charged
    to ``compile``; warm: compile is 0 and the whole wall is
    execute).  The two always sum to ``time_s``, which is what keeps
    the request ledger's sum invariant exact."""
    compile_part = min(max(compile_s, 0.0), max(time_s, 0.0))
    return {"compile": compile_part,
            "execute": max(time_s - compile_part, 0.0)}


def make_ledger(total_s: float, **components: float) -> Dict[str, Any]:
    """Assemble one time ledger: non-negative components (unknown keys
    rejected — the taxonomy is the contract), the measured total, and
    ``unaccounted_s`` (total minus component sum — honest residual,
    near zero when the breakpoints are contiguous; NEVER silently
    absorbed into a component)."""
    ledger: Dict[str, Any] = {}
    acc = 0.0
    for name in LEDGER_COMPONENTS:
        if name not in components:
            continue
        value = max(float(components.pop(name)), 0.0)
        ledger[f"{name}_s"] = round(value, 6)
        acc += value
    if components:
        raise ValueError(
            f"unknown ledger component(s) {sorted(components)}; "
            f"valid: {', '.join(LEDGER_COMPONENTS)}")
    total_s = max(float(total_s), 0.0)
    ledger["total_s"] = round(total_s, 6)
    ledger["unaccounted_s"] = round(total_s - acc, 6)
    return ledger


def ledger_component_sum(ledger: Dict[str, Any]) -> float:
    """Sum of the ledger's components (excluding total/unaccounted) —
    the left side of the sums-to-total invariant."""
    return sum(
        float(ledger.get(f"{name}_s", 0.0))
        for name in LEDGER_COMPONENTS
    )


def attainment_from_cost(cost_entry: Optional[Dict[str, Any]],
                         cycles: int, execute_s: float,
                         backend: str) -> Optional[Dict[str, Any]]:
    """MFU-style attainment of one dispatch from its XLA cost entry.

    ``cost_entry`` is a profiler entry (``flops`` / ``bytes_accessed``
    per loop iteration — XLA counts the while body once); ``cycles``
    scales it to the whole dispatch; ``execute_s`` is the measured
    device-execute wall.  Returns None when the entry is missing /
    unavailable or nothing was measured — "not profiled" must stay
    distinguishable from "0% attained"."""
    if not cost_entry or not cost_entry.get("available"):
        return None
    if execute_s <= 0 or cycles <= 0:
        return None
    peaks = backend_peaks(backend)
    out: Dict[str, Any] = {"peak_source": peaks["source"]}
    flop_att = bw_att = None
    flops = cost_entry.get("flops")
    if flops:
        achieved = float(flops) * cycles / execute_s
        flop_att = achieved / peaks["flops_per_s"]
        out["achieved_flops_per_s"] = achieved
        out["flop_attainment"] = flop_att
    bytes_accessed = cost_entry.get("bytes_accessed")
    if bytes_accessed:
        achieved_b = float(bytes_accessed) * cycles / execute_s
        bw_att = achieved_b / peaks["bytes_per_s"]
        out["achieved_bytes_per_s"] = achieved_b
        out["bandwidth_attainment"] = bw_att
    candidates = [a for a in (flop_att, bw_att) if a is not None]
    if not candidates:
        return None
    # Roofline verdict: the better-attained resource is the one the
    # program is bound by — a memory-bound kernel near peak bandwidth
    # is using the machine well regardless of its flop fraction.
    out["attainment"] = max(candidates)
    return out


class _StructureAgg:
    """Running aggregate of one (backend, structure) cell."""

    __slots__ = ("dispatches", "requests", "device_s", "execute_s",
                 "compile_s", "flops", "bytes", "pad_waste_s",
                 "envelope_waste_s", "by_class")

    def __init__(self):
        self.dispatches = 0
        self.requests = 0
        self.device_s = 0.0
        self.execute_s = 0.0
        self.compile_s = 0.0
        self.flops = 0.0
        self.bytes = 0.0
        self.pad_waste_s = 0.0
        self.envelope_waste_s = 0.0
        self.by_class: Dict[str, int] = {}


class EfficiencyTracker:
    """Process-wide efficiency aggregates: per-dispatch attainment
    records, request-ledger component totals, and jit compile/dispatch
    accounting — the single source behind ``/profile``, the ``/stats``
    efficiency block, the backend-labeled gauges and ``pydcop profile
    report``'s live mode.

    All recorders are cheap (one lock + dict arithmetic, per dispatch
    or per request, never per cycle), never raise, and no-op when
    :attr:`enabled` is off (``PYDCOP_EFFICIENCY=0``)."""

    def __init__(self):
        env = os.environ.get(ENABLE_ENV, "1").strip().lower()
        self.enabled = env not in ("0", "off", "false", "no")
        self._lock = threading.Lock()
        self._structures: Dict[Any, _StructureAgg] = {}
        self._ledger_totals: Dict[str, float] = {}
        self._ledger_counts: Dict[str, int] = {}
        self._ledger_unaccounted = 0.0
        self._jit_cold_s = 0.0
        self._jit_cold = 0
        self._jit_warm = 0
        self._overlap_s = 0.0
        self._overlap_execute_s = 0.0
        self._overlap_dispatches = 0
        self._last_attainment: Optional[float] = None
        self._last_useful: Optional[float] = None

    # -- recorders ------------------------------------------------------ #

    def record_overlap(self, overlap_s: float,
                       execute_s: float) -> None:
        """One pipelined dispatch's device/host overlap: the wall the
        host spent elsewhere (decoding the previous dispatch,
        launching the next) while this dispatch's device work was in
        flight, clamped by the caller to the dispatch's own execute
        wall.  ``pipeline_overlap_fraction = overlap_s / execute_s``
        over all pipelined dispatches — 0 on the synchronous path, →1
        when the device never waits for host-side decode."""
        if not self.enabled:
            return
        with self._lock:
            self._overlap_s += max(float(overlap_s), 0.0)
            self._overlap_execute_s += max(float(execute_s), 0.0)
            self._overlap_dispatches += 1

    def record_dispatch(self, key: str, structure: str, backend: str,
                        time_s: float, compile_s: float, cycles: int,
                        n_real: int, batch_size: int,
                        pad_fraction: float = 0.0,
                        envelope_waste: float = 0.0,
                        packing: str = "structure",
                        cost_entry: Optional[Dict[str, Any]] = None,
                        ) -> Optional[Dict[str, Any]]:
        """Account one device dispatch.  Returns the per-dispatch
        efficiency record (attainment + useful_work_fraction) for the
        caller to fold into its own metrics, or None when disabled.
        Waste seconds are charged out of the EXECUTE wall: padded
        lanes and masked envelope cells burn device time whether or
        not anyone wanted their answers."""
        if not self.enabled:
            return None
        try:
            return self._record_dispatch(
                key, structure, backend, time_s, compile_s, cycles,
                n_real, batch_size, pad_fraction, envelope_waste,
                packing, cost_entry)
        except Exception:  # noqa: BLE001 — accounting must never
            # fail a dispatch.
            return None

    def _record_dispatch(self, key, structure, backend, time_s,
                         compile_s, cycles, n_real, batch_size,
                         pad_fraction, envelope_waste, packing,
                         cost_entry) -> Dict[str, Any]:
        split = split_device_time(time_s, compile_s)
        execute_s = split["execute"]
        pad_fraction = min(max(float(pad_fraction or 0.0), 0.0), 1.0)
        envelope_waste = min(max(float(envelope_waste or 0.0), 0.0),
                             1.0)
        att = attainment_from_cost(cost_entry, cycles, execute_s,
                                   backend)
        useful = None
        if att is not None:
            useful = (att["attainment"] * (1.0 - pad_fraction)
                      * (1.0 - envelope_waste))
        record: Dict[str, Any] = {
            "backend": backend,
            "structure": structure,
            "packing": packing,
            "execute_s": round(execute_s, 6),
            "compile_s": round(split["compile"], 6),
            "cycles": int(cycles),
            "pad_fraction": pad_fraction,
            "envelope_waste": envelope_waste,
            "attainment": (round(att["attainment"], 6)
                           if att is not None else None),
            "useful_work_fraction": (round(useful, 6)
                                     if useful is not None else None),
        }
        if att is not None:
            record["attainment_detail"] = att
        cell_key = (backend, structure)
        with self._lock:
            agg = self._structures.get(cell_key)
            if agg is None:
                agg = self._structures[cell_key] = _StructureAgg()
            agg.dispatches += 1
            agg.requests += int(n_real)
            agg.device_s += float(time_s)
            agg.execute_s += execute_s
            agg.compile_s += split["compile"]
            # Flops/bytes only accumulate against measurable execute
            # wall: a cold dispatch's whole interval is charged to
            # compile (execute 0), so counting its work would inflate
            # the weighted attainment with seconds that aren't in the
            # denominator.
            if (execute_s > 0 and cost_entry
                    and cost_entry.get("available")):
                agg.flops += float(cost_entry.get("flops") or 0.0) \
                    * cycles
                agg.bytes += float(
                    cost_entry.get("bytes_accessed") or 0.0) * cycles
            # Waste seconds: duplicated bin lanes + masked envelope
            # cells, both charged against the execute wall.
            agg.pad_waste_s += execute_s * pad_fraction
            agg.envelope_waste_s += (
                execute_s * (1.0 - pad_fraction) * envelope_waste)
            agg.by_class[packing] = agg.by_class.get(packing, 0) + 1
            if att is not None:
                self._last_attainment = att["attainment"]
                self._last_useful = useful
        self._export_dispatch(backend, packing, record)
        return record

    def record_ledger(self, ledger: Dict[str, Any],
                      backend: Optional[str] = None,
                      kind: str = "request") -> None:
        """Fold one request/session ledger into the component totals
        (the where-the-time-went breakdown)."""
        if not self.enabled or not ledger:
            return
        try:
            backend = backend or backend_name()
            with self._lock:
                for name in LEDGER_COMPONENTS:
                    value = float(ledger.get(f"{name}_s", 0.0))
                    if value:
                        self._ledger_totals[name] = \
                            self._ledger_totals.get(name, 0.0) + value
                self._ledger_unaccounted += abs(
                    float(ledger.get("unaccounted_s", 0.0)))
                self._ledger_counts[kind] = \
                    self._ledger_counts.get(kind, 0) + 1
            if metrics_registry.active:
                counter = metrics_registry.counter(
                    "pydcop_request_ledger_seconds_total",
                    "End-to-end request latency by ledger component "
                    "(sums to total request seconds)")
                for name in LEDGER_COMPONENTS:
                    value = float(ledger.get(f"{name}_s", 0.0))
                    if value:
                        counter.inc(value, component=name,
                                    backend=backend)
        except Exception:  # noqa: BLE001
            pass

    def record_jit(self, key: str, first: bool, elapsed: float,
                   compile_s: Optional[float] = None) -> None:
        """timed_jit_call hook: global cold-compile wall + dispatch
        counts (the compile column of waste-by-cause, covering every
        engine — one-shot, segmented, dynamic, batched).
        ``compile_s`` overrides the charged compile wall when the
        caller attributed the cold interval more precisely — a cold
        dispatch whose executables all deserialized from the
        persistent AOT cache charges only the retrieval wall
        (engine/aotcache.split_cold_call), not the whole interval."""
        if not self.enabled:
            return
        with self._lock:
            if first:
                self._jit_cold += 1
                self._jit_cold_s += float(
                    elapsed if compile_s is None else compile_s)
            else:
                self._jit_warm += 1

    def _export_dispatch(self, backend: str, packing: str,
                         record: Dict[str, Any]) -> None:
        if not metrics_registry.active:
            return
        try:
            metrics_registry.counter(
                "pydcop_efficiency_dispatches_total",
                "Efficiency-accounted device dispatches by backend "
                "and packing class",
            ).inc(backend=backend, packing=packing)
            metrics_registry.counter(
                "pydcop_device_execute_seconds_total",
                "Device execute wall seconds by backend and packing "
                "class (compile excluded)",
            ).inc(record["execute_s"], backend=backend,
                  packing=packing)
            if record["compile_s"]:
                metrics_registry.counter(
                    "pydcop_device_compile_seconds_total",
                    "Cold-compile wall seconds by backend",
                ).inc(record["compile_s"], backend=backend)
            if record["attainment"] is not None:
                metrics_registry.gauge(
                    "pydcop_efficiency_attainment",
                    "Roofline attainment of the last accounted "
                    "dispatch (max of flop/bandwidth fraction of the "
                    "configured peak)",
                ).set(record["attainment"], backend=backend)
            if record["useful_work_fraction"] is not None:
                metrics_registry.gauge(
                    "pydcop_useful_work_fraction",
                    "Attainment discounted by padding and envelope "
                    "waste, last accounted dispatch",
                ).set(record["useful_work_fraction"],
                      backend=backend)
        except Exception:  # noqa: BLE001
            pass

    # -- readback ------------------------------------------------------- #

    def _weighted(self, aggs: List[_StructureAgg], backend: str
                  ) -> Dict[str, Any]:
        """Execute-time-weighted attainment + useful fraction over a
        set of structure cells."""
        execute_s = sum(a.execute_s for a in aggs)
        flops = sum(a.flops for a in aggs)
        byts = sum(a.bytes for a in aggs)
        pad_s = sum(a.pad_waste_s for a in aggs)
        env_s = sum(a.envelope_waste_s for a in aggs)
        out: Dict[str, Any] = {
            "execute_s": round(execute_s, 6),
            "compile_s": round(sum(a.compile_s for a in aggs), 6),
            "device_s": round(sum(a.device_s for a in aggs), 6),
            "dispatches": sum(a.dispatches for a in aggs),
            "requests": sum(a.requests for a in aggs),
            "pad_waste_s": round(pad_s, 6),
            "envelope_waste_s": round(env_s, 6),
        }
        if execute_s > 0:
            peaks = backend_peaks(backend)
            flop_att = (flops / execute_s / peaks["flops_per_s"]
                        if flops else None)
            bw_att = (byts / execute_s / peaks["bytes_per_s"]
                      if byts else None)
            candidates = [a for a in (flop_att, bw_att)
                          if a is not None]
            if candidates:
                att = max(candidates)
                useful_frac = 1.0 - (pad_s + env_s) / execute_s
                out["attainment"] = round(att, 6)
                out["flop_attainment"] = (round(flop_att, 6)
                                          if flop_att else None)
                out["bandwidth_attainment"] = (round(bw_att, 6)
                                              if bw_att else None)
                out["useful_work_fraction"] = round(
                    att * useful_frac, 6)
                out["peak_source"] = peaks["source"]
        return out

    def rollup(self, top_n: int = 10) -> Dict[str, Any]:
        """The full efficiency document (``/profile``, ``profile
        report --url``): backend identity, weighted attainment,
        ledger breakdown, waste-by-cause, and the top-N structures by
        device time."""
        backend_info = resolved_backend()
        with self._lock:
            cells = {k: v for k, v in self._structures.items()}
            ledger_totals = dict(self._ledger_totals)
            ledger_counts = dict(self._ledger_counts)
            unaccounted = self._ledger_unaccounted
            jit = {"cold_dispatches": self._jit_cold,
                   "warm_dispatches": self._jit_warm,
                   "cold_compile_s": round(self._jit_cold_s, 6)}
            overlap_s = self._overlap_s
            overlap_execute_s = self._overlap_execute_s
            overlap_n = self._overlap_dispatches
        by_backend: Dict[str, List[_StructureAgg]] = {}
        for (backend, _structure), agg in cells.items():
            by_backend.setdefault(backend, []).append(agg)
        backends = {
            backend: self._weighted(aggs, backend)
            for backend, aggs in sorted(by_backend.items())
        }
        structures = []
        for (backend, structure), agg in cells.items():
            row = self._weighted([agg], backend)
            row.update({"structure": structure, "backend": backend,
                        "by_class": dict(agg.by_class)})
            structures.append(row)
        structures.sort(key=lambda r: -r["device_s"])
        ledger_total = sum(ledger_totals.values())
        waste = {
            "padding_s": round(sum(
                a.pad_waste_s for a in cells.values()), 6),
            "envelope_s": round(sum(
                a.envelope_waste_s for a in cells.values()), 6),
            "compile_s": round(jit["cold_compile_s"], 6),
            "queue_s": round(ledger_totals.get("queue", 0.0), 6),
        }
        return {
            "backend": backend_info,
            "backends": backends,
            "structures": structures[:top_n],
            "structures_total": len(structures),
            "ledger": {
                "components_s": {
                    k: round(v, 6)
                    for k, v in sorted(ledger_totals.items())
                },
                "total_s": round(ledger_total, 6),
                "unaccounted_abs_s": round(unaccounted, 6),
                "counts": ledger_counts,
            },
            "waste_by_cause": waste,
            "jit": jit,
            "pipeline": {
                "overlap_s": round(overlap_s, 6),
                "execute_s": round(overlap_execute_s, 6),
                "dispatches": overlap_n,
            },
            "pipeline_overlap_fraction": (
                round(overlap_s / overlap_execute_s, 6)
                if overlap_execute_s > 0 else 0.0),
        }

    def summary(self) -> Dict[str, Any]:
        """The compact ``/stats`` block: resolved backend, last/
        weighted attainment and useful fraction, ledger component
        sums."""
        roll = self.rollup(top_n=3)
        backend = roll["backend"]["backend"]
        agg = roll["backends"].get(backend, {})
        return {
            "backend": backend,
            "probe_ok": roll["backend"].get("probe_ok"),
            "attainment": agg.get("attainment"),
            "useful_work_fraction": agg.get("useful_work_fraction"),
            "device_execute_s": agg.get("execute_s", 0.0),
            "dispatches": agg.get("dispatches", 0),
            "ledger_components_s": roll["ledger"]["components_s"],
            "waste_by_cause": roll["waste_by_cause"],
            "pipeline_overlap_fraction":
                roll["pipeline_overlap_fraction"],
        }

    def clear(self) -> None:
        """Drop every aggregate (tests); ``enabled`` is untouched."""
        with self._lock:
            self._structures = {}
            self._ledger_totals = {}
            self._ledger_counts = {}
            self._ledger_unaccounted = 0.0
            self._jit_cold_s = 0.0
            self._jit_cold = 0
            self._jit_warm = 0
            self._overlap_s = 0.0
            self._overlap_execute_s = 0.0
            self._overlap_dispatches = 0
            self._last_attainment = None
            self._last_useful = None


tracker = EfficiencyTracker()


def get_tracker() -> EfficiencyTracker:
    return tracker
