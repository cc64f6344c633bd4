"""Speculative envelope builds: the port's form of
``pydcop_tpu/serving/speculate.py``.

The serving plane's cold stalls are concentrated on *predictable*
dispatches: a structure that arrived once will arrive again, and when
it does it will batch — the flush pads the group to the next bin rung
and dispatches a stack whose shape is fully determined by (envelope,
bin size, solver statics).  The reference derives that program's input
shapes with ``jax.eval_shape`` and AOT-compiles it off the request
path.  Eager torch has no program to compile: what a cold dispatch on
the card pays for is the ``nvcc`` build of the kernel libraries it
loads (``ops/_build.py``).  So here the speculated job derives the
stack's shape skeleton (shapes only, from the envelope: no padding
work, no tensor), computes the dispatch key ``engine/batch.py``'s
``_prepare_stacked`` will give the real stack, and builds the kernel
libraries that dispatch loads into the library cache
(``engine/aotcache.py``).  When the real traffic arrives, the cold
dispatch finds them built.  On a CPU service there is nothing to build:
a job only derives its key.

Discipline (battery-asserted), the reference's:

* all builds run on ONE low-priority daemon thread, never the
  device-owning scheduler thread — every build record carries its
  ``thread_ident``;
* the worker allocates nothing on the card, launches nothing, and
  never touches ``engine.batch._warm`` (marking a speculated key warm
  would route the first REAL dispatch through the warm launch path
  with no build attribution — the ledger would lie);
* the job queue is bounded (drops are counted, not blocked on) so a
  diverse stream cannot grow an unbounded build backlog.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..engine import batch as engine_batch
from ..observability.trace import tracer
from ..ops import _build
from . import binning

log = logging.getLogger("pydcop_tpu_torch.serving.speculate")

# Bin rungs speculated ahead of the observed group size: when a
# structure shows up at size n, the next flushes will most likely pad
# it to the next rung(s) up.  Two rungs ahead covers a doubling burst
# without flooding the queue on every observation.
_RUNGS_AHEAD = 2

# The kernel libraries a stacked (edge-layout) dispatch loads.
STACKED_LIBRARIES = ("binary_factor_update", "segment_sum", "var_update",
                     "window_sum")


def _skeleton(var_shape, bucket_shapes) -> SimpleNamespace:
    """Shape-only stand-in for a compiled graph: what
    ``engine.batch._shape_signature`` reads (``var_costs.shape`` and
    each bucket's ``costs.shape``)."""
    return SimpleNamespace(
        var_costs=SimpleNamespace(shape=tuple(var_shape)),
        buckets=tuple(SimpleNamespace(costs=SimpleNamespace(
            shape=tuple(s))) for s in bucket_shapes))


def _raw_skeleton(graph) -> SimpleNamespace:
    return _skeleton(graph.var_costs.shape,
                     [b.costs.shape for b in graph.buckets])


def _padded_skeleton(graph, env: binning.Envelope) -> SimpleNamespace:
    """The shapes of ``graph`` padded to ``env`` — every padded shape
    is fully determined by the envelope
    (``engine.batch.pad_graph_to_envelope``), so the skeleton needs no
    padding work.  Shape parity with the real padding path is
    battery-asserted (the speculated key must equal the live
    ``_prepare_stacked`` key or every speculation misses)."""
    return _skeleton(
        (env.v_env + 1, env.d_env),
        [(rows,) + (env.d_env,) * arity for arity, rows in env.rows])


def _statics_from_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The dispatch statics, derived EXACTLY like
    ``engine.batch._prepare_stacked`` does — key equality with the
    live dispatch path is the whole point."""
    damping_nodes = params.get("damping_nodes", "vars")
    return dict(
        max_cycles=params["max_cycles"],
        damping=params["damping"],
        damp_vars=damping_nodes in ("vars", "both"),
        damp_factors=damping_nodes in ("factors", "both"),
        stability=params["stability"],
        prune=bool(params.get("prune", 0)),
    )


class _Job:
    __slots__ = ("skeleton", "env", "bs", "statics")

    def __init__(self, skeleton, env, bs, statics):
        self.skeleton = skeleton
        self.env = env
        self.bs = bs
        self.statics = statics


class SpeculativeCompiler:
    """Arrival-histogram-driven background builder for envelope
    dispatches.  ``observe()`` is called by the flush planner (cheap:
    histogram update + bounded enqueue); one daemon worker drains the
    queue.  ``device`` is the service's: the worker builds kernel
    libraries only for a CUDA service."""

    def __init__(self, bin_sizes: Tuple[int, ...] = (1, 2, 4, 8, 16),
                 max_queue: int = 16, device="cpu"):
        self.bin_sizes = tuple(sorted(set(int(b) for b in bin_sizes)))
        self.device = torch.device(device)
        self._queue: "queue.Queue[Optional[_Job]]" = queue.Queue(
            maxsize=max_queue)
        self._lock = threading.Lock()
        # Per-(envelope, statics) arrival counts — the structure
        # histogram the predictions rank on.
        self.histogram: Dict[tuple, int] = {}
        # str(dispatch key) of every dispatch this speculator prepared
        # (or queued — dedupe is at enqueue time so a slow build does
        # not get queued twice).
        self._seen_keys: set = set()
        self.compiled_keys: set = set()
        self.records: List[Dict[str, Any]] = []
        self.compiled_total = 0
        self.dropped_total = 0
        self.hit_total = 0
        self.failed_total = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ----------------------------------------------------------- #
    # lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._worker, name="pydcop-spec-compile",
            daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        if self._thread is None:
            return
        self._stop.set()
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=timeout)
        self._thread = None

    # ----------------------------------------------------------- #
    # planner-side API (scheduler thread — must stay cheap)

    def observe(self, graph, env: binning.Envelope,
                params: Dict[str, Any], count: int) -> None:
        """Record one envelope group's arrival and enqueue the
        dispatches its structure will plausibly need next: the
        observed envelope at the next ``_RUNGS_AHEAD`` bin rungs above
        ``count``, plus the current rung itself.  Two skeletons per
        prediction: the graph's RAW shapes (what an exact
        same-structure bin dispatches) and the envelope-padded shapes
        (what a heterogeneous packed group dispatches); an exact-fit
        graph collapses both to one key.  The jobs hold shapes only."""
        statics = _statics_from_params(params)
        hkey = (env, tuple(sorted(statics.items())))
        with self._lock:
            self.histogram[hkey] = self.histogram.get(hkey, 0) + 1
        try:
            skeletons = [_raw_skeleton(graph),
                         _padded_skeleton(graph, env)]
        except Exception:
            return  # never raise into the flush planner
        sizes: List[int] = []
        ahead = 0
        for b in self.bin_sizes:
            if b >= max(int(count), 1):
                sizes.append(b)
                ahead += 1
                if ahead > _RUNGS_AHEAD:
                    break
        for bs in sizes:
            for skel in skeletons:
                self._enqueue(_Job(skel, env, bs, statics))

    def _enqueue(self, job: _Job) -> None:
        try:
            key = self._program_key(job)
        except Exception:  # shape derivation failed — never raise
            return         # into the flush planner
        skey = str(key)
        with self._lock:
            if skey in self._seen_keys:
                return
            if key in engine_batch._warm:
                # Already dispatched live: nothing to speculate.
                self._seen_keys.add(skey)
                return
            self._seen_keys.add(skey)
        try:
            self._queue.put_nowait(job)
        except queue.Full:
            with self._lock:
                self.dropped_total += 1
                self._seen_keys.discard(skey)

    # ----------------------------------------------------------- #
    # worker side

    @staticmethod
    def _program_key(job: _Job) -> tuple:
        """The key ``engine.batch._prepare_stacked`` gives a stack of
        ``job.bs`` graphs of the skeleton's shapes."""
        return (
            "maxsum_batch", job.bs,
            engine_batch._shape_signature([job.skeleton] * job.bs),
            tuple(sorted(job.statics.items())),
        )

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                job = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            if job is None:
                break
            try:
                self._compile_one(job)
            except Exception as exc:
                with self._lock:
                    self.failed_total += 1
                log.debug("speculative build failed: %s", exc)

    def _compile_one(self, job: _Job) -> None:
        key = self._program_key(job)
        if key in engine_batch._warm:
            return
        t0 = time.perf_counter()
        with tracer.span("speculative_compile", cat="serve",
                         key=str(key)[:120], compile_only=True,
                         thread=threading.get_ident()):
            # Build-only: the libraries land in the library cache; no
            # tensor is allocated and nothing is launched — the card
            # stays with the scheduler thread.
            built_s = 0.0
            if self.device.type == "cuda":
                built_s = _build.build(STACKED_LIBRARIES)
        wall = time.perf_counter() - t0
        with self._lock:
            self.compiled_total += 1
            self.compiled_keys.add(str(key))
            self.records.append({
                "key": str(key),
                "thread_ident": threading.get_ident(),
                "wall_s": round(wall, 6),
                "build_s": round(built_s, 6),
                "compile_only": True,
            })

    # ----------------------------------------------------------- #
    # completion-side API (hit accounting + stats)

    def record_hit(self, program_key: str) -> bool:
        """Called by the service when a cold dispatch's key matches a
        speculated one — the build the request path just skipped."""
        with self._lock:
            if program_key in self.compiled_keys:
                self.hit_total += 1
                return True
        return False

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "speculative_compiles_total": self.compiled_total,
                "speculative_hits_total": self.hit_total,
                "speculative_dropped_total": self.dropped_total,
                "speculative_failed_total": self.failed_total,
                "queued": self._queue.qsize(),
                "structures_observed": len(self.histogram),
            }
