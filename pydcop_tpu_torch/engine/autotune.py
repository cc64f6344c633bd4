"""Aggregation autotuner: ``aggregation='auto'`` picks the belief
aggregation by measurement.

Port of the aggregation half of ``pydcop_tpu/engine/autotune.py``: time
one ``aggregate_beliefs`` pass of each strategy on the actual compiled
graph (same bucket shapes and edge distribution, random messages), on
the device the solve runs on, and choose the fastest of
:data:`SELECTABLE`.  The decision and the timings go into the engine's
metrics.

- **mesh**: sharded graphs aggregate with scatter only; ``pad_to > 1``
  returns scatter without measuring.
- **hub guard**: the ell builder refuses degree-skewed graphs; that
  refusal (a ``ValueError``) drops ell from the candidates.  Nothing
  else is caught: a kernel that fails to build or launch while a
  strategy is timed fails the solve.
- **numerics**: ``boundary`` is timed for the record but never chosen.

Decisions persist in a JSON file keyed by (backend, graph shape); the
backend is the torch device type (``"cuda"``/``"cpu"``), so a key never
matches one of the JAX package's.  The default file is
``~/.cache/pydcop_tpu_torch/agg_autotune.json``;
``PYDCOP_AGG_AUTOTUNE_CACHE`` names another.  A file that cannot be
written is logged and skipped.

Not ported here: the whole-algorithm portfolio racer and its pack
fitting (they come with batched solving).
"""

import json
import logging
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from pydcop_tpu_torch.device import DeviceLike, resolve_device, to_device_graph
from pydcop_tpu_torch.engine.compile import (
    AGGREGATIONS,
    CompiledFactorGraph,
    FactorBucket,
    build_aggregation_arrays,
)
from pydcop_tpu_torch.ops.ell import multi_bucket_form

logger = logging.getLogger("pydcop_tpu_torch.engine.autotune")

# Strategies a solve may run with ("boundary" is excluded on numerics).
SELECTABLE = ("scatter", "sorted", "ell")

_CACHE_VERSION = 1


def cache_path() -> str:
    env = os.environ.get("PYDCOP_AGG_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "pydcop_tpu_torch",
        "agg_autotune.json",
    )


def shape_key(backend: str, n_vars: int, dmax: int,
              bucket_shapes, max_degree: int) -> str:
    """Key of "same-shaped problem": backend, variable and domain
    counts, per-bucket (arity, rows) in arity order, and the largest
    variable degree (the hub guard trips on it).  Costs are absent: the
    aggregation never reads them."""
    buckets = ";".join(f"{a}x{r}" for a, r in bucket_shapes)
    return (
        f"v{_CACHE_VERSION}|{backend}|V{n_vars}|D{dmax}"
        f"|{buckets}|K{max_degree}"
    )


def graph_max_degree(graph: CompiledFactorGraph) -> int:
    """Largest real-variable degree over the edge slots (the sentinel's
    padding edges excluded)."""
    counts = np.zeros(graph.n_vars + 1, dtype=np.int64)
    for b in graph.buckets:
        counts += np.bincount(
            b.var_ids.reshape(-1), minlength=graph.n_vars + 1)
    return int(counts[:-1].max()) if graph.n_vars else 0


def graph_shape_key(graph: CompiledFactorGraph, backend: str) -> str:
    return shape_key(
        backend, graph.n_vars, graph.dmax,
        [(b.var_ids.shape[1], b.var_ids.shape[0])
         for b in graph.buckets],
        graph_max_degree(graph),
    )


def dcop_shape_key(dcop, backend: str) -> str:
    """Shape key from a DCOP directly, equal to :func:`graph_shape_key`
    of its graph compiled at ``pad_to=1``, so a stored decision replays
    before compiling."""
    variables = list(dcop.variables.values())
    counts: Dict[int, int] = {}
    degree: Dict[str, int] = {}
    for c in dcop.constraints.values():
        if c.arity == 0:
            continue
        counts[c.arity] = counts.get(c.arity, 0) + 1
        for v in c.dimensions:
            degree[v.name] = degree.get(v.name, 0) + 1
    return shape_key(
        backend,
        len(variables),
        max((len(v.domain) for v in variables), default=1),
        sorted(counts.items()),
        max(degree.values(), default=0),
    )


def cached_choice(key: str,
                  cache_file: Optional[str] = None) -> Optional[str]:
    """The stored decision for ``key``, or None when there is none or
    it is not a selectable strategy."""
    cached = _load_cache(cache_file or cache_path()).get(key)
    if isinstance(cached, dict) \
            and cached.get("aggregation") in SELECTABLE:
        return cached["aggregation"]
    return None


def _load_cache(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            return data
    except (OSError, ValueError):
        pass
    return {}


def _store_cache(path: str, data: Dict[str, Any]) -> None:
    """Merge ``data`` into the file and replace it atomically; an
    ``OSError`` is logged and the decision is not persisted."""
    try:
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        merged = _load_cache(path)
        merged.update(data)
        fd, tmp = tempfile.mkstemp(
            dir=directory, prefix=".autotune_", suffix=".json")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(merged, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError as e:
        logger.warning("autotune cache not persisted to %s: %s",
                       path, e)


def apply_aggregation(graph: CompiledFactorGraph,
                      aggregation: str) -> CompiledFactorGraph:
    """The graph with its ``agg_*`` arrays rebuilt for ``aggregation``
    (costs and var_ids shared, not copied)."""
    perm, sorted_seg, starts, ends, ell = build_aggregation_arrays(
        graph.buckets, graph.n_vars + 1, aggregation
    )
    if ell is not None:
        # Refuses an ell shape whose sum order is unknown (Queue C).
        multi_bucket_form(len(graph.buckets), graph.dmax, ell.shape[1])
    return graph._replace(
        agg_perm=perm, agg_sorted_seg=sorted_seg,
        agg_starts=starts, agg_ends=ends, agg_ell=ell,
    )


def _time_strategy(graph: CompiledFactorGraph, f2v, reps: int,
                   device: torch.device) -> float:
    """Median seconds of one ``aggregate_beliefs`` pass, after a warm
    call (so a kernel's build is not timed).  Only the aggregation's
    arrays are placed: the cost tables stay on the host."""
    from pydcop_tpu_torch.engine.timing import sync, timed_call
    from pydcop_tpu_torch.ops.maxsum import aggregate_beliefs

    empty = np.zeros((0,), np.float32)
    placed = to_device_graph(graph._replace(buckets=tuple(
        FactorBucket(empty, b.var_ids) for b in graph.buckets)), device)

    def fn():
        return aggregate_beliefs(placed, f2v)[1]

    sync(fn())
    times = [timed_call(fn, device=device)[1] for _ in range(reps)]
    return float(np.median(times))


def autotune_aggregation(graph: CompiledFactorGraph, *,
                         pad_to: int = 1,
                         reps: int = 3,
                         use_cache: bool = True,
                         cache_file: Optional[str] = None,
                         device: DeviceLike = "cuda",
                         ) -> Dict[str, Any]:
    """Pick the aggregation strategy for ``graph`` by measurement on
    ``device``.

    Returns ``{"aggregation", "aggregation_source",
    "aggregation_timings_ms", "aggregation_key"}`` (plus
    ``"aggregation_notes"`` when a builder refused a strategy), the dict
    the engine merges into its results' metrics.
    ``aggregation_source`` is ``"mesh"`` (sharded: scatter, nothing
    measured), ``"empty"`` (no edges), ``"cache"`` (a stored decision)
    or ``"measured"``.  Timings cover the four strategies where
    measurable (None where not); the choice is among
    :data:`SELECTABLE`, ties going to the earlier one."""
    dev = resolve_device(device)
    backend = dev.type
    key = graph_shape_key(graph, backend)
    timings: Dict[str, Optional[float]] = {
        s: None for s in AGGREGATIONS}
    if pad_to > 1:
        return {
            "aggregation": "scatter",
            "aggregation_source": "mesh",
            "aggregation_timings_ms": timings,
            "aggregation_key": key,
        }
    n_edges = sum(
        int(np.prod(b.var_ids.shape)) for b in graph.buckets)
    if n_edges == 0:
        return {
            "aggregation": "scatter",
            "aggregation_source": "empty",
            "aggregation_timings_ms": timings,
            "aggregation_key": key,
        }

    path = cache_file or cache_path()
    if use_cache:
        cached = _load_cache(path).get(key)
        if (isinstance(cached, dict)
                and cached.get("aggregation") in SELECTABLE):
            return {
                "aggregation": cached["aggregation"],
                "aggregation_source": "cache",
                "aggregation_timings_ms": cached.get(
                    "aggregation_timings_ms", timings),
                "aggregation_key": key,
            }

    # Random messages, placed once: the aggregation's cost depends on
    # the layout and the indices, not on the values.
    rng = np.random.default_rng(0)
    d = graph.dmax
    f2v = tuple(
        torch.tensor(rng.standard_normal(
            b.var_ids.shape + (d,)).astype(np.float32), device=dev)
        for b in graph.buckets
    )
    notes: Dict[str, str] = {}
    for strategy in AGGREGATIONS:
        try:
            variant = apply_aggregation(graph, strategy)
        except ValueError as e:
            # A builder's refusal (the ell hub guard, an ell shape of
            # unknown sum order): drop the candidate and say why.
            notes[strategy] = str(e).split(":")[0]
            continue
        timings[strategy] = _time_strategy(variant, f2v, reps, dev)

    candidates = {
        s: t for s, t in timings.items()
        if s in SELECTABLE and t is not None
    }
    choice = min(
        candidates,
        key=lambda s: (candidates[s], SELECTABLE.index(s)),
    ) if candidates else "scatter"
    timings_ms = {
        s: (None if t is None else round(t * 1e3, 4))
        for s, t in timings.items()
    }
    result = {
        "aggregation": choice,
        "aggregation_source": "measured",
        "aggregation_timings_ms": timings_ms,
        "aggregation_key": key,
    }
    if notes:
        result["aggregation_notes"] = notes
    if use_cache:
        _store_cache(path, {key: {
            "aggregation": choice,
            "aggregation_timings_ms": timings_ms,
            "backend": backend,
        }})
    return result
