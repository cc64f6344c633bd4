"""Compile a DCOP factor graph into dense, padded, bucketed arrays.

Port of ``pydcop_tpu/engine/compile.py`` (numpy only, no torch): the
port's engine consumes exactly the arrays the JAX reference compiles,
so both packages run on the same graph (``tests/test_torch_compile.py``
holds every array to ``np.array_equal``).

- **Arity buckets.** Factors are grouped by arity; each bucket stacks
  its cost hypercubes into one ``[F, Dmax, ..., Dmax]`` tensor so the
  factor->variable min-reduction is one batched reduction per bucket.
- **Messages live in bucket space** as ``[F, arity, Dmax]`` arrays; the
  variable-side aggregation is a scatter-add over ``var_ids``.
- **Domain padding.** Domains are padded to Dmax with ``BIG`` cost so
  padded slots never win a min; ``var_valid`` masks them out.
  ``objective=max`` problems are negated here and re-negated on the
  host, so kernels only minimize.
- **Row padding.** Bucket rows are padded to a multiple of ``pad_to``;
  padding rows have zero cost and point at a sentinel variable row
  (index V) whose sums are dropped.
- **Zero-ary constraints** fold into ``meta.constant_cost``.
- **Aggregation arrays.** ``aggregation`` = ``sorted``/``boundary``/``ell``
  adds the reference's compile-time edge indexing (``agg_*`` fields,
  :func:`build_aggregation_arrays`); ``scatter`` leaves them None.
- **Structure cache.** The padded ``var_ids`` and the ``agg_*`` arrays
  depend only on the graph's structure, so :class:`CompileCache` keeps
  them across compiles of same-shaped problems.  As in the reference,
  a compile runs inside a ``compile_graph`` span and, while the metrics
  registry is active, counts its cache lookups
  (``pydcop_compile_cache_total{outcome}``) and layout builds
  (``pydcop_layout_builds_total``).
"""

import os
import threading
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import Variable, _stable_noise
from pydcop_tpu_torch.dcop.relations import Constraint
from pydcop_tpu_torch.observability.metrics import registry as metrics_registry
from pydcop_tpu_torch.observability.trace import tracer
from pydcop_tpu_torch.ops.ell import multi_bucket_form

BIG = np.float32(1e9)


class CompileCache:
    """Process-wide structure-keyed layout cache (reference
    ``CompileCache``): the padded ``var_ids`` and the ``agg_*`` arrays
    are pure functions of the variable count, the factors' scopes,
    ``pad_to`` and the aggregation, never of the costs, so a compile of
    a same-shaped problem takes them from here (``layout_builds``
    counts the builds).  Cached arrays are frozen.  Bounded LRU;
    ``PYDCOP_COMPILE_CACHE=0`` turns it off.  Thread-safe."""

    def __init__(self, maxsize: int = 8):
        self.maxsize = maxsize
        self._entries: "OrderedDict" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.layout_builds = 0

    def get(self, key):
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return entry
            self.misses += 1
            return None

    def put(self, key, entry):
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)

    def clear(self):
        with self._lock:
            self._entries.clear()
            self.hits = self.misses = self.layout_builds = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "layout_builds": self.layout_builds,
                "entries": len(self._entries),
            }


compile_cache = CompileCache()


def _freeze(arr: Optional[np.ndarray]) -> Optional[np.ndarray]:
    if arr is not None:
        arr.flags.writeable = False
    return arr


class FactorBucket(NamedTuple):
    """All factors of one arity, stacked."""

    costs: np.ndarray    # [F, Dmax]*arity, f32, BIG on padded slots
    var_ids: np.ndarray  # [F, arity] int32 (sentinel V on padding rows)

    @property
    def arity(self) -> int:
        return self.var_ids.shape[1]

    @property
    def n_factors(self) -> int:
        return self.var_ids.shape[0]


class CompiledFactorGraph(NamedTuple):
    """Dense form of a factor graph, numpy on the host
    (``device.to_device_graph`` moves it onto a torch device).

    The optional ``agg_*`` arrays select the belief aggregation, as in
    the reference: all None is ``scatter``; perm + sorted_seg is
    ``sorted``; perm + starts/ends is ``boundary``; ell ([V+1, K] edge
    indices per variable, K the largest real-variable degree, dummy
    slots holding E) is ``ell``."""

    var_costs: np.ndarray   # [V+1, Dmax] f32 (last row = sentinel)
    var_valid: np.ndarray   # [V+1, Dmax] bool
    buckets: Tuple[FactorBucket, ...]
    agg_perm: Optional[np.ndarray] = None        # [E] int32
    agg_sorted_seg: Optional[np.ndarray] = None  # [E] int32 (sorted)
    agg_starts: Optional[np.ndarray] = None      # [V+1] int32
    agg_ends: Optional[np.ndarray] = None        # [V+1] int32
    agg_ell: Optional[np.ndarray] = None         # [V+1, K] int32

    @property
    def n_vars(self) -> int:
        return self.var_costs.shape[0] - 1

    @property
    def dmax(self) -> int:
        return self.var_costs.shape[1]


class FactorGraphMeta(NamedTuple):
    """Host-side metadata to map device results back to the problem."""

    var_names: Tuple[str, ...]
    domains: Tuple[Tuple, ...]          # domain values per var
    factor_names: Tuple[str, ...]       # bucket order, real factors only
    bucket_sizes: Tuple[int, ...]       # real (unpadded) factors per bucket
    mode: str                           # 'min' or 'max'
    constant_cost: float = 0.0          # folded zero-ary constraints
    # [V, Dmax] sign-adjusted variable costs WITHOUT tie-breaking
    # noise (zeros on domain padding).
    var_base_costs: Optional[np.ndarray] = None

    def assignment_from_indices(self, idx: Sequence[int]) -> Dict:
        return {
            name: self.domains[i][int(idx[i])]
            for i, name in enumerate(self.var_names)
        }


def _round_up(n: int, multiple: int) -> int:
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


AGGREGATIONS = ("scatter", "sorted", "boundary", "ell")
AUTO_AGGREGATION = "auto"

# Branch-and-bound message pruning (ops/maxsum.prune_tables): the
# pruned binary update gathers at most ``prune_width`` surviving rows
# per factor, a static width; below PRUNE_MIN_DOMAIN a bucket stays on
# the dense path (the bound bookkeeping would cost more than it saves).
PRUNE_WIDTH_DIVISOR = 8
PRUNE_WIDTH_CAP = 8
PRUNE_MIN_DOMAIN = 8


def prune_width(dmax: int) -> int:
    """Static surviving-row budget of the pruned binary-factor update:
    max(2, min(8, D // 8))."""
    return max(2, min(PRUNE_WIDTH_CAP, dmax // PRUNE_WIDTH_DIVISOR))


# Placeholder costs for layout-only FactorBucket shims: the aggregation
# builder reads only var_ids.
_EMPTY_COSTS = np.zeros((0,), np.float32)


def validated_aggregation(params: dict, pad_to: int) -> str:
    """An algorithm's ``aggregation`` parameter checked against the mesh
    size (reference policy): ``"auto"`` resolves to ``"scatter"`` on a
    mesh and passes through otherwise; any other non-scatter strategy
    on a mesh is refused, since sharded graphs aggregate with scatter
    only."""
    aggregation = params.get("aggregation", "scatter")
    if aggregation == AUTO_AGGREGATION:
        return "scatter" if pad_to > 1 else AUTO_AGGREGATION
    if pad_to > 1 and aggregation != "scatter":
        raise ValueError(
            f"aggregation={aggregation!r} is single-device; sharded "
            "runs always use the scatter path (engine/sharding."
            "shard_graph drops the aggregation arrays)")
    return aggregation


def build_aggregation_arrays(buckets: Sequence[FactorBucket],
                             n_segments: int, aggregation: str,
                             d: Optional[int] = None):
    """Compile-time edge indexing of the non-scatter aggregations, the
    reference's arrays byte for byte.  Edges are the flattened (bucket,
    factor, position) slots in bucket order.  Returns the five
    ``agg_*`` field values (perm, sorted_seg, starts, ends, ell).  With
    the domain size ``d`` given, ``ell`` raises ValueError at a shape
    whose sum order is unknown (``ops.ell.multi_bucket_form``)."""
    if aggregation == "scatter":
        return None, None, None, None, None
    if aggregation not in AGGREGATIONS:
        raise ValueError(
            f"aggregation must be one of {AGGREGATIONS}, "
            f"got {aggregation!r}"
        )
    seg = np.concatenate(
        [b.var_ids.reshape(-1) for b in buckets]
    ) if buckets else np.zeros((0,), np.int32)
    perm = np.argsort(seg, kind="stable").astype(np.int32)
    sorted_seg = seg[perm].astype(np.int32)
    if aggregation == "sorted":
        return perm, sorted_seg, None, None, None
    starts = np.searchsorted(
        sorted_seg, np.arange(n_segments), side="left"
    ).astype(np.int32)
    ends = np.searchsorted(
        sorted_seg, np.arange(n_segments), side="right"
    ).astype(np.int32)
    if aggregation == "boundary":
        return perm, None, starts, ends, None
    # ell: K is the largest REAL-variable degree (the sentinel row V
    # holds every padding edge and keeps an all-dummy list).
    n_edges = seg.size
    deg = ends - starts
    k_max = int(deg[:-1].max()) if n_segments > 1 and n_edges else 1
    k_max = max(k_max, 1)
    # Hub guard: K is the max degree, so one hub inflates every list.
    ell_bytes = n_segments * k_max * 4
    if ell_bytes > 2 << 30:
        raise ValueError(
            f"aggregation='ell' would allocate a {n_segments} x "
            f"{k_max} edge-list array ({ell_bytes / (1 << 30):.1f} "
            "GiB): the max variable degree is far above the mean "
            f"({n_edges / max(n_segments - 1, 1):.1f}) — use "
            "aggregation='scatter' for hub-dominated graphs")
    if d is not None:
        # Refuses the shapes whose sum order is unknown (Queue C).
        multi_bucket_form(len(buckets), d, k_max)
    ell = np.full((n_segments, k_max), n_edges, np.int32)
    k_pos = np.arange(n_edges) - starts[sorted_seg]
    real = sorted_seg < (n_segments - 1)
    ell[sorted_seg[real], k_pos[real]] = perm[real]
    return None, None, None, None, ell


def _factor_table(c: Constraint, sign: float, dtype,
                  memo: Dict) -> np.ndarray:
    """Sign-adjusted dense table for one factor, memoized on the
    structural table signature: factors whose expressions differ only
    in variable names evaluate ONCE per bucket."""
    sig = c.table_signature()
    if sig is not None:
        table = memo.get(sig)
        if table is not None:
            return table
    table = sign * np.asarray(c.to_array(), dtype=dtype)
    if sig is not None:
        memo[sig] = table
    return table


def compile_factor_graph(
    variables: Sequence[Variable],
    constraints: Sequence[Constraint],
    mode: str = "min",
    noise_level: float = 0.0,
    noise_seed: Optional[int] = None,
    pad_to: int = 1,
    dtype=np.float32,
    aggregation: str = "scatter",
    use_cache: Optional[bool] = None,
) -> Tuple[CompiledFactorGraph, FactorGraphMeta]:
    """Build the dense arrays.  ``noise_level`` adds deterministic
    per-variable-value noise (maxsum's tie-breaking noise, seeded for
    reproducibility — bit-identical to the reference's).
    ``use_cache`` controls the structure cache (:class:`CompileCache`;
    default on, ``PYDCOP_COMPILE_CACHE=0`` turns it off)."""
    if use_cache is None:
        use_cache = os.environ.get("PYDCOP_COMPILE_CACHE") != "0"
    variables = list(variables)
    constraints = list(constraints)
    with tracer.span("compile_graph", "engine",
                     n_vars=len(variables),
                     n_constraints=len(constraints)):
        return _compile_factor_graph(
            variables, constraints, mode, noise_level, noise_seed,
            pad_to, dtype, aggregation, use_cache)


def _compile_factor_graph(variables, constraints, mode, noise_level,
                          noise_seed, pad_to, dtype, aggregation,
                          use_cache):
    var_index = {v.name: i for i, v in enumerate(variables)}
    for c in constraints:
        for v in c.dimensions:
            if v.name not in var_index:
                raise ValueError(
                    f"Constraint {c.name} references variable {v.name} "
                    "which is not a decision variable of the problem"
                )
    v_count = len(variables)
    dmax = max((len(v.domain) for v in variables), default=1)
    sign = 1.0 if mode == "min" else -1.0

    # Variable cost table (+ sentinel row for padding edges).
    var_costs = np.full((v_count + 1, dmax), BIG, dtype=dtype)
    var_valid = np.zeros((v_count + 1, dmax), dtype=bool)
    var_base = np.zeros((v_count, dmax), dtype=dtype)
    for i, v in enumerate(variables):
        d = len(v.domain)
        costs = sign * v.cost_vector()[:d]
        var_base[i, :d] = costs
        if noise_level:
            costs = costs + _stable_noise(v.name, d, noise_level, noise_seed)
        var_costs[i, :d] = costs
        var_valid[i, :d] = True

    constant_cost = 0.0
    by_arity: Dict[int, List[Constraint]] = {}
    for c in constraints:
        if c.arity == 0:
            constant_cost += float(c())
            continue
        by_arity.setdefault(c.arity, []).append(c)

    # Per-factor scope indices, one [n_facs, arity] array per arity: the
    # layout is a pure function of these, v_count, pad_to and the
    # aggregation, so they key the structure cache.
    arities = sorted(by_arity)
    scope_ids: Dict[int, np.ndarray] = {}
    for arity in arities:
        facs = by_arity[arity]
        scope_ids[arity] = np.array(
            [[var_index[v.name] for v in c.dimensions] for c in facs],
            dtype=np.int32,
        ).reshape(len(facs), arity)

    layout = None
    cache_key = None
    if use_cache:
        cache_key = (
            v_count, pad_to, aggregation,
            tuple((a, scope_ids[a].tobytes()) for a in arities),
        )
        layout = compile_cache.get(cache_key)
        # registry.active gate: an unobserved solve must not leave
        # samples that a later observed solve's dump would show.
        if metrics_registry.active:
            metrics_registry.counter(
                "pydcop_compile_cache_total",
                "Structure-cache lookups by outcome",
            ).inc(outcome="hit" if layout is not None else "miss")
    if layout is None:
        compile_cache.layout_builds += 1
        if metrics_registry.active:
            metrics_registry.counter(
                "pydcop_layout_builds_total",
                "Factor-graph layout constructions (cache misses + "
                "uncached compiles)",
            ).inc()
        var_ids_by_arity = {}
        for arity in arities:
            n_facs = scope_ids[arity].shape[0]
            n_rows = _round_up(n_facs, pad_to)
            ids = np.full((n_rows, arity), v_count, dtype=np.int32)
            ids[:n_facs] = scope_ids[arity]
            var_ids_by_arity[arity] = _freeze(ids)
        agg = build_aggregation_arrays(
            [FactorBucket(_EMPTY_COSTS, ids)
             for ids in var_ids_by_arity.values()],
            v_count + 1, aggregation,
        )
        layout = (var_ids_by_arity, tuple(_freeze(a) for a in agg))
        if use_cache:
            compile_cache.put(cache_key, layout)
    var_ids_by_arity, (perm, sorted_seg, starts, ends, ell) = layout
    if ell is not None:
        # After the layout cache, which is keyed on structure: the
        # refusal of ell shapes of unknown order depends on D too.
        multi_bucket_form(len(var_ids_by_arity), dmax, ell.shape[1])

    buckets = []
    factor_names: List[str] = []
    bucket_sizes: List[int] = []
    for arity in arities:
        facs = by_arity[arity]
        n_rows = var_ids_by_arity[arity].shape[0]
        costs = np.full((n_rows,) + (dmax,) * arity, BIG, dtype=dtype)
        memo: Dict = {}
        for fi, c in enumerate(facs):
            factor_names.append(c.name)
            table = _factor_table(c, sign, dtype, memo)
            idx = tuple(slice(0, s) for s in table.shape)
            costs[(fi,) + idx] = table
        # Padding rows keep cost 0 and the sentinel variable.
        costs[len(facs):] = 0.0
        buckets.append(FactorBucket(costs, var_ids_by_arity[arity]))
        bucket_sizes.append(len(facs))
    compiled = CompiledFactorGraph(
        var_costs=var_costs,
        var_valid=var_valid,
        buckets=tuple(buckets),
        agg_perm=perm,
        agg_sorted_seg=sorted_seg,
        agg_starts=starts,
        agg_ends=ends,
        agg_ell=ell,
    )
    meta = FactorGraphMeta(
        var_names=tuple(v.name for v in variables),
        domains=tuple(tuple(v.domain) for v in variables),
        factor_names=tuple(factor_names),
        bucket_sizes=tuple(bucket_sizes),
        mode=mode,
        constant_cost=constant_cost,
        var_base_costs=var_base,
    )
    return compiled, meta


def compile_dcop(dcop: DCOP, noise_level: float = 0.0,
                 noise_seed: Optional[int] = None, pad_to: int = 1,
                 aggregation: str = "scatter",
                 use_cache: Optional[bool] = None,
                 ) -> Tuple[CompiledFactorGraph, FactorGraphMeta]:
    return compile_factor_graph(
        list(dcop.variables.values()),
        list(dcop.constraints.values()),
        mode=dcop.objective,
        noise_level=noise_level,
        noise_seed=noise_seed,
        pad_to=pad_to,
        aggregation=aggregation,
        use_cache=use_cache,
    )
