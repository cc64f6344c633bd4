"""Structure-signature binning for the solve service.

A batched dispatch (engine/batch.run_stacked) requires every instance
in the stack to compile to identical array shapes, and the service
additionally promises that two *different* problem structures never
share a dispatch (same shapes with different scopes would vmap fine
mathematically, but one misrouted meta would decode the wrong
variables — the bin key keeps the invariant structural, not just
dimensional).  The key is the serving-side analogue of the PR-3
structure cache key (engine/compile.CompileCache): variable count,
domain padding, per-bucket shapes and the exact scope-index bytes.

Solver parameters ride in the key too: ``max_cycles``/``damping``/
``stability`` are static arguments of the jitted batched program, so
requests with different parameters can never share one dispatch.

**Envelope tier (ISSUE 11).**  Structure binning is exact — and
therefore degenerates to batch-size-1 under *diverse* traffic: two
different topologies never share a dispatch, so a zipf-distributed
request stream gets no batching at all.  :func:`envelope_key` is the
second, coarser tier above :func:`structure_signature`: it rounds a
graph's shape dimensions (variable count / domain / per-arity bucket
rows) up a small ladder of **shape envelopes**, so different-structure
problems that fit the same envelope can be mask-padded to identical
shapes (engine/batch.pad_graph_to_envelope — the PR-7 sentinel-row
autopad pattern) and dispatched as ONE vmapped program with results
bit-identical to solo solves.  The ladder is powers-of-two-ish so the
number of compiled envelope programs stays logarithmic in the traffic's
shape spread.  :func:`pack_decision` is the scheduler's per-flush cost
model: envelope packing is wasted-work-vs-dispatch-overhead arbitrage,
so it only happens when the modeled win beats solo dispatch.
"""

import hashlib
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

from pydcop_tpu_torch.engine.compile import CompiledFactorGraph

# Solver parameters that are static in the batched program — the
# params half of the bin key, in canonical order.  ``prune`` rides in
# the key because the pruned and dense batched programs are different
# executables (same results — pruning never changes values).
PARAM_KEYS = ("max_cycles", "damping", "damping_nodes", "stability",
              "noise", "prune", "algo")

DEFAULT_PARAMS: Dict[str, Any] = {
    "max_cycles": 200,
    "damping": 0.5,
    "damping_nodes": "both",
    "stability": 0.1,
    "noise": 0.01,
    # 0 = dense, 1 = branch-and-bound pruning, "auto" = replay the
    # portfolio racer's cached decision for this structure (resolved
    # to 0/1 at submit, AFTER the graph compiles — never measured on
    # the serving path).
    "prune": 0,
    # "maxsum" = the iterative batched engine; "dpop" = exact
    # inference (ISSUE 17): results carry ``optimal: true``, width is
    # checked AT SUBMIT against ops/dpop.MAX_NODE_ELEMENTS (CEC
    # shrinkage included) and an over-wide problem is a structured 400
    # ``rejected_width``, never a dispatch-time 500.  Rides the bin
    # key, so dpop traffic never shares a dispatch with maxsum.
    "algo": "maxsum",
}


DAMPING_NODES = ("vars", "factors", "both", "none")

SERVING_ALGOS = ("maxsum", "dpop")


def normalize_params(overrides: Dict[str, Any] = None) -> Dict[str, Any]:
    """Fill a request's solver-parameter dict from the service
    defaults, rejecting unknown keys (a typo'd parameter silently
    falling back to a default would be a debugging trap) and
    canonicalizing every value's type — the values land in a hashable
    bin key AND in the jitted program's static arguments, so an
    unhashable or wrong-typed value must fail the submit (a 400), not
    the scheduler thread."""
    params = dict(DEFAULT_PARAMS)
    for key, value in (overrides or {}).items():
        if key not in DEFAULT_PARAMS:
            raise ValueError(
                f"unknown solver parameter {key!r}; valid: "
                f"{', '.join(PARAM_KEYS)}"
            )
        params[key] = value
    try:
        params["max_cycles"] = int(params["max_cycles"])
        for key in ("damping", "stability", "noise"):
            params[key] = float(params[key])
    except (TypeError, ValueError) as exc:
        raise ValueError(f"bad solver parameter value: {exc}")
    if params["prune"] != "auto":
        try:
            params["prune"] = int(params["prune"])
        except (TypeError, ValueError):
            params["prune"] = -1  # falls through to the check below
    if params["prune"] not in (0, 1, "auto"):
        raise ValueError(
            f"prune must be 0, 1 or 'auto', got "
            f"{(overrides or {}).get('prune')!r}")
    if params["damping_nodes"] not in DAMPING_NODES:
        raise ValueError(
            f"damping_nodes must be one of {DAMPING_NODES}, got "
            f"{params['damping_nodes']!r}")
    if params["algo"] not in SERVING_ALGOS:
        raise ValueError(
            f"algo must be one of {SERVING_ALGOS}, got "
            f"{params['algo']!r}")
    return params


def structure_signature(graph: CompiledFactorGraph) -> Tuple:
    """Hashable structural identity of a compiled graph.

    Shapes alone define *stackability*; the scope-index bytes make the
    signature injective over topologies, which is what "two structures
    never share a dispatch" needs.  Cost tables are deliberately NOT
    in the signature — same-structure requests with different costs
    are exactly the traffic that should coalesce.
    """
    return (
        graph.var_costs.shape,
        tuple(
            (b.costs.shape, b.var_ids.tobytes()) for b in graph.buckets
        ),
        # Aggregation layout arrays change the compiled program shape.
        tuple(
            None if a is None else a.shape
            for a in (graph.agg_perm, graph.agg_sorted_seg,
                      graph.agg_starts, graph.agg_ends, graph.agg_ell)
        ),
    )


def bin_key(graph: CompiledFactorGraph,
            params: Dict[str, Any]) -> Tuple:
    """The scheduler's bin key: structure signature + solver params."""
    return (
        structure_signature(graph),
        tuple((k, params[k]) for k in PARAM_KEYS),
    )


def affinity_key(dcop, params: Optional[Dict[str, Any]] = None) -> str:
    """Router-side structure-affinity key (serving/router.py): a
    process-stable digest computed from the PROBLEM MODEL, without
    building cost tables.

    The fleet router must group traffic exactly the way a worker's
    :func:`bin_key` will — same-structure requests must land on the
    replica whose compiled program is already warm — but it must not
    pay a full ``compile_dcop`` (hypercube cost-table fill) per
    routed request.  On the serving compile path (``pad_to=1``,
    scatter aggregation) the bin key's structure half is a pure
    function of (variable count, max domain size, per-arity scope
    indices) — precisely what this digest hashes, in the same
    variable order ``compile_dcop`` uses — so two DCOPs share an
    affinity key iff they share a serving bin key
    (partition-equivalence asserted in tests/unit/
    test_fleet_battery.py).  The params half rides along exactly like
    :func:`bin_key`'s; ``prune="auto"`` is keyed as the literal
    string (workers resolve it per structure AFTER compile — the
    router cannot, so auto-pruned traffic may split across at most
    two replicas per structure).
    """
    merged = normalize_params(params)
    var_index = {name: i for i, name in enumerate(dcop.variables)}
    dmax = max((len(v.domain) for v in dcop.variables.values()),
               default=1)
    by_arity: Dict[int, list] = {}
    for c in dcop.constraints.values():
        if c.arity == 0:
            continue
        by_arity.setdefault(c.arity, []).append(
            tuple(var_index[v.name] for v in c.dimensions))
    structure = (
        len(var_index), dmax,
        tuple((arity, tuple(by_arity[arity]))
              for arity in sorted(by_arity)),
        tuple((k, merged[k]) for k in PARAM_KEYS),
    )
    return hashlib.sha1(repr(structure).encode()).hexdigest()


def bin_label(key: Tuple) -> str:
    """Short low-cardinality label for a bin key (metrics/trace): the
    variable-count/domain part of the shape plus a process-stable
    digest of the rest — full keys embed scope bytes and would
    explode label cardinality, and the built-in ``hash`` is
    per-process randomized (labels must survive restarts so merged
    traces from two serving processes correlate by bin)."""
    (var_shape, _buckets, _agg), _params = key
    digest = hashlib.sha1(repr(key).encode()).hexdigest()[:6]
    return f"v{var_shape[0] - 1}d{var_shape[1]}h{digest}"


# --------------------------------------------------------------------- #
# Envelope tier: shape-envelope keys, padding accounting and the
# per-flush pack-vs-solo cost model (ISSUE 11).

class EnvelopeLadder(NamedTuple):
    """Rounding rungs per shape dimension.  Each dimension rounds UP
    to its first rung >= the real size (past the top rung: the next
    power of two — an oversized problem still envelopes, it just gets
    a rarer key).  Powers-of-two-ish defaults keep the compiled
    envelope-program count logarithmic in the traffic's shape
    spread."""

    vars: Tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512, 1024,
                             2048, 4096)
    domain: Tuple[int, ...] = (2, 4, 8, 16, 32, 64, 128)
    rows: Tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512, 1024,
                             2048, 4096, 8192)


DEFAULT_LADDER = EnvelopeLadder()

# Rounding for lane-packed UNIONS (engine/batch.run_lane_packed):
# deliberately MUCH coarser than the grouping ladder.  A union's
# shapes depend on the flush's group composition, and every distinct
# shape is a fresh XLA compile of the whole solve loop (~0.3-0.8 s on
# CPU) — with fine rungs a diverse stream produces a new program
# almost every flush and the compile stalls eat the packing win.
# Power-of-two rungs starting at 64 keep it to a handful of programs
# for small-problem traffic while letting SMALL groups (2-3 members)
# pack into small unions — the pack decision charges the whole padded
# union's cells, so a coarse-only ladder would price pairs out of
# packing entirely.
UNION_LADDER = EnvelopeLadder(
    vars=(64, 128, 256, 512, 1024, 2048, 4096, 16384),
    domain=(2, 4, 8, 16, 32, 64, 128),
    rows=(64, 128, 256, 512, 1024, 2048, 4096, 16384),
)


def ladder_round(n: int, rungs: Sequence[int]) -> int:
    """First rung >= n; past the top, the next power of two >= n."""
    n = max(int(n), 1)
    for r in rungs:
        if r >= n:
            return r
    p = 1
    while p < n:
        p <<= 1
    return p


class Envelope(NamedTuple):
    """One shape envelope: every dimension is an upper bound a graph
    is mask-padded to (engine/batch.pad_graph_to_envelope).  ``rows``
    is arity-sorted ``((arity, padded_rows), ...)`` — the arity SET is
    exact (padding hypercube rank would multiply, not add, waste), the
    row counts are ladder rungs."""

    v_env: int                          # real-variable rows (no sentinel)
    d_env: int                          # padded domain
    rows: Tuple[Tuple[int, int], ...]   # ((arity, rows_env), ...)


def envelope_key(graph: CompiledFactorGraph,
                 ladder: EnvelopeLadder = DEFAULT_LADDER) -> Envelope:
    """The coarse second-tier key above :func:`structure_signature`:
    ladder-rounded shape dimensions only.  Monotone (a graph that
    grows in any dimension never gets a smaller envelope) and covering
    (every dimension >= the graph's real size) — both battery-asserted
    (tests/unit/test_envelope_battery.py)."""
    return Envelope(
        v_env=ladder_round(graph.n_vars, ladder.vars),
        d_env=ladder_round(graph.dmax, ladder.domain),
        rows=tuple(sorted(
            (b.arity, ladder_round(b.n_factors, ladder.rows))
            for b in graph.buckets
        )),
    )


def graph_cells(graph: CompiledFactorGraph) -> int:
    """Device-array elements the MaxSum superstep touches for this
    graph — the work unit of the pack-vs-solo cost model and of the
    honest ``envelope_waste`` accounting (variable table incl.
    sentinel row + every bucket hypercube)."""
    return int(
        graph.var_costs.shape[0] * graph.var_costs.shape[1]
        + sum(b.costs.size for b in graph.buckets)
    )


def envelope_cells(env: Envelope) -> int:
    """:func:`graph_cells` of any graph padded to ``env``."""
    return int(
        (env.v_env + 1) * env.d_env
        + sum(r * env.d_env ** a for a, r in env.rows)
    )


def lane_cells(graph: CompiledFactorGraph, d_env: int) -> int:
    """:func:`graph_cells` of the graph with only its DOMAIN padded to
    ``d_env`` — the per-member work in a lane-packed union dispatch
    (ops/maxsum_lane packing concatenates factors/variables instead of
    padding them, so the only mask waste left is the domain rung)."""
    return int(
        graph.var_costs.shape[0] * d_env
        + sum(b.n_factors * d_env ** b.arity for b in graph.buckets)
    )


def envelope_label(env: Envelope) -> str:
    """Low-cardinality metrics/trace label for an envelope."""
    rows = "_".join(f"a{a}x{r}" for a, r in env.rows)
    return f"env_v{env.v_env}d{env.d_env}_{rows or 'nofactors'}"


# Cost-model constants, fitted on the CPU backend (the affine
# per-dispatch model ``overhead + cycles * (per_cycle + cells *
# per_cell)``; measured points: a 370-cell solo ring at 60 cycles
# costs ~1.1 ms end-to-end, a 3075-cell padded union ~4.9 ms — the
# per-CYCLE fixed op overhead, not the cell work, dominates tiny
# problems, which is why a naive cells-only model over-packs).
# ``PACK_OVERHEAD_MS`` is the per-dispatch fixed cost (jit-cache
# lookup + host launch + result fetch; SolveService exposes it as
# ``envelope_overhead_ms``).  On TPU the fixed costs are larger and
# the cell work cheaper, so this calibration UNDER-estimates the
# packing win there — conservative in the safe direction.
PACK_OVERHEAD_MS = 0.3
MODEL_US_PER_CYCLE = 5.0
MODEL_NS_PER_CELL_CYCLE = 25.0


def modeled_solve_ms(cells: int, max_cycles: int,
                     constants: Optional[Dict[str, Any]] = None
                     ) -> float:
    """Affine dispatch-compute model (ms), excluding the per-dispatch
    fixed overhead.

    ``constants`` overrides the compiled-in CPU-fitted defaults with
    online-fitted ones (engine/autotune.fitted_pack_constants — keys
    ``us_per_cycle`` / ``ns_per_cell_cycle``): the self-tuning pack
    planner feeds measured ledgers of past dispatches back into the
    very model that prices the next one."""
    us_per_cycle = MODEL_US_PER_CYCLE
    ns_per_cell = MODEL_NS_PER_CELL_CYCLE
    if constants:
        us_per_cycle = float(
            constants.get("us_per_cycle", us_per_cycle))
        ns_per_cell = float(
            constants.get("ns_per_cell_cycle", ns_per_cell))
    return max_cycles * (us_per_cycle * 1e-3
                         + cells * ns_per_cell * 1e-6)


def solve_prior_ms(real_cells: int, max_cycles: int,
                   portfolio_ms: Optional[float] = None,
                   race_cycles: int = 60,
                   constants: Optional[Dict[str, Any]] = None
                   ) -> Tuple[float, str]:
    """Per-structure solo solve-time prior (ms) for the cost model.

    When the PR-10 portfolio racer has a cached time-to-cost entry for
    the structure (engine/autotune.cached_portfolio_timing_ms — a real
    measured solve of ``race_cycles`` cycles on this backend), that is
    the prior, scaled to the request's cycle budget.  Otherwise the
    affine model — honest about being a model (source ``"model"``), so
    the decision record shows which dispatches were decided on
    measurement and which on estimate."""
    if portfolio_ms is not None and portfolio_ms > 0:
        return (portfolio_ms * max_cycles / max(race_cycles, 1),
                "portfolio")
    return (modeled_solve_ms(real_cells, max_cycles,
                             constants=constants), "model")


def lane_union_cells(graphs: Sequence[CompiledFactorGraph],
                     d_env: int,
                     ladder: EnvelopeLadder = UNION_LADDER) -> int:
    """Cells of the PADDED lane union these members would produce
    (mirrors engine/batch.run_lane_packed's rounding) — what the pack
    decision must charge, since the union's sentinel-row padding costs
    real per-cycle time whether or not any member needed it."""
    v_total = sum(g.n_vars for g in graphs)
    rows: Dict[int, int] = {}
    for g in graphs:
        for b in g.buckets:
            rows[b.arity] = rows.get(b.arity, 0) + b.n_factors
    v_env = ladder_round(v_total, ladder.vars)
    return int(
        (v_env + 1) * d_env
        + sum(ladder_round(r, ladder.rows) * d_env ** a
              for a, r in rows.items())
    )


def pack_decision(real_cells: Sequence[int],
                  prior_ms: Sequence[float],
                  packed_cells_total: int,
                  max_cycles: int,
                  overhead_ms: float = PACK_OVERHEAD_MS,
                  constants: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """The per-flush envelope decision: does ONE padded dispatch beat
    N solo dispatches for this group?

    Solo side: each member's measured-or-modeled solve prior plus one
    dispatch overhead each.  Packed side: one overhead plus the affine
    model over the WHOLE padded dispatch's cells
    (``packed_cells_total`` — envelope lanes or the rounded lane
    union, padding included: masked cells still burn per-cycle time).
    Work is summed, not maxed — honest for the CPU backend where
    batched lanes serialize, conservative for TPU where they share
    vector units (a pack that wins under the sum model wins harder on
    chip).  Returns the full modeled record so scheduler decisions
    are replayable in tests and auditable in /stats.

    ``constants`` threads online-fitted model constants through
    (see :func:`modeled_solve_ms`); the decision records where its
    constants came from (``constants_source: fitted|default``) so an
    operator reading ``envelope_decisions`` can tell a measured
    verdict from a cold-start one."""
    n = len(real_cells)
    if constants and "overhead_ms" in constants \
            and float(constants["overhead_ms"]) > 0:
        overhead_ms = float(constants["overhead_ms"])
    solo_ms = sum(prior_ms) + overhead_ms * n
    packed_ms = overhead_ms + modeled_solve_ms(
        packed_cells_total, max_cycles, constants=constants)
    real_total = sum(real_cells)
    return {
        "n": n,
        "packed": bool(n > 1 and packed_ms < solo_ms),
        "solo_ms": round(solo_ms, 4),
        "packed_ms": round(packed_ms, 4),
        "overhead_ms": round(overhead_ms, 4),
        "packed_cells": int(packed_cells_total),
        "waste": round(
            1.0 - real_total / max(packed_cells_total, 1), 4),
        "constants_source": "fitted" if constants else "default",
    }
