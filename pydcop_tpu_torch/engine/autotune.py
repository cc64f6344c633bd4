"""Autotuners: ``aggregation='auto'`` picks the belief aggregation and
``algo='auto'`` the algorithm, each by measurement.

Port of ``pydcop_tpu/engine/autotune.py``.  The aggregation
autotuner: time
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

The portfolio racer (:func:`autotune_portfolio`) runs each candidate
algorithm for a short budget of cycles on the placed graph and picks
the fastest whose final cost comes within ``_PORTFOLIO_COST_TOL`` of the
best; DPOP races only under :data:`DPOP_RACE_MAX_ELEMENTS`.  As for the
aggregation, only the refusals a leg raises by design on a valid graph
(:data:`LEG_REFUSALS`) drop it from the race: a kernel that fails to
build or launch fails the solve.

Decisions persist in a JSON file keyed by (backend, graph shape); the
backend is the torch device type (``"cuda"``/``"cpu"``), which on the
CPU is also the JAX package's token, and both packages read
``PYDCOP_AGG_AUTOTUNE_CACHE``.  So every entry this module stores
carries ``WRITER_KEY: WRITER``, and it replays only entries that do:
never a decision the JAX package measured.  The default file is
``~/.cache/pydcop_tpu_torch/agg_autotune.json``;
``PYDCOP_AGG_AUTOTUNE_CACHE`` names another.  A file that cannot be
written is logged and skipped.

The pack fitting (:func:`record_pack_sample`,
:func:`fitted_pack_constants`) keeps the envelope planner's cost-model
constants, fitted online from measured dispatches, in the same file.
"""

import json
import logging
import os
import tempfile
import threading
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
from pydcop_tpu_torch.ops.dpop import UtilTooLargeError
from pydcop_tpu_torch.ops.ell import multi_bucket_form

logger = logging.getLogger("pydcop_tpu_torch.engine.autotune")

# Strategies a solve may run with ("boundary" is excluded on numerics).
SELECTABLE = ("scatter", "sorted", "ell")

_CACHE_VERSION = 1

# The field every entry this module stores carries, and the only
# entries it replays.
WRITER_KEY = "writer"
WRITER = "pydcop_tpu_torch"


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
    cached = _cached_entry(_load_cache(cache_file or cache_path()), key)
    if cached is not None and cached.get("aggregation") in SELECTABLE:
        return cached["aggregation"]
    return None


def _cached_entry(data: Dict[str, Any], key: str
                  ) -> Optional[Dict[str, Any]]:
    """The entry stored under ``key`` when this module wrote it."""
    cached = data.get(key)
    if isinstance(cached, dict) and cached.get(WRITER_KEY) == WRITER:
        return cached
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
    """Merge ``data`` (each entry marked with :data:`WRITER`) into the
    file and replace it atomically; an ``OSError`` is logged and the
    decision is not persisted."""
    data = {k: {**v, WRITER_KEY: WRITER} for k, v in data.items()}
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
        cached = _cached_entry(_load_cache(path), key)
        if cached is not None and cached.get("aggregation") in SELECTABLE:
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


# --------------------------------------------------------------------- #
# Whole-algorithm portfolio racer: each candidate races a short budget
# of cycles on the placed graph; the winner is the fastest candidate
# whose final cost reaches the best cost any candidate achieved (within
# tolerance).  Decisions persist in the aggregation autotuner's file
# under their own key prefix, so a same-structure solve replays them.

# Candidate order is the tie-break (maxsum first).  "dpop" races only
# when the caller passes its runner in ``extra_runners``, which
# :func:`dpop_portfolio_runner` builds only under the width gate.
PORTFOLIO_CANDIDATES = (
    "maxsum", "maxsum_prune", "maxsum_decim", "dsa", "mgm", "gdba",
    "dpop",
)

# Winner -> (algorithm name, extra algo_params) for api.solve.
PORTFOLIO_PARAMS = {
    "maxsum": ("maxsum", {}),
    "maxsum_prune": ("maxsum", {"prune": True}),
    "maxsum_decim": ("maxsum", {"decimation": 10}),
    "dsa": ("dsa", {}),
    "mgm": ("mgm", {}),
    "gdba": ("gdba", {}),
    "dpop": ("dpop", {}),
}

# Width gate for racing exact inference, far below
# ops/dpop.MAX_NODE_ELEMENTS: past it DPOP is reachable only by name.
DPOP_RACE_MAX_ELEMENTS = 2 ** 20

_PORTFOLIO_PREFIX = f"portfolio-v{_CACHE_VERSION}|"

# A candidate's final cost must come within this fraction of the best
# (plus an absolute epsilon for zero-cost targets) to win on time.
_PORTFOLIO_COST_TOL = 0.02
_PORTFOLIO_RACE_CYCLES = 60
# The cycle count a race leg runs (consumers scale its time by it).
PORTFOLIO_RACE_CYCLES = _PORTFOLIO_RACE_CYCLES


# The exceptions a leg raises by design on a valid graph (DPOP's UTIL
# table past MAX_NODE_ELEMENTS): a leg that raises one is dropped from
# the race; anything else fails it.
LEG_REFUSALS = (UtilTooLargeError,)


def portfolio_key(shape: str) -> str:
    return _PORTFOLIO_PREFIX + shape


def dcop_portfolio_key(dcop, backend: str) -> str:
    return portfolio_key(dcop_shape_key(dcop, backend))


def _portfolio_entry(data: Dict[str, Any], key: str
                     ) -> Optional[Dict[str, Any]]:
    cached = _cached_entry(data, key)
    if cached is not None and cached.get("algo") in PORTFOLIO_CANDIDATES:
        return cached
    return None


def cached_portfolio_choice(key: str,
                            cache_file: Optional[str] = None
                            ) -> Optional[str]:
    """The stored portfolio decision for ``key``, or None."""
    cached = _portfolio_entry(_load_cache(cache_file or cache_path()), key)
    return None if cached is None else cached["algo"]


def cached_portfolio_timing_ms(key: str,
                               cache_file: Optional[str] = None,
                               data: Optional[Dict[str, Any]] = None
                               ) -> Optional[float]:
    """The stored winner's race time (ms over
    :data:`PORTFOLIO_RACE_CYCLES` cycles) for ``key``, or None.
    ``data`` is an already-loaded cache dict."""
    if data is None:
        data = _load_cache(cache_file or cache_path())
    cached = _portfolio_entry(data, key)
    if cached is not None:
        timing = (cached.get("portfolio_timings_ms")
                  or {}).get(cached["algo"])
        if isinstance(timing, (int, float)) and timing > 0:
            return float(timing)
    return None


def _portfolio_runners(graph: CompiledFactorGraph, race_cycles: int,
                       meta=None, device: DeviceLike = "cuda"):
    """name -> zero-arg callable returning a leg's final cost (a host
    float), each on the graph placed once on ``device``.  A leg's
    first call builds its kernels; the caller times the second.

    ``meta`` (a FactorGraphMeta) gives mgm and gdba the lexical-name
    tie-break ranks the deployed winner uses; without it, index order
    with the +inf sentinel."""
    from pydcop_tpu_torch.engine.compile import BIG
    from pydcop_tpu_torch.ops import dsa as dsa_ops
    from pydcop_tpu_torch.ops import gdba as gdba_ops
    from pydcop_tpu_torch.ops import maxsum as maxsum_ops
    from pydcop_tpu_torch.ops import mgm as mgm_ops
    from pydcop_tpu_torch.ops.localsearch import assignment_cost

    dev = resolve_device(device)
    placed = to_device_graph(graph, dev)
    n_rows = graph.var_costs.shape[0]
    if meta is not None:
        from pydcop_tpu_torch.algorithms.mgm import lexic_ranks

        ranks = torch.tensor(lexic_ranks(meta), device=dev)
    else:
        ranks = torch.cat([
            torch.arange(n_rows - 1, dtype=torch.float32, device=dev),
            torch.tensor([np.inf], dtype=torch.float32, device=dev),
        ])

    def cost_of(values):
        # The reference scores inside the leg's jit with the graph
        # closed over (ROADMAP Queue C: the form there is the local
        # search's on the graphs probed).
        full = torch.cat([values, torch.zeros(
            (1,), dtype=values.dtype, device=values.device)])
        return assignment_cost(placed, full)

    def maxsum_runner(prune: bool):
        def run():
            _, values = maxsum_ops.run_maxsum(
                placed, race_cycles, stop_on_convergence=False,
                prune=prune)
            return float(cost_of(values))

        return run

    def decim_runner():
        half = max(race_cycles // 2, 1)

        def run():
            state, values = maxsum_ops.run_maxsum(
                placed, half, stop_on_convergence=False)
            margin = _belief_margin(placed, state).cpu().numpy()
            vals = values.cpu().numpy()
            var_costs = placed.var_costs.cpu().numpy().copy()
            n_vars = var_costs.shape[0] - 1
            k = max(1, n_vars // 5)
            chosen = np.argsort(-margin, kind="stable")[:k]
            d = var_costs.shape[1]
            for i in chosen:
                keep = int(vals[i])
                row = np.full((d,), BIG, var_costs.dtype)
                row[keep] = var_costs[i, keep]
                var_costs[i] = row
            g2 = placed._replace(var_costs=torch.tensor(var_costs,
                                                        device=dev))
            state = state._replace(stable=torch.tensor(False, device=dev))
            _, values = maxsum_ops.run_maxsum_from(
                g2, state, half, stop_on_convergence=False)
            # Scored against the unclamped graph, as the reference.
            return float(cost_of(values))

        return run

    def ls_runner(run_fn, **kw):
        return lambda: float(run_fn(placed, race_cycles, **kw)[1])

    return {
        "maxsum": maxsum_runner(False),
        "maxsum_prune": maxsum_runner(True),
        "maxsum_decim": decim_runner(),
        "dsa": ls_runner(dsa_ops.run_dsa),
        "mgm": ls_runner(mgm_ops.run_mgm, lexic_ranks=ranks),
        "gdba": ls_runner(gdba_ops.run_gdba, lexic_ranks=ranks),
    }


def dpop_portfolio_runner(dcop, graph: CompiledFactorGraph, meta,
                          device: DeviceLike = "cuda"):
    """The exact-inference race leg, or None past the width gate
    (decided from the pseudo-tree before any table exists, CEC
    shrinkage included).  The leg scores its assignment with the
    compiled graph's ``assignment_cost``, as the iterative legs do."""
    from pydcop_tpu_torch.computations_graph import pseudotree as pt
    from pydcop_tpu_torch.engine.dpop import DpopEngine, dpop_feasibility
    from pydcop_tpu_torch.ops.localsearch import assignment_cost

    ptree = pt.build_computation_graph(dcop)
    verdict = dpop_feasibility(
        ptree, mode=dcop.objective, cec=True,
        max_elements=DPOP_RACE_MAX_ELEMENTS)
    if not verdict["feasible"]:
        logger.debug(
            "portfolio: dpop leg skipped (max_elements %s > gate %s)",
            verdict["max_elements"], DPOP_RACE_MAX_ELEMENTS)
        return None
    dev = resolve_device(device)
    engine = DpopEngine(ptree, mode=dcop.objective, cec=True, device=dev)
    placed = to_device_graph(graph, dev)
    index_of = {
        name: {v: i for i, v in enumerate(dom)}
        for name, dom in zip(meta.var_names, meta.domains)
    }

    def run():
        res = engine.run()
        idx = torch.tensor(
            [index_of[n][res.assignment[n]] for n in meta.var_names]
            + [0], dtype=torch.int32, device=dev)
        # The reference scores this leg op by op, outside any jit.
        return float(assignment_cost(placed, idx, site="eager"))

    return run


def _belief_margin(graph, state) -> torch.Tensor:
    """[V]: second-best minus best belief over each variable's valid
    slots (the decimation leg's confidence)."""
    from pydcop_tpu_torch.ops.flush import ftz
    from pydcop_tpu_torch.ops.maxsum import aggregate_beliefs

    beliefs, _ = aggregate_beliefs(graph, state.f2v)
    masked = torch.where(graph.var_valid, beliefs, torch.inf)[:-1]
    best2 = torch.sort(masked, dim=1).values[:, :2]
    return ftz(best2[:, 1] - best2[:, 0])


def autotune_portfolio(graph: CompiledFactorGraph, *,
                       key: Optional[str] = None,
                       race_cycles: int = _PORTFOLIO_RACE_CYCLES,
                       use_cache: bool = True,
                       cache_file: Optional[str] = None,
                       candidates=PORTFOLIO_CANDIDATES,
                       meta=None,
                       extra_runners=None,
                       device: DeviceLike = "cuda",
                       ) -> Dict[str, Any]:
    """Race whole algorithms on ``graph`` toward a cost target, on
    ``device``.

    Every candidate runs ``race_cycles`` cycles twice; the second run
    is timed, up to the host's read of its cost.  The target is the
    best final cost of any candidate; the winner is the fastest
    candidate within ``_PORTFOLIO_COST_TOL`` of it, ties going to the
    earlier candidate.  A leg that raises one of :data:`LEG_REFUSALS`
    is dropped with a note; any other exception fails the race.

    Returns ``{"algo", "portfolio_source", "portfolio_timings_ms",
    "portfolio_costs", "portfolio_target_cost", "portfolio_key"}`` and
    stores the decision under ``key`` (``portfolio_source`` is
    ``"cache"`` on a replay, ``"measured"`` otherwise)."""
    import time as _time

    dev = resolve_device(device)
    if key is None:
        key = portfolio_key(graph_shape_key(graph, dev.type))
    path = cache_file or cache_path()
    if use_cache:
        cached = _portfolio_entry(_load_cache(path), key)
        if cached is not None:
            return {
                "algo": cached["algo"],
                "portfolio_source": "cache",
                "portfolio_timings_ms": cached.get(
                    "portfolio_timings_ms", {}),
                "portfolio_costs": cached.get("portfolio_costs", {}),
                "portfolio_target_cost": cached.get(
                    "portfolio_target_cost"),
                "portfolio_key": key,
            }

    runners = _portfolio_runners(graph, race_cycles, meta=meta, device=dev)
    if extra_runners:
        # A None runner: the candidate does not race on this structure.
        runners.update(
            {k: v for k, v in extra_runners.items() if v is not None})
    timings_ms: Dict[str, Optional[float]] = {}
    costs: Dict[str, Optional[float]] = {}
    notes: Dict[str, str] = {}
    for name in candidates:
        runner = runners.get(name)
        if runner is None:
            continue
        try:
            runner()  # builds the kernels; discarded
            t0 = _time.perf_counter()
            cost = runner()
            timings_ms[name] = round(
                (_time.perf_counter() - t0) * 1e3, 4)
            costs[name] = cost
        except LEG_REFUSALS as e:
            notes[name] = f"{type(e).__name__}"
            logger.warning("portfolio: %s refused to race: %s", name, e)
            timings_ms[name] = None
            costs[name] = None

    scored = {n: (costs[n], timings_ms[n]) for n in candidates
              if costs.get(n) is not None
              and timings_ms.get(n) is not None}
    if not scored:
        choice = "maxsum"
        target = None
    else:
        target = min(c for c, _ in scored.values())
        tol = abs(target) * _PORTFOLIO_COST_TOL + 1e-9
        eligible = {n: t for n, (c, t) in scored.items()
                    if c <= target + tol}
        order = {n: i for i, n in enumerate(candidates)}
        choice = min(eligible, key=lambda n: (eligible[n], order[n]))
    result = {
        "algo": choice,
        "portfolio_source": "measured",
        "portfolio_timings_ms": timings_ms,
        "portfolio_costs": costs,
        "portfolio_target_cost": target,
        "portfolio_key": key,
    }
    if notes:
        result["portfolio_notes"] = notes
    if use_cache:
        _store_cache(path, {key: {
            "algo": choice,
            "portfolio_timings_ms": timings_ms,
            "portfolio_costs": costs,
            "portfolio_target_cost": target,
            "backend": dev.type,
        }})
    return result


# --------------------------------------------------------------------
# Self-tuning pack-planner constants (the reference's pack fitting).
#
# The envelope pack-vs-solo decision (serving/binning.pack_decision)
# prices dispatches with an affine model ``overhead + cycles *
# (per_cycle + cells * per_cell)``.  Every completed dispatch is a
# measured sample of that model (its execute wall, its padded cell
# total, its cycle budget), so the constants are re-fitted online per
# backend: an exponentially-weighted least-squares regression of
# ms-per-cycle on cells (intercept -> us_per_cycle, slope ->
# ns_per_cell_cycle) plus an EW mean of the per-dispatch host overhead.
# Persisted in the same JSON as the other decisions (key
# ``packfit-v1|<backend>``), marked with WRITER like every entry this
# module stores; the port reads back only entries it wrote.  Cold start
# (< _PACKFIT_MIN_SAMPLES samples, or a degenerate fit) falls back to
# the compiled-in defaults.  ``PYDCOP_PACK_FIT=0`` disables both
# recording and use.

PACKFIT_PREFIX = f"packfit-v{_CACHE_VERSION}|"
_PACKFIT_DECAY = 0.98
_PACKFIT_MIN_SAMPLES = 8
_PACKFIT_PERSIST_EVERY = 16
_packfit_lock = threading.Lock()
# backend -> EW sufficient statistics {w, wx, wy, wxx, wxy, wo, n}
_packfit_state: Dict[str, Dict[str, float]] = {}
_packfit_dirty: Dict[str, int] = {}


def pack_fit_enabled() -> bool:
    """``PYDCOP_PACK_FIT=0`` freezes the pack planner on the
    compiled-in default constants."""
    return os.environ.get("PYDCOP_PACK_FIT", "1") != "0"


def _packfit_key(backend: str) -> str:
    return PACKFIT_PREFIX + str(backend)


def _packfit_load(backend: str,
                  cache_file: Optional[str] = None) -> Dict[str, float]:
    """Seed the in-memory EW state from the persisted JSON once per
    backend per process (under ``_packfit_lock``), from an entry this
    module wrote only."""
    state = _packfit_state.get(backend)
    if state is not None:
        return state
    persisted = _cached_entry(_load_cache(cache_file or cache_path()),
                              _packfit_key(backend))
    state = {"w": 0.0, "wx": 0.0, "wy": 0.0, "wxx": 0.0,
             "wxy": 0.0, "wo": 0.0, "n": 0.0}
    if persisted is not None:
        stats = persisted.get("stats")
        if isinstance(stats, dict):
            for k in state:
                v = stats.get(k)
                if isinstance(v, (int, float)) and np.isfinite(v):
                    state[k] = float(v)
    _packfit_state[backend] = state
    return state


def record_pack_sample(backend: str, cells: int, cycles: int,
                       execute_s: float, overhead_s: float = 0.0,
                       cache_file: Optional[str] = None) -> None:
    """Feed one measured dispatch into the per-backend fit.

    ``execute_s`` is the dispatch's device execute wall (a warm
    dispatch's ``run_time_s``), ``cells`` the PADDED cell total the
    device ran (``metrics['cells_total']``), ``overhead_s`` the host's
    per-dispatch fixed cost.  Cold dispatches must not be fed.
    Persists every ``_PACKFIT_PERSIST_EVERY`` samples (atomic
    merge-write; a failure keeps the fit in memory only)."""
    if not pack_fit_enabled():
        return
    if cells <= 0 or cycles <= 0 or execute_s <= 0:
        return
    x = float(cells)
    y = execute_s * 1e3 / float(cycles)  # ms per cycle
    with _packfit_lock:
        state = _packfit_load(backend, cache_file)
        d = _PACKFIT_DECAY
        for k in ("w", "wx", "wy", "wxx", "wxy", "wo"):
            state[k] *= d
        state["w"] += 1.0
        state["wx"] += x
        state["wy"] += y
        state["wxx"] += x * x
        state["wxy"] += x * y
        state["wo"] += max(overhead_s, 0.0) * 1e3
        state["n"] += 1.0
        _packfit_dirty[backend] = _packfit_dirty.get(backend, 0) + 1
        if _packfit_dirty[backend] >= _PACKFIT_PERSIST_EVERY:
            _packfit_dirty[backend] = 0
            fitted = _packfit_fit(state)
            _store_cache(cache_file or cache_path(), {
                _packfit_key(backend): {
                    "stats": dict(state),
                    "fitted": fitted,
                    "backend": backend,
                }})


def _packfit_fit(state: Dict[str, float]) -> Optional[Dict[str, float]]:
    """Solve the EW least squares for the model constants; None when
    under-sampled or degenerate (the caller falls back to defaults)."""
    if state["n"] < _PACKFIT_MIN_SAMPLES or state["w"] <= 0:
        return None
    w, wx, wy, wxx, wxy = (state["w"], state["wx"], state["wy"],
                           state["wxx"], state["wxy"])
    denom = w * wxx - wx * wx
    if denom <= 1e-12:
        return None
    slope = (w * wxy - wx * wy) / denom        # ms/cycle per cell
    intercept = (wy - slope * wx) / w          # ms/cycle at 0 cells
    if not (np.isfinite(slope) and np.isfinite(intercept)):
        return None
    if slope <= 0 or intercept < 0:
        # The sampled range cannot identify the model (e.g. one shape
        # dominating traffic): an unidentified fit must not steer.
        return None
    return {
        "us_per_cycle": round(intercept * 1e3, 6),
        "ns_per_cell_cycle": round(slope * 1e6, 6),
        "overhead_ms": round(state["wo"] / w, 6),
        "n": int(state["n"]),
    }


def fitted_pack_constants(backend: str,
                          cache_file: Optional[str] = None
                          ) -> Optional[Dict[str, float]]:
    """The current fitted constants for ``backend`` (``us_per_cycle``,
    ``ns_per_cell_cycle``, ``overhead_ms``, ``n``: what
    ``serving.binning.pack_decision`` consumes), or None while
    cold/degenerate/disabled."""
    if not pack_fit_enabled():
        return None
    with _packfit_lock:
        state = _packfit_load(backend, cache_file)
        return _packfit_fit(state)


def _packfit_reset() -> None:
    """Test hook: drop the in-memory EW state (the JSON is untouched;
    point ``cache_file`` at a temp path to isolate persistence)."""
    with _packfit_lock:
        _packfit_state.clear()
        _packfit_dirty.clear()
