"""Lane-major MaxSum: factors on the minor axis.

Port of ``pydcop_tpu/ops/maxsum_lane.py``.  The host half is copied
(``LaneBucket``, ``LaneGraph``, ``PackLayout``, :func:`pack_graphs`,
:func:`converged_per_graph`, :func:`to_lane_graph`: numpy, the arrays
equal to the reference's); the device half is torch on a placed
``device.TorchLaneGraph`` (:func:`device.to_lane_device_graph`).

Layout (one bucket of arity ``a``, F factors, padded domain D):
messages ``[D, a, F]``, costs ``[D, ..., D, F]``, ``var_ids`` ``[a,
F]``, variable costs/valid/beliefs/sums ``[D, V+1]``.

Every float operation keeps the reference's order and is flushed to
zero, as XLA:CPU flushes the reference's (``ops/flush.py``):

- factor->variable: ``(costs + m0) + m1 + ...``, the min over the other
  axes, minus the own message; arity 2 goes to the lane entry of
  ``csrc/binary_factor_update.cu`` on the card
  (``ops.binary_factor.binary_factor_update_lane``);
- the belief sum: the reference's chained scatters are one running sum
  per variable over its edges in position-major order
  (``ops/lane_sum.py``, ``csrc/lane_sum.cu`` on the card), written as
  one row table of beliefs and sums; the values selected after a run
  and after each traced cycle come from the same walk started at
  ``var_costs`` (where the reference keeps no sums, XLA scatters into
  the costs);
- variable->factor: belief minus own message, the mean over the valid
  slots summed over the domain axis left to right (in windows of 32
  above 32 slots, XLA's tree rewrite), then damping as
  ``ops.var_update.damp`` (XLA gives the reference's ``damping * o +
  (1 - damping) * n`` the edge layout's forms), the approx-match and
  SAME_COUNT suppression: per bucket one launch of each entry of
  ``csrc/lane_var_update.cu`` on the card (``ops/lane_var_update.py``,
  the factor side's epilogue and the variable side);
- the totals (the standalone constraint cost and the cost trace's)
  go through ``window_sum.window_total`` (one launch on the card) over
  an edge-major copy of each table and its ids, made once per call or
  traced run, in the order of ``window_sum.gather_stages``' sites
  ``lane`` and ``lane_trace`` (probed on the jitted reference: the lane
  gathers vectorise other counts than the edge layout's).

The reference's ``while_loop`` becomes a host loop of supersteps that
reads ``stable`` once a cycle only when the run may stop early; with a
fixed cycle count it reads nothing until the end.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.device import TorchLaneGraph
from pydcop_tpu_torch.engine.compile import (
    BIG,
    CompiledFactorGraph,
    FactorBucket,
)
from pydcop_tpu_torch.ops.binary_factor import binary_factor_update_lane
from pydcop_tpu_torch.ops.flush import ftz
from pydcop_tpu_torch.ops.lane_sum import (
    lane_beliefs,
    lane_sum_table,
    padded_table,
    table_halves,
)
from pydcop_tpu_torch.ops.lane_var_update import (
    lane_send_update,
    lane_v2f_update,
    var_messages,
)
from pydcop_tpu_torch.ops.window_sum import (
    Gather,
    Plain,
    folded_sum,
    gather_stages,
    window_total,
)

Msgs = Tuple[torch.Tensor, ...]  # one [D, arity, F] tensor per bucket


# ------------------------------------------------------------------ #
# Host half (numpy), copied from the reference.


class LaneBucket(NamedTuple):
    """All factors of one arity, lane-major."""

    costs: np.ndarray    # [D]*arity + [F]
    var_ids: np.ndarray  # [arity, F] int32 (sentinel V on padding)

    @property
    def arity(self) -> int:
        return self.var_ids.shape[0]

    @property
    def n_factors(self) -> int:
        return self.var_ids.shape[1]


class LaneGraph(NamedTuple):
    """Lane-major twin of CompiledFactorGraph (scatter aggregation
    only — the sort-based strategies are edge-major concepts)."""

    var_costs: np.ndarray   # [Dmax, V+1]
    var_valid: np.ndarray   # [Dmax, V+1]
    buckets: Tuple[LaneBucket, ...]

    @property
    def n_vars(self) -> int:
        return self.var_costs.shape[1] - 1

    @property
    def dmax(self) -> int:
        return self.var_costs.shape[0]


class PackLayout(NamedTuple):
    """Where each member of a lane-packed union landed.

    Lane packing turns N *different*-structure problems into ONE
    disjoint-union factor graph: variables concatenate (one shared
    sentinel at the end), and each arity's factors concatenate on the
    lane (F) axis.  Because the union is a disjoint union, message
    passing decomposes exactly — no member's messages can reach
    another member's variables — so per-member results equal solo
    solves while the device sees one dense dispatch with NO
    per-member shape padding (the only mask waste is the shared
    domain rung)."""

    # Per member: (start, n_vars) into the union's variable rows.
    var_slices: Tuple[Tuple[int, int], ...]
    # Per member: ((bucket_index, start, n_rows), ...) into the
    # union's buckets — only arities the member actually has.
    row_slices: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    # Union bucket arity order (sorted ascending).
    arities: Tuple[int, ...]


def pack_graphs(graphs, d_env: Optional[int] = None
                ) -> Tuple[CompiledFactorGraph, PackLayout]:
    """Disjoint-union pack: concatenate compiled graphs into one
    edge-major CompiledFactorGraph (host numpy), domains mask-padded
    to the shared ``d_env`` (default: the group's max) with the
    compiler's own discipline (``BIG`` cost, ``var_valid=False``).

    Members may have entirely different variable counts, factor
    counts and arity sets.  Each member's rows keep their relative
    order inside the union buckets.  The union keeps a single sentinel
    row (index ``sum(v_i)``); members' own compile-time sentinel
    references are re-pointed at it.  Aggregation arrays are dropped
    (scatter path).  Use :func:`to_lane_graph` on the result to run
    lane-major, and :func:`converged_per_graph` to recover per-member
    convergence."""
    if not graphs:
        raise ValueError("pack_graphs needs at least one graph")
    if d_env is None:
        d_env = max(g.dmax for g in graphs)
    if d_env < max(g.dmax for g in graphs):
        raise ValueError(
            f"d_env={d_env} below the group's max domain "
            f"{max(g.dmax for g in graphs)}")
    v_total = sum(g.n_vars for g in graphs)
    dtype = graphs[0].var_costs.dtype
    var_costs = np.full((v_total + 1, d_env), BIG, dtype=dtype)
    var_valid = np.zeros((v_total + 1, d_env), dtype=bool)
    var_slices = []
    offset = 0
    for g in graphs:
        v, d = g.n_vars, g.dmax
        var_costs[offset:offset + v, :d] = np.asarray(g.var_costs)[:v]
        var_valid[offset:offset + v, :d] = np.asarray(g.var_valid)[:v]
        var_slices.append((offset, v))
        offset += v

    arities = sorted({b.arity for g in graphs for b in g.buckets})
    bucket_index = {a: i for i, a in enumerate(arities)}
    costs_parts = {a: [] for a in arities}
    ids_parts = {a: [] for a in arities}
    row_cursor = {a: 0 for a in arities}
    row_slices = []
    for g, (start, _v) in zip(graphs, var_slices):
        v = g.n_vars
        member_rows = []
        for b in g.buckets:
            a, n_rows, d = b.arity, b.n_factors, g.dmax
            block = np.full((n_rows,) + (d_env,) * a, BIG,
                            dtype=b.costs.dtype)
            block[(slice(None),) + (slice(0, d),) * a] = \
                np.asarray(b.costs)
            ids = np.asarray(b.var_ids).astype(np.int32).copy()
            # Member-local indices -> union indices; the member's own
            # sentinel (v) re-points at the union sentinel (v_total).
            sent = ids == v
            ids = ids + start
            ids[sent] = v_total
            costs_parts[a].append(block)
            ids_parts[a].append(ids)
            member_rows.append(
                (bucket_index[a], row_cursor[a], n_rows))
            row_cursor[a] += n_rows
        row_slices.append(tuple(member_rows))

    buckets = tuple(
        FactorBucket(
            costs=np.concatenate(costs_parts[a], axis=0),
            var_ids=np.concatenate(ids_parts[a], axis=0),
        )
        for a in arities
    )
    union = CompiledFactorGraph(
        var_costs=var_costs, var_valid=var_valid, buckets=buckets,
    )
    layout = PackLayout(
        var_slices=tuple(var_slices),
        row_slices=tuple(row_slices),
        arities=tuple(arities),
    )
    return union, layout


def converged_per_graph(v2f_count, f2v_count,
                        layout: PackLayout) -> Tuple[bool, ...]:
    """Per-member convergence verdicts from a packed run's final
    send-suppression counters: ``count >= 2`` on every edge of a member
    (both directions) is exactly that member's slice of the global
    ``stable`` conjunction.  Counter arrays are the lane-major ``[arity,
    F]`` per-bucket counters (numpy; the F axis is sliced)."""
    verdicts = []
    for member_rows in layout.row_slices:
        ok = True
        for bi, start, n_rows in member_rows:
            for counts in (v2f_count[bi], f2v_count[bi]):
                rows = np.asarray(counts)[:, start:start + n_rows]
                ok = ok and bool((rows >= 2).all())
        verdicts.append(ok)
    return tuple(verdicts)


def to_lane_graph(graph: CompiledFactorGraph) -> LaneGraph:
    """One-time compile-side relayout (host numpy; the superstep never
    transposes)."""
    return LaneGraph(
        var_costs=np.ascontiguousarray(np.asarray(graph.var_costs).T),
        var_valid=np.ascontiguousarray(np.asarray(graph.var_valid).T),
        buckets=tuple(
            LaneBucket(
                costs=np.ascontiguousarray(
                    np.moveaxis(np.asarray(b.costs), 0, -1)),
                var_ids=np.ascontiguousarray(np.asarray(b.var_ids).T),
            )
            for b in graph.buckets
        ),
    )


# ------------------------------------------------------------------ #
# Device half (torch).


class LaneState(NamedTuple):
    v2f: Msgs              # last SENT variable -> factor messages
    f2v: Msgs              # last SENT factor -> variable messages
    v2f_count: Msgs        # [arity, F] int8 consecutive-same counts
    f2v_count: Msgs
    stable: torch.Tensor   # 0-d bool
    cycle: torch.Tensor    # 0-d int32


def init_state(graph: TorchLaneGraph) -> LaneState:
    """Zero messages and counts, one tensor per field and bucket."""
    d = graph.var_costs.shape[0]
    dev = graph.var_costs.device
    dtype = graph.var_costs.dtype

    def zeros():
        return tuple(torch.zeros((d,) + tuple(b.var_ids.shape),
                                 dtype=dtype, device=dev)
                     for b in graph.buckets)

    def counts():
        return tuple(torch.zeros(tuple(b.var_ids.shape), dtype=torch.int8,
                                 device=dev)
                     for b in graph.buckets)

    return LaneState(
        v2f=zeros(), f2v=zeros(), v2f_count=counts(), f2v_count=counts(),
        # Made on the device (no host copy, so no host sync: a
        # launch that builds its state queues it with the rest).
        stable=torch.zeros((), dtype=torch.bool, device=dev),
        cycle=torch.zeros((), dtype=torch.int32, device=dev),
    )


def factor_to_var(graph: TorchLaneGraph, v2f: Msgs) -> Msgs:
    """All factor->variable messages: per bucket the min over the other
    leading domain axes of ``costs + sum_q bcast(m_q)``, minus the own
    message (arity 2: the kernel's lane entry on the card)."""
    out = []
    for bucket, msgs in zip(graph.buckets, v2f):
        d, arity, f = msgs.shape
        if arity == 2:
            out.append(binary_factor_update_lane(bucket.costs, msgs))
            continue
        total = bucket.costs                     # [D, ..., D, F]
        for q in range(arity):
            shape = [1] * arity + [f]
            shape[q] = d
            total = ftz(total + msgs[:, q].reshape(shape))
        outs_p = []
        for p in range(arity):
            axes = tuple(i for i in range(arity) if i != p)
            reduced = torch.amin(total, dim=axes) if axes else total
            outs_p.append(ftz(reduced - msgs[:, p]))
        out.append(torch.stack(outs_p, dim=1))   # [D, a, F]
    return tuple(out)


def aggregate_table(graph: TorchLaneGraph, f2v: Msgs) -> torch.Tensor:
    """Each variable's incoming messages summed in the reference's
    scatter order (``ops/lane_sum.py``), as one row table [V+1, 2P]
    (row v: its beliefs, then its sums, each padded to
    ``lane_sum.row_floats(D)``): one call of
    ``csrc/lane_sum.cu`` on the card, the table the variable side's
    kernel gathers one row an edge of."""
    if not graph.buckets:
        return padded_table(graph.var_costs,
                            torch.zeros_like(graph.var_costs))
    return lane_sum_table(f2v, graph.agg_perm, graph.agg_offsets,
                          graph.agg_buckets, graph.var_costs,
                          graph.agg_heavy)


def aggregate_beliefs(graph: TorchLaneGraph, f2v: Msgs
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(beliefs, sums) [D, V+1]: the two halves of
    :func:`aggregate_table`, as views of it."""
    return table_halves(aggregate_table(graph, f2v),
                        graph.var_costs.shape[0])


def selection_beliefs(graph: TorchLaneGraph, f2v: Msgs) -> torch.Tensor:
    """The beliefs [D, V+1] the reference selects values from after a
    run and after each traced cycle, where it keeps no sums: XLA then
    scatters the messages into ``var_costs`` directly, so each
    variable's running sum starts from its costs
    (``ops/lane_sum.py::lane_beliefs``, the same kernel)."""
    if not graph.buckets:
        return graph.var_costs
    return lane_beliefs(f2v, graph.agg_perm, graph.agg_offsets,
                        graph.agg_buckets, graph.var_costs, graph.agg_heavy)


def var_to_factor(graph: TorchLaneGraph, f2v: Msgs, beliefs: torch.Tensor,
                  sums: torch.Tensor) -> Msgs:
    """Belief minus own contribution, mean-normalized over the valid
    domain slots (domain axis = axis 0), BIG on invalid slots: the plain
    candidates of ``ops/lane_var_update.py``'s variable side."""
    return tuple(var_messages(beliefs, sums, msgs, bucket.var_ids,
                              graph.var_valid)
                 for bucket, msgs in zip(graph.buckets, f2v))


def select_values(graph: TorchLaneGraph,
                  beliefs: torch.Tensor) -> torch.Tensor:
    """Per-variable argmin of belief over valid slots ([V] int32), ties
    to the first index."""
    masked = torch.where(graph.var_valid, beliefs, torch.inf)
    return torch.argmin(masked[:, :-1], dim=0).to(torch.int32)


def superstep(state: LaneState, graph: TorchLaneGraph, *, damping: float,
              damp_vars: bool, damp_factors: bool,
              stability: float) -> LaneState:
    """One synchronous cycle: both sides fire from last cycle's mail,
    with damping, SAME_COUNT suppression and the ``stable`` flag
    computed on the device.  Per bucket one launch of each
    ``ops/lane_var_update.py`` entry (the factor side's epilogue, the
    variable side) on the card, and one call of ``lane_sum`` for the
    belief table; ``stable`` starts as ``cycle != 0`` and each entry
    ANDs its buckets' all-match into it."""
    f2v_cand = factor_to_var(graph, state.v2f)
    table = aggregate_table(graph, state.f2v)
    stable = state.cycle != 0
    f2v_damping = damping if damp_factors else 0.0
    v2f_damping = damping if damp_vars else 0.0
    f2v_new, f2v_count, v2f_new, v2f_count = [], [], [], []
    for i, bucket in enumerate(graph.buckets):
        sent, cnt = lane_send_update(
            f2v_cand[i], state.f2v[i], state.f2v_count[i], bucket.var_ids,
            graph.var_valid, state.cycle, stable, damping=f2v_damping,
            stability=stability, var_ids32=bucket.var_ids32,
            edge_valid=bucket.edge_valid)
        f2v_new.append(sent)
        f2v_count.append(cnt)
        sent, cnt = lane_v2f_update(
            table, state.f2v[i], state.v2f[i], state.v2f_count[i],
            bucket.var_ids, graph.var_valid, state.cycle, stable,
            damping=v2f_damping, stability=stability,
            var_ids32=bucket.var_ids32, edge_valid=bucket.edge_valid)
        v2f_new.append(sent)
        v2f_count.append(cnt)

    return LaneState(
        v2f=tuple(v2f_new), f2v=tuple(f2v_new),
        v2f_count=tuple(v2f_count), f2v_count=tuple(f2v_count),
        stable=stable, cycle=state.cycle + 1,
    )


def constraint_operands(graph: TorchLaneGraph, site: str = "lane"):
    """Each bucket's cost gather for ``window_sum.window_total``, read
    from an edge-major copy of its table ([F, D^a], made here) and of
    its ids ([F, a] int32), with the head of its sum at ``site``
    (``"lane"``, or ``"lane_trace"`` inside the traced run)."""
    d = graph.var_costs.shape[0]
    shapes = [tuple(b.var_ids.shape) for b in graph.buckets]
    widest = max((a for a, f in shapes if f > 1), default=0)
    ops = []
    for k, bucket in enumerate(graph.buckets):
        arity, f = shapes[k]
        head = gather_stages(site, arity, d, f, widest,
                             near=shapes[:k] + shapes[k + 1:])
        ops.append(Gather(bucket.costs.reshape(-1, f).t().contiguous(),
                          bucket.var_ids32.t().contiguous(), f, d, head))
    return ops


def variable_operand(var_base_costs: torch.Tensor, site: str = "lane",
                     folded: bool = False):
    """The gather of ``var_base_costs[v, values[v]]`` ([V, D], the
    reference's edge-major convention) for ``window_total``;
    ``folded`` as in ``ops.maxsum.variable_operand`` (at D = 1 the
    traced run's sum is XLA's compile-time one)."""
    v, d = var_base_costs.shape
    if folded and d == 1:
        return Plain(folded_sum(var_base_costs))
    return Gather(var_base_costs.contiguous(), None, v, d,
                  gather_stages(site, 0, d, v))


def assignment_constraint_cost(graph: TorchLaneGraph, values: torch.Tensor,
                               site: str = "lane") -> torch.Tensor:
    """Total factor-table cost of an assignment ([V] value indices);
    padding rows read value 0 of the sentinel.  One ``window_total``."""
    return window_total(constraint_operands(graph, site), values)


def _reject_prune(prune: bool):
    """Branch-and-bound pruning is an edge-major kernel; the lane
    layout refuses it, as the reference does."""
    if prune:
        raise NotImplementedError(
            "prune=True is edge-major only; run with layout='edge'")


def _cycles(graph, state, n_cycles, stop_on_convergence, kw):
    """Yield the state after each of up to ``n_cycles`` supersteps,
    stopping at the fixpoint when ``stop_on_convergence`` (the only
    host read: ``stable``, once a cycle)."""
    for _ in range(n_cycles):
        if stop_on_convergence and bool(state.stable):
            break
        state = superstep(state, graph, **kw)
        yield state


def run_maxsum(graph: TorchLaneGraph, max_cycles: int, *,
               damping: float = 0.5, damp_vars: bool = True,
               damp_factors: bool = True, stability: float = 0.1,
               stop_on_convergence: bool = True, prune: bool = False,
               ) -> Tuple[LaneState, torch.Tensor]:
    """Full lane-major MaxSum run from zero messages."""
    return run_maxsum_from(
        graph, init_state(graph), max_cycles, damping=damping,
        damp_vars=damp_vars, damp_factors=damp_factors,
        stability=stability, stop_on_convergence=stop_on_convergence,
        prune=prune)


def run_maxsum_from(graph: TorchLaneGraph, state: LaneState,
                    extra_cycles: int, *, damping: float = 0.5,
                    damp_vars: bool = True, damp_factors: bool = True,
                    stability: float = 0.1,
                    stop_on_convergence: bool = True, prune: bool = False,
                    ) -> Tuple[LaneState, torch.Tensor]:
    """Up to ``extra_cycles`` more supersteps from ``state`` (the
    reference's ``while cycle < limit and not stable``); returns (final
    state, selected values [V])."""
    _reject_prune(prune)
    kw = dict(damping=damping, damp_vars=damp_vars,
              damp_factors=damp_factors, stability=stability)
    for state in _cycles(graph, state, extra_cycles, stop_on_convergence,
                         kw):
        pass
    return state, select_values(graph, selection_beliefs(graph, state.f2v))


def run_maxsum_trace(graph: TorchLaneGraph, max_cycles: int, *,
                     damping: float = 0.5, damp_vars: bool = True,
                     damp_factors: bool = True, stability: float = 0.1,
                     var_base_costs: Optional[torch.Tensor] = None,
                     stop_on_convergence: bool = True, prune: bool = False,
                     ) -> Tuple[LaneState, torch.Tensor, torch.Tensor]:
    """Like :func:`run_maxsum`, also writing the cost of the selected
    assignment after every cycle into a [max_cycles] tensor on the
    device (no host sync of its own); an early stop leaves the tail
    holding the final cost.  ``var_base_costs`` is [V, D] edge-major
    (the reference's convention)."""
    _reject_prune(prune)
    ops = constraint_operands(graph, "lane_trace")
    if var_base_costs is not None:
        ops.append(variable_operand(var_base_costs, "lane_trace",
                                    folded=True))
    kw = dict(damping=damping, damp_vars=damp_vars,
              damp_factors=damp_factors, stability=stability)
    costs = torch.zeros((max_cycles,), dtype=graph.var_costs.dtype,
                        device=graph.var_costs.device)
    last = torch.zeros((), dtype=costs.dtype, device=costs.device)
    state = init_state(graph)
    n = 0
    for state in _cycles(graph, state, max_cycles, stop_on_convergence,
                         kw):
        values = select_values(graph, selection_beliefs(graph, state.f2v))
        last = window_total(ops, values, out=costs[n])
        n += 1
    costs[n:] = last
    return (state, select_values(graph, selection_beliefs(graph, state.f2v)),
            costs)
