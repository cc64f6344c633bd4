"""MaxSum message updates on torch tensors: one BSP superstep.

Port of the dense path of ``pydcop_tpu/ops/maxsum.py``, function for
function, so each can be held to its JAX counterpart on the same graph
and state (``tests/test_torch_maxsum_ops.py``):

- factor->variable: per arity bucket, ``total = costs + sum_q bcast(m_q)``
  then, for each position p, ``min`` over the other axes minus ``m_p``.
  Arity 2 goes to ``ops/binary_factor.py`` — the hand-written CUDA
  kernel on the card, its plain version on the CPU — or, with
  branch-and-bound pruning and while every factor's survivors fit the
  static budget, to :func:`_pruned_binary_update` (plain torch);
- variable->factor: per-variable sum of incoming messages in a fixed
  order, by the graph's aggregation strategy (``scatter``/``sorted``:
  ``ops/segment_sum.py``, a hand-written CUDA kernel on the card, so
  the sums are the CPU's and the reference's bit for bit; ``ell``:
  ``ops/ell.py``; ``boundary``: a prefix sum), minus the own message,
  mean-normalised over valid domain slots, damped;
- value selection: first-index argmin of own costs + message sums over
  valid slots.

Messages live in bucket space (``[F, arity, D]`` per bucket).  All
kernels minimize; ``objective=max`` problems are negated at compile
time.  Every element-wise expression keeps the reference's operation
order, because damping and mean-normalisation accrete mantissa bits
cycle after cycle and a reassociated sum drifts the trajectory; where
XLA:CPU computes another form than the one written in the reference
(damping as ``(o + n) * 0.5`` or one fused multiply-add, the domain
mean vectorised after a fused fold, every subnormal result flushed to
zero), the port computes that form.  The per-edge update of both sides
(damping, flush, approx-match, counts, ``stable``) is
``ops/var_update.py``: a hand-written CUDA kernel on the card, its plain
version on the CPU.

The reference runs the solve loop on the device (``lax.while_loop``);
here it is a host loop of supersteps that reads ``stable`` once per
cycle when it may stop early, and never when it runs a fixed count.
With pruning, the reference's nested dense/fast phase loops come down
to one decision per cycle (the pruned step when :func:`prune_fits`
holds for the messages about to be consumed), read together with
``stable`` in one host transfer per cycle.  ``cycles`` and
``converged`` equal the reference's on the same graph.
:func:`run_maxsum_trace` also writes each cycle's assignment cost into
a device tensor, with no host sync of its own.
"""

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from pydcop_tpu_torch.device import TorchFactorGraph
from pydcop_tpu_torch.engine.compile import PRUNE_MIN_DOMAIN, prune_width
from pydcop_tpu_torch.ops.binary_factor import binary_factor_update
from pydcop_tpu_torch.ops.ell import gather_reduce
from pydcop_tpu_torch.ops.flush import ftz
from pydcop_tpu_torch.ops.segment_sum import segment_sum
from pydcop_tpu_torch.ops.var_update import (
    send_update,
    v2f_update,
    var_messages,
)

Msgs = Tuple[torch.Tensor, ...]  # one [F, arity, D] tensor per bucket


class MaxSumState(NamedTuple):
    v2f: Msgs              # last SENT variable -> factor messages
    f2v: Msgs              # last SENT factor -> variable messages
    v2f_count: Msgs        # [F, arity] int8 consecutive-same send counts
    f2v_count: Msgs
    stable: torch.Tensor   # 0-d bool: all messages approx-matched
    cycle: torch.Tensor    # 0-d int32


def init_state(graph: TorchFactorGraph) -> MaxSumState:
    """Zero messages and counts, one tensor per field and bucket
    (int8 counts: they saturate at ``var_update.SAME_COUNT`` + 1)."""
    d = graph.var_costs.shape[1]
    dev = graph.var_costs.device
    dtype = graph.var_costs.dtype

    def zeros():
        return tuple(
            torch.zeros(tuple(b.var_ids.shape) + (d,), dtype=dtype,
                        device=dev)
            for b in graph.buckets
        )

    def counts():
        return tuple(
            torch.zeros(tuple(b.var_ids.shape), dtype=torch.int8,
                        device=dev)
            for b in graph.buckets
        )

    return MaxSumState(
        v2f=zeros(),
        f2v=zeros(),
        v2f_count=counts(),
        f2v_count=counts(),
        stable=torch.tensor(False, device=dev),
        cycle=torch.tensor(0, dtype=torch.int32, device=dev),
    )


class PruneTable(NamedTuple):
    """Per-bucket branch-and-bound tables of the pruned binary-factor
    update (reference ``PruneTable``): per position p, the min and max
    of the cost table over the other position's VALID slots, each
    position's valid mask, the transposed table (direction 0 gathers
    rows by the other position's slot, so a transposed copy makes them
    contiguous; it doubles the table memory while pruning is on) and the
    static gather budget."""

    row_min: Tuple[torch.Tensor, torch.Tensor]  # per position p: [F, D]
    row_max: Tuple[torch.Tensor, torch.Tensor]
    valid: Tuple[torch.Tensor, torch.Tensor]    # [F, D] bool
    costs_t: torch.Tensor                       # [F, D, D] transposed
    width: int                                  # static gather budget


def prune_tables(graph: TorchFactorGraph
                 ) -> Tuple[Optional[PruneTable], ...]:
    """Branch-and-bound tables, one entry per bucket (None: the bucket
    stays on the dense path — not binary, empty, or D below
    ``PRUNE_MIN_DOMAIN``).  Loop-invariant: built once per run."""
    out = []
    d = graph.var_costs.shape[1]
    for bucket in graph.buckets:
        if (bucket.var_ids.shape[1] != 2 or d < PRUNE_MIN_DOMAIN
                or bucket.var_ids.shape[0] == 0):
            out.append(None)
            continue
        valid0 = graph.var_valid[bucket.var_ids[:, 0]]   # [F, D]
        valid1 = graph.var_valid[bucket.var_ids[:, 1]]
        costs = bucket.costs                             # [F, D, D]
        m0 = valid0[:, :, None]
        m1 = valid1[:, None, :]
        out.append(PruneTable(
            row_min=(
                torch.amin(torch.where(m1, costs, torch.inf), dim=2),
                torch.amin(torch.where(m0, costs, torch.inf), dim=1),
            ),
            row_max=(
                torch.amax(torch.where(m1, costs, -torch.inf), dim=2),
                torch.amax(torch.where(m0, costs, -torch.inf), dim=1),
            ),
            valid=(valid0, valid1),
            costs_t=costs.transpose(1, 2).contiguous(),
            width=prune_width(d),
        ))
    return tuple(out)


# Relative slack of the survivor test (reference PRUNE_SLACK): entries
# whose margin is inside the rounding noise of the bounds survive.
PRUNE_SLACK = 2.5e-5


def _survivors(msgs: torch.Tensor, pt: PruneTable, p: int
               ) -> torch.Tensor:
    """[F, D] bool: reduction rows of direction ``p`` that can still
    attain the min.  Row e is dominated when its lower bound
    ``m_q[e] + row_min[e]`` exceeds the factor's upper bound
    ``min_e(m_q[e] + row_max[e])`` by more than the slack."""
    mq = msgs[:, 1 - p]
    vq = pt.valid[1 - p]
    lb = ftz(mq + pt.row_min[p])
    ub = torch.amin(torch.where(vq, ftz(mq + pt.row_max[p]), torch.inf),
                    dim=1, keepdim=True)
    tau = ftz(PRUNE_SLACK * ftz(1.0 + torch.abs(ub)))
    return vq & (lb <= ftz(ub + tau))


def prune_fits(v2f: Msgs,
               prune: Tuple[Optional[PruneTable], ...]) -> torch.Tensor:
    """0-d bool tensor: every prunable bucket's survivor count fits the
    static budget in both directions for these messages — the phase
    predicate of the pruned run."""
    fits = torch.ones((), dtype=torch.bool, device=v2f[0].device)
    for msgs, pt in zip(v2f, prune):
        if pt is None:
            continue
        for p in range(2):
            n = torch.amax(torch.sum(_survivors(msgs, pt, p), dim=1,
                                     dtype=torch.int32))
            fits = fits & (n <= pt.width)
    return fits


def _pruned_binary_update(bucket, msgs: torch.Tensor,
                          pt: PruneTable) -> torch.Tensor:
    """Branch-and-bound f2v update of one binary bucket ([F, 2, D]).

    Precondition: ``prune_fits`` holds for ``msgs`` (the run loop takes
    this step only then).  The survivors are found sort-free: the j-th
    survivor index comes from the monotone prefix counts by an unrolled
    binary search, all K targets at once; both directions then gather
    [K, D] rows (direction 0 from the transposed table) and min-plus
    reduce over K, in the dense path's add order ``(c + m0) + m1``,
    min, minus the own message — so the values equal the dense
    update's.  Slots past the last survivor repeat a row that is a
    survivor or dominated, which leaves the min unchanged."""
    costs = bucket.costs
    m0, m1 = msgs[:, 0], msgs[:, 1]
    k = pt.width
    f, d = costs.shape[0], costs.shape[1]
    dev = costs.device
    rows = torch.arange(f, device=dev)[:, None]
    target = torch.arange(1, k + 1, dtype=torch.int32, device=dev)[None, :]
    top = 1
    while top * 2 <= d:
        top <<= 1
    outs = []
    for p in range(2):
        s = _survivors(msgs, pt, p)
        cum = torch.cumsum(s.to(torch.int32), dim=1, dtype=torch.int32)
        idx = torch.zeros((f, k), dtype=torch.int32, device=dev)
        bit = top
        while bit:
            nxt = idx + bit
            probe = torch.gather(
                cum, 1, (torch.clamp(nxt, max=d) - 1).to(torch.int64))
            idx = torch.where((nxt <= d) & (probe < target), nxt, idx)
            bit >>= 1
        idx = torch.clamp(idx, max=d - 1).to(torch.int64)
        if p == 0:
            c_g = pt.costs_t[rows, idx]                     # [F, K, D]
            m1_g = torch.gather(m1, 1, idx)
            total = ftz(ftz(c_g + m0[:, None, :]) + m1_g[:, :, None])
            outs.append(ftz(torch.amin(total, dim=1) - m0))
        else:
            c_g = costs[rows, idx]                          # [F, K, D]
            m0_g = torch.gather(m0, 1, idx)
            total = ftz(ftz(c_g + m0_g[:, :, None]) + m1[:, None, :])
            outs.append(ftz(torch.amin(total, dim=1) - m1))
    return torch.stack(outs, dim=1)


def factor_to_var(graph: TorchFactorGraph, v2f: Msgs,
                  prune: Optional[Tuple[Optional[PruneTable], ...]] = None
                  ) -> Msgs:
    """All factor->variable messages for one superstep.  ``prune``
    (from :func:`prune_tables`) sends the prunable binary buckets
    through the branch-and-bound update — the same values.  Every add
    and subtract is flushed to zero, as the reference's are."""
    out = []
    for bi, (bucket, msgs) in enumerate(zip(graph.buckets, v2f)):
        if prune is not None and prune[bi] is not None:
            out.append(_pruned_binary_update(bucket, msgs, prune[bi]))
            continue
        f, arity, d = msgs.shape
        if arity == 2:
            out.append(binary_factor_update(bucket.costs, msgs))
            continue
        total = bucket.costs  # [F, D, ..., D]
        for q in range(arity):
            shape = [f] + [1] * arity
            shape[q + 1] = d
            total = ftz(total + msgs[:, q].reshape(shape))
        outs_p = []
        for p in range(arity):
            axes = tuple(i + 1 for i in range(arity) if i != p)
            reduced = torch.amin(total, dim=axes) if axes else total
            outs_p.append(ftz(reduced - msgs[:, p]))
        out.append(torch.stack(outs_p, dim=1))  # [F, arity, D]
    return tuple(out)


def aggregate_beliefs(graph: TorchFactorGraph, f2v: Msgs
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum incoming factor messages per variable in the order the
    reference's jitted superstep sums them under the graph's strategy:

    - ``scatter``: edge order within a bucket; across buckets XLA folds
      the per-bucket segment_sums so that the first bucket starts from
      zero, and each later bucket is either summed from zero on its own
      and added, or added into the running sums, as
      ``ops.segment_sum.separate_buckets`` reads off the bucket sizes
      (odd buckets on their own, unless XLA merged them); a bucket of
      one edge becomes a one-row update that can move
      (``ops.segment_sum.positional_fold``, placed as the graph's
      ``agg_order`` and ``agg_sep``);
    - ``sorted``: one running sum per variable over every bucket's
      edges in CSR order, from zero;
    - ``ell``: the [V+1, K] lists' gather and K-way sum
      (``ops/ell.py``); the sentinel row's list is all dummy slots, so
      its sums are zero (``var_valid`` masks that row out of every
      message);
    - ``boundary`` (experiment-only, as in the reference): a prefix sum
      over the edges in CSR order and boundary differences.  Its
      cumsum adds in another order than XLA's, and cannot flush inside
      the scan, so it agrees with the reference only within a
      tolerance (the differences and the belief add are flushed).

    Returns (beliefs [V+1, D] = own costs + sums, sums).  ``scatter``
    and ``sorted`` give the same bits on the card and on the CPU: the
    card runs ``csrc/segment_sum.cu``, whose order is fixed and which
    reads each bucket's messages where they lie; ``ell`` is ordered
    elementwise adds on both."""
    if not graph.buckets:
        # Constraint-free DCOP: no incoming messages at all.
        return graph.var_costs, torch.zeros_like(graph.var_costs)
    strategy = graph.agg_strategy
    if strategy in ("ell", "boundary"):
        d = graph.var_costs.shape[1]
        flats = [m.reshape(-1, d) for m in f2v]
        flat = flats[0] if len(flats) == 1 else torch.cat(flats)
        if strategy == "ell":
            sums = gather_reduce(graph.agg_ell, flat,
                                 n_buckets=len(graph.buckets))
        else:
            # The prefix sum runs along the last axis ([D, E]): a scan
            # over the first axis of [E, D] is serial over E on the card.
            in_order = flat[graph.agg_perm.to(torch.int64)].t().contiguous()
            cum = torch.cumsum(in_order, dim=1)
            cz = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1)
            bounds = graph.agg_offsets.to(torch.int64)
            sums = ftz(cz[:, bounds[1:]] - cz[:, bounds[:-1]]).t().contiguous()
        return ftz(graph.var_costs + sums), sums
    return segment_sum([f2v[b] for b in graph.agg_order], graph.agg_perm,
                       graph.agg_offsets, graph.agg_buckets,
                       graph.var_costs, graph.agg_tiles,
                       one_sum=strategy == "sorted", sep=graph.agg_sep)


def _sums_fused(graph: TorchFactorGraph) -> bool:
    """Whether the reference's jitted superstep computes this graph's
    belief sums as an add it fuses into their consumers: the scatter
    aggregation over several buckets, the last bucket of its fold
    summed on its own (``graph.agg_sep``)."""
    n = len(graph.buckets)
    if graph.agg_strategy != "scatter" or n < 2:
        return False
    return bool(graph.agg_sep >> (n - 1) & 1)


def var_to_factor(graph: TorchFactorGraph, f2v: Msgs,
                  beliefs: torch.Tensor, sums: torch.Tensor) -> Msgs:
    """All variable->factor candidates: belief minus own contribution,
    mean-normalized over valid slots (reference maxsum.py:670-674),
    each operation flushed (``ops.var_update.var_messages``).  The
    superstep computes them inside :func:`ops.var_update.v2f_update`."""
    fused = _sums_fused(graph)
    return tuple(var_messages(beliefs, sums, msgs, bucket.var_ids,
                              graph.var_valid, fused)
                 for bucket, msgs in zip(graph.buckets, f2v))


def select_values(graph: TorchFactorGraph,
                  beliefs: torch.Tensor) -> torch.Tensor:
    """Per-variable argmin of belief over valid slots ([V] int32); ties
    go to the first index."""
    masked = torch.where(graph.var_valid, beliefs, torch.inf)
    return torch.argmin(masked[:-1], dim=1).to(torch.int32)


def superstep(state: MaxSumState, graph: TorchFactorGraph, *,
              damping: float, damp_vars: bool, damp_factors: bool,
              stability: float, prune=None) -> MaxSumState:
    """One synchronous MaxSum cycle: in cycle k BOTH sides fire from
    the messages sent in cycle k-1, with per-edge damping, every float
    operation flushed to zero and SAME_COUNT send-suppression.

    Per bucket the factor side's candidates go through
    :func:`ops.var_update.send_update` and the variable side is one
    :func:`ops.var_update.v2f_update` (one launch each on the card);
    both AND the bucket's all-match into ``stable``, which starts as
    ``cycle != 0`` (the reference's ``all_match & ~first``)."""
    stable = state.cycle != 0
    f2v_cand = factor_to_var(graph, state.v2f, prune=prune)
    # Variable side uses the factor messages from the PREVIOUS cycle.
    beliefs, sums = aggregate_beliefs(graph, state.f2v)
    fused = _sums_fused(graph)
    f_damping = damping if damp_factors and damping > 0 else 0.0
    v_damping = damping if damp_vars and damping > 0 else 0.0

    f2v_new, f2v_count = [], []
    v2f_new, v2f_count = [], []
    for i, bucket in enumerate(graph.buckets):
        sent, cnt = send_update(
            f2v_cand[i], state.f2v[i], state.f2v_count[i], bucket.var_ids,
            graph.var_valid, state.cycle, stable, damping=f_damping,
            stability=stability, var_ids32=bucket.var_ids32,
            edge_valid=bucket.edge_valid)
        f2v_new.append(sent)
        f2v_count.append(cnt)
        sent, cnt = v2f_update(
            beliefs, sums, state.f2v[i], state.v2f[i], state.v2f_count[i],
            bucket.var_ids, graph.var_valid, state.cycle, stable,
            damping=v_damping, stability=stability, fused=fused,
            var_ids32=bucket.var_ids32, edge_valid=bucket.edge_valid)
        v2f_new.append(sent)
        v2f_count.append(cnt)

    return MaxSumState(
        v2f=tuple(v2f_new),
        f2v=tuple(f2v_new),
        v2f_count=tuple(v2f_count),
        f2v_count=tuple(f2v_count),
        stable=stable,
        cycle=state.cycle + 1,
    )


def assignment_constraint_cost(graph: TorchFactorGraph,
                               values: torch.Tensor) -> torch.Tensor:
    """Total factor-table cost of an assignment ([V] value indices).
    Padding rows contribute 0; variable-side costs are not included."""
    vals = torch.cat(
        [values.to(torch.int64),
         torch.zeros((1,), dtype=torch.int64, device=values.device)]
    )
    total = torch.zeros((), dtype=graph.var_costs.dtype,
                        device=graph.var_costs.device)
    d = graph.var_costs.shape[1]
    for bucket in graph.buckets:
        f, arity = bucket.var_ids.shape
        idx = vals[bucket.var_ids]               # [F, arity]
        flat = torch.zeros((f,), dtype=torch.int64, device=idx.device)
        for p in range(arity):
            flat = flat * d + idx[:, p]
        table = bucket.costs.reshape(f, -1)
        total = total + torch.sum(
            torch.gather(table, 1, flat[:, None]))
    return total


def run_maxsum(graph: TorchFactorGraph, max_cycles: int, *,
               damping: float = 0.5, damp_vars: bool = True,
               damp_factors: bool = True, stability: float = 0.1,
               stop_on_convergence: bool = True,
               prune: bool = False,
               stats: Optional[Dict[str, int]] = None,
               ) -> Tuple[MaxSumState, torch.Tensor]:
    """Full MaxSum run from zero messages.

    Returns (final state, selected value indices [V])."""
    return run_maxsum_from(
        graph, init_state(graph), max_cycles,
        damping=damping, damp_vars=damp_vars,
        damp_factors=damp_factors, stability=stability,
        stop_on_convergence=stop_on_convergence, prune=prune, stats=stats,
    )


def _active_prune(graph: TorchFactorGraph, prune: bool
                  ) -> Optional[Tuple[Optional[PruneTable], ...]]:
    pt = prune_tables(graph) if prune else None
    if pt is not None and all(t is None for t in pt):
        return None
    return pt


def _cycles(graph: TorchFactorGraph, state: MaxSumState, n_cycles: int,
            pt, stop_on_convergence: bool, stats, **kw):
    """Yield the state after each of up to ``n_cycles`` supersteps,
    stopping at the fixpoint when ``stop_on_convergence``.  With prune
    tables ``pt``, a cycle takes the pruned step when ``prune_fits``
    holds for ``state.v2f``, the dense step otherwise; ``stable`` and
    that predicate come to the host together, once per cycle.  Without
    them, ``stable`` is read only when the run may stop early."""
    fast = 0
    for _ in range(n_cycles):
        use_fast = False
        if pt is not None:
            fits = prune_fits(state.v2f, pt)
            if stop_on_convergence:
                stable, use_fast = torch.stack(
                    [state.stable, fits]).tolist()
                if stable:
                    break
            else:
                use_fast = bool(fits)
        elif stop_on_convergence and bool(state.stable):
            break
        state = superstep(state, graph, prune=pt if use_fast else None,
                          **kw)
        fast += use_fast
        yield state
    if stats is not None:
        stats["prune_fast_cycles"] = fast


def run_maxsum_from(graph: TorchFactorGraph, state: MaxSumState,
                    extra_cycles: int, *,
                    damping: float = 0.5, damp_vars: bool = True,
                    damp_factors: bool = True, stability: float = 0.1,
                    stop_on_convergence: bool = True,
                    prune: bool = False,
                    stats: Optional[Dict[str, int]] = None,
                    ) -> Tuple[MaxSumState, torch.Tensor]:
    """Run up to ``extra_cycles`` more supersteps from ``state``,
    stopping early at the fixpoint when ``stop_on_convergence`` — the
    reference's ``while cycle < limit and not stable`` loop.

    ``prune=True`` enables branch-and-bound pruning of the binary
    factor->variable reductions (:func:`prune_tables`): each cycle takes
    the pruned step when every factor's survivors fit the budget, the
    dense step otherwise.  Both give the same values, so pruning never
    changes the result.  ``stats``, when a dict, receives
    ``prune_fast_cycles``: the cycles that took the pruned step."""
    for state in _cycles(
            graph, state, extra_cycles, _active_prune(graph, prune),
            stop_on_convergence, stats, damping=damping,
            damp_vars=damp_vars, damp_factors=damp_factors,
            stability=stability):
        pass
    beliefs, _ = aggregate_beliefs(graph, state.f2v)
    values = select_values(graph, beliefs)
    return state, values


def run_maxsum_trace(graph: TorchFactorGraph, max_cycles: int, *,
                     damping: float = 0.5, damp_vars: bool = True,
                     damp_factors: bool = True, stability: float = 0.1,
                     var_base_costs: Optional[torch.Tensor] = None,
                     stop_on_convergence: bool = True,
                     prune: bool = False,
                     stats: Optional[Dict[str, int]] = None,
                     ) -> Tuple[MaxSumState, torch.Tensor, torch.Tensor]:
    """Like :func:`run_maxsum`, also recording the cost of the selected
    assignment after every cycle: a [max_cycles] tensor on the graph's
    device, written there each cycle (no host sync of its own).
    ``var_base_costs`` ([V, D], the noise-free variable costs, on the
    graph's device) adds the variable-side costs.  With
    ``stop_on_convergence`` the run stops at the fixpoint and the rest
    of the curve holds the final cost.  ``prune`` and ``stats`` as in
    :func:`run_maxsum_from`: pruning never changes a cost.

    Returns (final state, selected values [V], costs [max_cycles])."""
    def cost_of(values):
        cost = assignment_constraint_cost(graph, values)
        if var_base_costs is not None:
            cost = cost + torch.sum(torch.gather(
                var_base_costs, 1, values.to(torch.int64)[:, None]))
        return cost

    costs = torch.zeros((max_cycles,), dtype=graph.var_costs.dtype,
                        device=graph.var_costs.device)
    last = torch.zeros((), dtype=costs.dtype, device=costs.device)
    state = init_state(graph)
    n = 0
    for state in _cycles(
            graph, state, max_cycles, _active_prune(graph, prune),
            stop_on_convergence, stats, damping=damping,
            damp_vars=damp_vars, damp_factors=damp_factors,
            stability=stability):
        beliefs, _ = aggregate_beliefs(graph, state.f2v)
        last = cost_of(select_values(graph, beliefs))
        costs[n] = last
        n += 1
    # An early exit leaves the tail unwritten: hold the final cost.
    costs[n:] = last
    beliefs, _ = aggregate_beliefs(graph, state.f2v)
    values = select_values(graph, beliefs)
    return state, values, costs
