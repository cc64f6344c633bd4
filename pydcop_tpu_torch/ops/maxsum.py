"""MaxSum message updates on torch tensors: one BSP superstep.

Port of the dense path of ``pydcop_tpu/ops/maxsum.py``, function for
function, so each can be held to its JAX counterpart on the same graph
and state (``tests/test_torch_maxsum_ops.py``):

- factor->variable: per arity bucket, ``total = costs + sum_q bcast(m_q)``
  then, for each position p, ``min`` over the other axes minus ``m_p``.
  Arity 2 goes to ``ops/binary_factor.py`` — the hand-written CUDA
  kernel on the card, its plain version on the CPU;
- variable->factor: per-variable sum of incoming messages in a fixed
  order (``ops/segment_sum.py`` — a hand-written CUDA kernel on the
  card, so the sums are the CPU's and the reference's bit for bit),
  minus the own message, mean-normalised over valid domain slots,
  damped;
- value selection: first-index argmin of own costs + message sums over
  valid slots.

Messages live in bucket space (``[F, arity, D]`` per bucket).  All
kernels minimize; ``objective=max`` problems are negated at compile
time.  Every element-wise expression keeps the reference's operation
order, because damping and mean-normalisation accrete mantissa bits
cycle after cycle and a reassociated sum drifts the trajectory.

The reference runs the solve loop on the device (``lax.while_loop``);
here it is a host loop of supersteps that reads ``stable`` once per
cycle when it may stop early, and never when it runs a fixed count.
``cycles`` and ``converged`` equal the reference's on the same graph.
Not ported yet: branch-and-bound pruning (``prune=True`` raises) and
the cost-trace loop.
"""

from typing import NamedTuple, Tuple

import torch

from pydcop_tpu_torch.device import TorchFactorGraph
from pydcop_tpu_torch.engine.compile import BIG
from pydcop_tpu_torch.ops.binary_factor import binary_factor_update
from pydcop_tpu_torch.ops.segment_sum import segment_sum

Msgs = Tuple[torch.Tensor, ...]  # one [F, arity, D] tensor per bucket

# Reference maxsum.py:106 SAME_COUNT: a message that approx-matches the
# previously sent one is re-sent at most this many times, then the edge
# goes quiet (the receiver keeps the last value).
SAME_COUNT = 4


class MaxSumState(NamedTuple):
    v2f: Msgs              # last SENT variable -> factor messages
    f2v: Msgs              # last SENT factor -> variable messages
    v2f_count: Msgs        # [F, arity] int8 consecutive-same send counts
    f2v_count: Msgs
    stable: torch.Tensor   # 0-d bool: all messages approx-matched
    cycle: torch.Tensor    # 0-d int32


def init_state(graph: TorchFactorGraph) -> MaxSumState:
    """Zero messages and counts, one tensor per field and bucket
    (int8 counts: they saturate at SAME_COUNT + 1)."""
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


def _edge_match(new: torch.Tensor, old: torch.Tensor, stability: float,
                valid: torch.Tensor) -> torch.Tensor:
    """Per-edge approx_match (reference maxsum.py:688): relative change
    ``2|d|/|a+b|`` below ``stability`` on every valid domain slot, exact
    equality always matching.  Returns [F, arity] bool."""
    delta = torch.abs(new - old)
    s = torch.abs(new + old)
    ok = (2 * delta < stability * s) | (delta == 0)
    return torch.all(ok | ~valid, dim=-1)


def _send_or_suppress(cand: torch.Tensor, prev: torch.Tensor,
                      count: torch.Tensor, stability: float,
                      valid: torch.Tensor, first: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference send-suppression (maxsum.py:366-377): a candidate that
    approx-matches the last sent message is re-sent at most SAME_COUNT
    times, then the edge freezes on the last sent value.

    Returns (sent messages, new counts, per-edge match flags)."""
    match = _edge_match(cand, prev, stability, valid) & ~first
    send = ~match | (count < SAME_COUNT)
    sent = torch.where(send[..., None], cand, prev)
    new_count = torch.where(
        match, torch.clamp(count + 1, max=SAME_COUNT + 1),
        torch.ones_like(count))
    return sent, new_count, match


def factor_to_var(graph: TorchFactorGraph, v2f: Msgs,
                  prune=None) -> Msgs:
    """All factor->variable messages for one superstep."""
    if prune is not None:
        raise NotImplementedError(
            "branch-and-bound pruning is not ported yet")
    out = []
    for bucket, msgs in zip(graph.buckets, v2f):
        f, arity, d = msgs.shape
        if arity == 2:
            out.append(binary_factor_update(bucket.costs, msgs))
            continue
        total = bucket.costs  # [F, D, ..., D]
        for q in range(arity):
            shape = [f] + [1] * arity
            shape[q + 1] = d
            total = total + msgs[:, q].reshape(shape)
        outs_p = []
        for p in range(arity):
            axes = tuple(i + 1 for i in range(arity) if i != p)
            reduced = torch.amin(total, dim=axes) if axes else total
            outs_p.append(reduced - msgs[:, p])
        out.append(torch.stack(outs_p, dim=1))  # [F, arity, D]
    return tuple(out)


def aggregate_beliefs(graph: TorchFactorGraph, f2v: Msgs
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum incoming factor messages per variable in the order the
    reference's jitted superstep sums them: edge order within a bucket;
    across buckets XLA folds the per-bucket segment_sums so that bucket
    0 starts from zero, each odd bucket is summed from zero on its own
    and added, and each even bucket is added into the running sums.
    Returns (beliefs [V+1, D] = own costs + sums, sums).  The same bits
    on the card and on the CPU: the card runs ``csrc/segment_sum.cu``,
    whose order is fixed."""
    if not graph.buckets:
        # Constraint-free DCOP: no incoming messages at all.
        return graph.var_costs, torch.zeros_like(graph.var_costs)
    d = graph.var_costs.shape[1]
    flats = [msgs.reshape(-1, d) for msgs in f2v]
    # One bucket is a view; several are concatenated (one copy of the
    # messages per call).
    flat = flats[0] if len(flats) == 1 else torch.cat(flats)
    return segment_sum(flat, graph.agg_perm, graph.agg_offsets,
                       graph.agg_buckets, graph.var_costs)


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (domain) axis, left to right, keeping the axis:
    the order XLA reduces in.  ``torch.sum`` vectorises some widths
    (D=5 on the CPU) into another order, which changes the last bit."""
    acc = x[..., :1]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k:k + 1]
    return acc


def var_to_factor(graph: TorchFactorGraph, f2v: Msgs,
                  beliefs: torch.Tensor, sums: torch.Tensor) -> Msgs:
    """All variable->factor messages: belief minus own contribution,
    mean-normalized over valid slots (reference maxsum.py:670-674)."""
    out = []
    for bucket, msgs in zip(graph.buckets, f2v):
        valid = graph.var_valid[bucket.var_ids]        # [F, a, D]
        raw = beliefs[bucket.var_ids] - msgs           # own cost + others
        factor_sum = sums[bucket.var_ids] - msgs       # others only
        n_valid = torch.clamp(
            torch.sum(valid, dim=-1, keepdim=True, dtype=torch.int32),
            min=1)
        avg = _sum_last(torch.where(valid, factor_sum, 0.0)) / n_valid
        out.append(torch.where(valid, raw - avg, float(BIG)))
    return tuple(out)


def select_values(graph: TorchFactorGraph,
                  beliefs: torch.Tensor) -> torch.Tensor:
    """Per-variable argmin of belief over valid slots ([V] int32); ties
    go to the first index."""
    masked = torch.where(graph.var_valid, beliefs, torch.inf)
    return torch.argmin(masked[:-1], dim=1).to(torch.int32)


def _damp(new: Msgs, old: Msgs, damping: float,
          first: torch.Tensor) -> Msgs:
    """damped = damping * prev + (1-damping) * new; no damping on the
    first cycle (reference maxsum.py:679)."""
    return tuple(
        torch.where(first, n, damping * o + (1.0 - damping) * n)
        for n, o in zip(new, old)
    )


def superstep(state: MaxSumState, graph: TorchFactorGraph, *,
              damping: float, damp_vars: bool, damp_factors: bool,
              stability: float, prune=None) -> MaxSumState:
    """One synchronous MaxSum cycle: in cycle k BOTH sides fire from
    the messages sent in cycle k-1, with per-edge damping and
    SAME_COUNT send-suppression."""
    first = state.cycle == 0
    valids = tuple(
        graph.var_valid[b.var_ids] for b in graph.buckets
    )

    f2v_cand = factor_to_var(graph, state.v2f, prune=prune)
    if damp_factors and damping > 0:
        f2v_cand = _damp(f2v_cand, state.f2v, damping, first)

    # Variable side uses the factor messages from the PREVIOUS cycle.
    beliefs, sums = aggregate_beliefs(graph, state.f2v)
    v2f_cand = var_to_factor(graph, state.f2v, beliefs, sums)
    if damp_vars and damping > 0:
        v2f_cand = _damp(v2f_cand, state.v2f, damping, first)

    f2v_new, f2v_count = [], []
    v2f_new, v2f_count = [], []
    all_match = torch.ones((), dtype=torch.bool,
                           device=graph.var_costs.device)
    for i, valid in enumerate(valids):
        edge_live = torch.any(valid, dim=-1)
        sent, cnt, match = _send_or_suppress(
            f2v_cand[i], state.f2v[i], state.f2v_count[i],
            stability, valid, first)
        f2v_new.append(sent)
        f2v_count.append(cnt)
        all_match = all_match & torch.all(match | ~edge_live)
        sent, cnt, match = _send_or_suppress(
            v2f_cand[i], state.v2f[i], state.v2f_count[i],
            stability, valid, first)
        v2f_new.append(sent)
        v2f_count.append(cnt)
        all_match = all_match & torch.all(match | ~edge_live)

    return MaxSumState(
        v2f=tuple(v2f_new),
        f2v=tuple(f2v_new),
        v2f_count=tuple(v2f_count),
        f2v_count=tuple(f2v_count),
        stable=all_match & ~first,
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
               ) -> Tuple[MaxSumState, torch.Tensor]:
    """Full MaxSum run from zero messages.

    Returns (final state, selected value indices [V])."""
    return run_maxsum_from(
        graph, init_state(graph), max_cycles,
        damping=damping, damp_vars=damp_vars,
        damp_factors=damp_factors, stability=stability,
        stop_on_convergence=stop_on_convergence, prune=prune,
    )


def run_maxsum_from(graph: TorchFactorGraph, state: MaxSumState,
                    extra_cycles: int, *,
                    damping: float = 0.5, damp_vars: bool = True,
                    damp_factors: bool = True, stability: float = 0.1,
                    stop_on_convergence: bool = True,
                    prune: bool = False,
                    ) -> Tuple[MaxSumState, torch.Tensor]:
    """Run up to ``extra_cycles`` more supersteps from ``state``,
    stopping early at the fixpoint when ``stop_on_convergence`` — the
    reference's ``while cycle < limit and not stable`` loop."""
    if prune:
        raise NotImplementedError(
            "branch-and-bound pruning (prune=True) is not ported yet")
    for _ in range(extra_cycles):
        if stop_on_convergence and bool(state.stable):
            break
        state = superstep(
            state, graph, damping=damping, damp_vars=damp_vars,
            damp_factors=damp_factors, stability=stability,
        )
    beliefs, _ = aggregate_beliefs(graph, state.f2v)
    values = select_values(graph, beliefs)
    return state, values
