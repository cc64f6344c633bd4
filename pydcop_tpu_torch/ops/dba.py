"""DBA (Distributed Breakout Algorithm) step — constraint satisfaction.

Port of ``pydcop_tpu/ops/dba.py`` (pyDCOP's dba.py:272-595, Yokoo &
Hirayama 1996).  The objective is the weighted count of violated
constraints (violated: cost >= ``infinity``), with per-(variable,
constraint) breakout weights that start at 1 and grow when a
neighbourhood is stuck in a quasi-local minimum.  One lockstep cycle is
the reference's ok-phase and improve-phase:

- each variable's weighted violation count for every candidate value,
  its neighbours at their previous-cycle values;
- a variable moves iff its improvement is positive and the strict
  neighbourhood max, the lexically smallest name winning ties;
- a quasi-local minimum raises its variables' weights of violated
  constraints by 1;
- termination counters: reset when the own eval is non-zero, set to the
  neighbours' min, incremented while the neighbourhood is consistent.

The reference stops in a ``lax.while_loop`` once every real variable's
counter reaches ``max_distance``.  :func:`run_dba` is a host loop that
reads nothing from the card inside a chunk of ``chunk`` steps: each
step is gated on the card by the reference's loop condition computed
before it (a gated step keeps the values, weights and counters and does
not advance the device's cycle counter), and the host reads the flag
and the counter once per chunk.  The result does not depend on the
chunk; the host key chain goes on advancing through gated steps, whose
draws are discarded.
"""

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from pydcop_tpu_torch.device import TorchFactorGraph
from pydcop_tpu_torch.ops.localsearch import (
    _fix_other_axes,
    current_of,
    factor_current_costs,
    neighbor_max,
    neighborhood_winners,
    placed,
    random_initial_values,
    unit_sum,
)
from pydcop_tpu_torch.utils import prng

# Steps a chunk runs with no host read (timings in PERF.md §6): a read
# drains the card's queue, a gated step after the stop costs a cycle.
CHUNK = 16


class DbaState(NamedTuple):
    values: torch.Tensor                # [V+1] int32
    weights: Tuple[torch.Tensor, ...]   # per bucket [F, arity] f32
    term_counter: torch.Tensor          # [V+1] f32
    key: prng.Words
    cycle: torch.Tensor                 # int32 scalar, on the device


def init_state(graph: TorchFactorGraph, seed: int = 0) -> DbaState:
    key, k0 = prng.split_words(prng.key_words(seed))
    dev = graph.var_costs.device
    return DbaState(
        values=random_initial_values(k0, graph),
        weights=tuple(torch.ones(b.var_ids.shape, device=dev)
                      for b in graph.buckets),
        term_counter=torch.zeros((graph.var_costs.shape[0],), device=dev),
        key=key,
        cycle=torch.zeros((), dtype=torch.int32, device=dev),
    )


def weighted_violation_counts(graph: TorchFactorGraph,
                              weights: Sequence[torch.Tensor],
                              values: torch.Tensor,
                              infinity: float) -> torch.Tensor:
    """[V+1, D]: per variable and candidate value, the weighted count of
    incident violated constraints, neighbours at ``values`` (no unary
    costs).  The counts are integers, exact in any order; they go
    through the positional sum (``unit_sum``) like the reference's."""
    per_bucket: List[List[torch.Tensor]] = []
    for b, w in zip(graph.buckets, weights):
        per_bucket.append([
            w[:, p:p + 1] * (_fix_other_axes(b.costs, b.var_ids, values, p)
                             >= infinity).to(torch.float32)
            for p in range(b.var_ids.shape[1])])
    return unit_sum(graph, per_bucket, torch.zeros_like(graph.var_costs))


def violation_count(graph: TorchFactorGraph, values: torch.Tensor,
                    infinity: float) -> torch.Tensor:
    """Scalar float32 unweighted count of violated constraints (exact:
    a count below 2**24)."""
    total = torch.zeros((), device=graph.var_costs.device)
    for cur in factor_current_costs(graph, values):
        total = total + (cur >= infinity).sum(dtype=torch.float32)
    return total


def running(state: DbaState, max_cycles: int,
            max_distance: int) -> torch.Tensor:
    """The reference's loop condition on the card: below
    ``max_cycles`` and not every real variable's counter at
    ``max_distance`` (bool scalar)."""
    return (state.cycle < max_cycles) & ~torch.all(
        state.term_counter[:-1] >= max_distance)


def dba_step(state: DbaState, graph: TorchFactorGraph, *,
             infinity: float, lexic_ranks: torch.Tensor,
             gate: Optional[torch.Tensor] = None) -> DbaState:
    """One lockstep DBA cycle (ok + improve phases).  With ``gate`` (a
    bool scalar on the card) the step's values, weights and counters
    are kept only where it is true, and the cycle counter advances by
    it."""
    key, k_choice = prng.split_words(state.key)
    values = state.values

    cand = weighted_violation_counts(graph, state.weights, values, infinity)
    cur_eval = current_of(cand, values)
    improve, proposed, nmax, wins = neighborhood_winners(
        graph, cand, values, k_choice, lexic_ranks)
    can_move = (improve > 0) & wins
    # Quasi-local minimum: nobody in the neighbourhood can improve.
    qlm = (improve <= 0) & (nmax <= improve)
    consistent = (cur_eval == 0) & (neighbor_max(graph, cur_eval) <= 0)

    # Termination counters (dba.py:405 reset, :509 neighbour min, :541
    # increment).  The neighbours' min is the negated max of the negated
    # counters, as the reference takes it, so a signed zero would be
    # the reference's too.
    tc = torch.where(cur_eval == 0, state.term_counter, 0.0)
    tc = torch.minimum(tc, -neighbor_max(graph, -tc))
    tc = torch.where(consistent, tc + 1.0, tc)

    # Breakout: each QLM variable's weights of its violated constraints
    # grow by 1.
    weights = []
    for b, w, cur in zip(graph.buckets, state.weights,
                         factor_current_costs(graph, values)):
        viol = cur >= infinity
        weights.append(w + torch.stack([
            (qlm[b.var_ids[:, p]] & viol).to(torch.float32)
            for p in range(b.var_ids.shape[1])], dim=1))

    values = torch.where(can_move, proposed, values)
    if gate is None:
        return DbaState(values, tuple(weights), tc, key, state.cycle + 1)
    return DbaState(
        values=torch.where(gate, values, state.values),
        weights=tuple(torch.where(gate, w, old)
                      for w, old in zip(weights, state.weights)),
        term_counter=torch.where(gate, tc, state.term_counter),
        key=key,
        cycle=state.cycle + gate.to(torch.int32),
    )


def run_chunk(state: DbaState, graph: TorchFactorGraph, steps: int, *,
              infinity: float, max_distance: int, max_cycles: int,
              lexic_ranks: torch.Tensor) -> DbaState:
    """``steps`` gated steps; reads nothing from the card."""
    for _ in range(steps):
        gate = running(state, max_cycles, max_distance)
        state = dba_step(state, graph, infinity=infinity,
                         lexic_ranks=lexic_ranks, gate=gate)
    return state


def run_dba(graph: TorchFactorGraph, max_cycles: int, *,
            infinity: float = 10000.0, max_distance: int = 50,
            lexic_ranks, seed: int = 0, chunk: int = CHUNK
            ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Full DBA run: chunks of ``chunk`` gated steps, the host reading
    the loop flag and the cycle counter (one transfer) after each, so a
    run that stops at cycle c reads the card ceil(c / chunk) times
    (ceil(max_cycles / chunk) without an early stop).  Stops once every
    real variable's counter reaches ``max_distance`` (the reference's
    ``while_loop``: a DbaEndMessage only ends its own component, and
    the orchestrator waits for all of them).  Returns (values [V], the
    final unweighted violation count, cycles)."""
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    lexic_ranks = placed(graph, lexic_ranks)
    state = init_state(graph, seed)
    steps, cycles = 0, 0
    while steps < max_cycles:
        n = min(chunk, max_cycles - steps)
        state = run_chunk(state, graph, n, infinity=infinity,
                          max_distance=max_distance, max_cycles=max_cycles,
                          lexic_ranks=lexic_ranks)
        steps += n
        flag, cycles = torch.stack([
            running(state, max_cycles, max_distance).to(torch.int32),
            state.cycle]).cpu().tolist()
        if not flag:
            break
    cost = violation_count(graph, state.values, infinity)
    return state.values[:-1], cost, cycles
