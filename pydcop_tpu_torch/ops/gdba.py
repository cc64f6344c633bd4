"""GDBA (Generalized Distributed Breakout) step.

Port of ``pydcop_tpu/ops/gdba.py`` (pyDCOP's gdba.py:189-654, Okamoto
et al.).  Each variable keeps, for every incident constraint, a
modifier table the shape of the constraint's cost table; an entry's
effective cost is ``base + modifier`` (mode A) or ``base * modifier``
(mode M).  One lockstep cycle:

- candidate evaluation on effective costs, neighbours at their
  previous-cycle values, plus the unary costs added once (the
  reference's own choice, ops/gdba.py:16-18, where pyDCOP re-adds them
  per constraint);
- a variable moves iff its improvement is positive and the strict
  neighbourhood max, the lexically smallest name winning ties;
- when nobody in the neighbourhood can improve, the variable raises the
  modifiers of its violated constraints (judged on base costs: NZ cost
  != 0, NM cost != the factor's min, MX cost == its max) at the entries
  ``increase_mode`` names (E the current one, R the own axis free, C
  the others free, T all).

The candidate sums run through the positional sum (``unit_sum``: on the
card the hand kernel's contributions entry, in the reference's order).
Each position's row is gathered from the cost table and from the
modifier table, then added or multiplied and flushed: one rounding per
entry, the reference's bits without an [F, D, ..., D] effective table a
cycle.  The modifier increments are integer-valued, exact in any order.

As ``ops/dsa.py``: a host loop whose key chain and cycle stay on the
host, so the loop reads nothing from the device.
"""

from typing import List, NamedTuple, Sequence, Tuple

import torch

from pydcop_tpu_torch.device import TorchFactorGraph
from pydcop_tpu_torch.ops.flush import ftz
from pydcop_tpu_torch.ops.localsearch import (
    _fix_other_axes,
    assignment_cost,
    factor_current_costs,
    factor_max_over_valid,
    factor_min_over_valid,
    factor_valid_masks,
    neighborhood_winners,
    placed,
    random_initial_values,
    unit_sum,
)
from pydcop_tpu_torch.utils import prng

MinMax = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


class GdbaState(NamedTuple):
    values: torch.Tensor                   # [V+1] int32
    modifiers: Tuple[torch.Tensor, ...]    # per bucket [F, arity, D, ..., D]
    key: prng.Words
    cycle: int


def init_state(graph: TorchFactorGraph, modifier: str = "A",
               seed: int = 0) -> GdbaState:
    key, k0 = prng.split_words(prng.key_words(seed))
    base = 0.0 if modifier == "A" else 1.0          # gdba.py:247
    modifiers = tuple(
        torch.full((b.costs.shape[0], b.var_ids.shape[1])
                   + tuple(b.costs.shape[1:]), base,
                   device=b.costs.device)
        for b in graph.buckets)
    return GdbaState(values=random_initial_values(k0, graph),
                     modifiers=modifiers, key=key, cycle=0)


def factor_min_max(graph: TorchFactorGraph) -> MinMax:
    """Per bucket: (min [F], max [F]) of each factor's base costs over
    its valid region (pyDCOP records them at init, gdba.py:252-273)."""
    return tuple(
        (factor_min_over_valid(b, valid), factor_max_over_valid(b, valid))
        for b, valid in zip(graph.buckets, factor_valid_masks(graph)))


def candidate_eff_costs(graph: TorchFactorGraph,
                        modifiers: Sequence[torch.Tensor],
                        values: torch.Tensor,
                        modifier_mode: str) -> torch.Tensor:
    """[V+1, D]: effective cost per variable and candidate value, the
    other variables at ``values``, plus the unary costs."""
    per_bucket: List[List[torch.Tensor]] = []
    for b, mods in zip(graph.buckets, modifiers):
        cols = []
        for p in range(b.var_ids.shape[1]):
            cost = _fix_other_axes(b.costs, b.var_ids, values, p)
            mod = _fix_other_axes(mods[:, p], b.var_ids, values, p)
            cols.append(ftz(cost + mod if modifier_mode == "A"
                            else cost * mod))
        per_bucket.append(cols)
    return unit_sum(graph, per_bucket, graph.var_costs)


def increase_delta(bucket, values: torch.Tensor, mask: torch.Tensor,
                   p: int, increase_mode: str) -> torch.Tensor:
    """[F, D, ..., D] one-increment table for position ``p``'s
    modifier: the outer product over the axes of one-hot(current value)
    or ones, gated by ``mask`` [F] (gdba.py:627-654)."""
    n_f, arity = bucket.var_ids.shape
    dmax = bucket.costs.shape[1]
    out = mask.to(torch.float32)
    for q in range(arity):
        if increase_mode == "T":
            hot = False
        elif increase_mode == "E":
            hot = True
        elif increase_mode == "R":
            hot = q != p     # own axis free, others at current
        else:  # "C"
            hot = q == p     # own axis at current, others free
        if hot:
            wq = torch.nn.functional.one_hot(
                values[bucket.var_ids[:, q]].long(), dmax).to(torch.float32)
        else:
            wq = torch.ones((n_f, dmax), device=out.device)
        out = out[..., None] * wq.reshape((n_f,) + (1,) * q + (dmax,))
    return out


def gdba_step(state: GdbaState, graph: TorchFactorGraph, *,
              modifier_mode: str, violation_mode: str, increase_mode: str,
              minmax: MinMax, lexic_ranks: torch.Tensor) -> GdbaState:
    """One lockstep GDBA cycle (ok + improve phases)."""
    key, k_choice = prng.split_words(state.key)
    values = state.values

    cand = candidate_eff_costs(graph, state.modifiers, values,
                               modifier_mode)
    improve, proposed, nmax, wins = neighborhood_winners(
        graph, cand, values, k_choice, lexic_ranks)
    can_move = (improve > 0) & wins
    # Breakout: nobody in the neighbourhood can improve (gdba.py:529).
    stuck = (improve <= 0) & (nmax <= 0)

    modifiers = []
    for b, mods, cur, (fmin, fmax) in zip(
            graph.buckets, state.modifiers,
            factor_current_costs(graph, values), minmax):
        if violation_mode == "NZ":
            violated = cur != 0
        elif violation_mode == "NM":
            violated = cur != fmin
        else:  # "MX"
            violated = cur == fmax
        modifiers.append(mods + torch.stack([
            increase_delta(b, values, stuck[b.var_ids[:, p]] & violated,
                           p, increase_mode)
            for p in range(b.var_ids.shape[1])], dim=1))

    values = torch.where(can_move, proposed, values)
    return GdbaState(values=values, modifiers=tuple(modifiers), key=key,
                     cycle=state.cycle + 1)


def run_gdba(graph: TorchFactorGraph, max_cycles: int, *,
             modifier_mode: str = "A", violation_mode: str = "NZ",
             increase_mode: str = "E", lexic_ranks, seed: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Full GDBA run.  Returns (values [V], the final assignment's base
    cost — the modifiers only steer the search —, cycles)."""
    lexic_ranks = placed(graph, lexic_ranks)
    state = init_state(graph, modifier=modifier_mode, seed=seed)
    minmax = factor_min_max(graph)
    for _ in range(max_cycles):
        state = gdba_step(state, graph, modifier_mode=modifier_mode,
                          violation_mode=violation_mode,
                          increase_mode=increase_mode, minmax=minmax,
                          lexic_ranks=lexic_ranks)
    cost = assignment_cost(graph, state.values)
    return state.values[:-1], cost, state.cycle
