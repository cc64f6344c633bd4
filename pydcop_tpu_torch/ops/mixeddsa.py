"""MixedDSA step — DSA for problems mixing hard and soft constraints.

Port of ``pydcop_tpu/ops/mixeddsa.py`` (pyDCOP's mixeddsa.py:154-470).
A constraint is hard when a valid entry of its table is infinite (>=
BIG, the compiled graph's stand-in).  Each variable ranks its candidate
values by the number of violated hard constraints, then by the DCOP
cost without the violated hard constraints' infinities, and moves
(mixeddsa.py:301-345):

- with ``proba_hard`` when a hard improvement exists;
- with ``proba_soft`` when only a soft improvement exists;
- with ``proba_hard`` to another optimum when hard conflicts remain and
  nothing improves;
- with ``proba_soft`` to another optimum, variants B and C, when no
  hard conflict remains, nothing improves and an incident soft
  constraint is above its own optimum.

The reference's last variant-C branch repeats an earlier condition and
is never reached; it is not reproduced here either.

The reference sums the two candidate metrics in two chains of
``jax.ops.segment_sum`` per (bucket, position) unit, interleaved, and
not through its ``positional_sum``; XLA folds the float ``cost`` chain
as it folds the positional sum (``segment_sum.positional_fold``, read
from the optimised HLO of the jitted step with the graph an argument),
and it scatters under ``aggregation="ell"`` too.  Both sums are one
launch each of the positional sum's contributions entry
(``unit_sum(..., ell=False)``); the count of violated hard constraints
is integer-valued, exact in any order.

As ``ops/dsa.py``: a host loop whose key chain and cycle stay on the
host, so the loop reads nothing from the device.
"""

from typing import List, NamedTuple, Tuple

import torch

from pydcop_tpu_torch.device import TorchFactorGraph
from pydcop_tpu_torch.engine.compile import BIG
from pydcop_tpu_torch.ops import threefry
from pydcop_tpu_torch.ops.flush import ftz
from pydcop_tpu_torch.ops.localsearch import (
    _fix_other_axes,
    assignment_cost,
    current_of,
    factor_current_costs,
    factor_min_over_valid,
    factor_valid_masks,
    positional_max,
    random_best_choice,
    random_initial_values,
    unit_sum,
)
from pydcop_tpu_torch.utils import prng

Classes = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


class MixedDsaState(NamedTuple):
    values: torch.Tensor  # [V+1] int32
    key: prng.Words
    cycle: int


def init_state(graph: TorchFactorGraph, seed: int = 0) -> MixedDsaState:
    key, k0 = prng.split_words(prng.key_words(seed))
    return MixedDsaState(values=random_initial_values(k0, graph), key=key,
                         cycle=0)


def classify_factors(graph: TorchFactorGraph) -> Classes:
    """Per bucket: (hard [F] bool, soft optimum [F]): hard when a valid
    entry is >= BIG; the optimum is the factor's min over its valid
    region (+inf on padding rows, which are harmless: their costs are
    zero)."""
    out = []
    for b, valid in zip(graph.buckets, factor_valid_masks(graph)):
        hard = (valid & (b.costs >= float(BIG))).reshape(
            valid.shape[0], -1).any(dim=1)
        out.append((hard, factor_min_over_valid(b, valid)))
    return tuple(out)


def candidate_metrics(graph: TorchFactorGraph, values: torch.Tensor,
                      classes: Classes) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nb_viol [V+1, D], cost [V+1, D]): per candidate value, the count
    of violated hard constraints and the DCOP cost without their
    infinities (_compute_dcop_cost, mixeddsa.py:410-446)."""
    viols: List[List[torch.Tensor]] = []
    costs: List[List[torch.Tensor]] = []
    for b, (hard, _) in zip(graph.buckets, classes):
        v_cols, c_cols = [], []
        for p in range(b.var_ids.shape[1]):
            fixed = _fix_other_axes(b.costs, b.var_ids, values, p)
            viol = hard[:, None] & (fixed >= float(BIG))
            v_cols.append(viol.to(torch.float32))
            c_cols.append(torch.where(viol, 0.0, fixed))
        viols.append(v_cols)
        costs.append(c_cols)
    nb_viol = unit_sum(graph, viols, torch.zeros_like(graph.var_costs),
                       ell=False)
    return nb_viol, unit_sum(graph, costs, graph.var_costs, ell=False)


def soft_violated_vars(graph: TorchFactorGraph, values: torch.Tensor,
                       classes: Classes) -> torch.Tensor:
    """[V+1] bool: has an incident soft constraint above its optimum
    (exists_violated_soft_constraint, mixeddsa.py:464).  A max needs no
    order; it scatters under ``ell`` too, as the reference's
    ``segment_max`` does (the sentinel row then takes the padding
    rows')."""
    per_bucket = []
    for b, cur, (hard, opt) in zip(graph.buckets,
                                   factor_current_costs(graph, values),
                                   classes):
        sv = ((~hard) & (cur != opt)).to(torch.int32)
        per_bucket.append(sv[:, None].expand(b.var_ids.shape))
    return positional_max(graph, per_bucket, 0, ell=False) > 0


def mixeddsa_step(state: MixedDsaState, graph: TorchFactorGraph, *,
                  variant: str, proba_hard: float, proba_soft: float,
                  classes: Classes) -> MixedDsaState:
    """One lockstep MixedDSA cycle."""
    key, k_choice, k_change = prng.split_words(state.key, 3)
    values = state.values
    valid = graph.var_valid

    nb_viol, cost = candidate_metrics(graph, values, classes)
    cur_nb = current_of(nb_viol, values)
    cur_cost = current_of(cost, values)

    # Lexicographic best: fewest violated hard constraints, then cost
    # (_compute_best_value, mixeddsa.py:381-402).
    min_nb = torch.where(valid, nb_viol, torch.inf).amin(dim=1)
    tie = valid & (nb_viol == min_nb[:, None])
    best_cost = torch.where(tie, cost, torch.inf).amin(dim=1)
    is_best = tie & (cost == best_cost[:, None])
    n_best = is_best.sum(dim=1)

    delta_dcsp = cur_nb - min_nb
    delta_dcop = ftz(cur_cost - best_cost)

    one_hot_cur = (torch.arange(cost.shape[1], device=cost.device)[None, :]
                   == values[:, None])
    alt_best = is_best & ~one_hot_cur      # the optima but the current

    b_hard = delta_dcsp > 0
    b_soft = (delta_dcsp == 0) & (delta_dcop > 0)
    no_improve = (delta_dcsp == 0) & (delta_dcop == 0)
    b_escape_hard = no_improve & (min_nb > 0) & (n_best > 1)
    if variant in ("B", "C"):
        b_escape_soft = (no_improve & (min_nb == 0)
                         & soft_violated_vars(graph, values, classes)
                         & (n_best > 1))
    else:
        b_escape_soft = torch.zeros_like(b_hard)

    proba = (torch.where(b_hard | b_escape_hard, proba_hard, 0.0)
             + torch.where(b_soft | b_escape_soft, proba_soft, 0.0))
    escape = b_escape_hard | b_escape_soft
    choice_mask = torch.where(escape[:, None], alt_best, is_best)

    new_vals = random_best_choice(k_choice, choice_mask)
    u = threefry.uniform(k_change, (values.shape[0],), values.device)
    values = torch.where(u < proba, new_vals, values)
    return MixedDsaState(values=values, key=key, cycle=state.cycle + 1)


def run_mixeddsa(graph: TorchFactorGraph, max_cycles: int, *,
                 variant: str = "B", proba_hard: float = 0.7,
                 proba_soft: float = 0.5, seed: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Full MixedDSA run.  Returns (values [V], the final cost with the
    hard infinities, cycles)."""
    state = init_state(graph, seed)
    classes = classify_factors(graph)
    for _ in range(max_cycles):
        state = mixeddsa_step(state, graph, variant=variant,
                              proba_hard=proba_hard, proba_soft=proba_soft,
                              classes=classes)
    cost = assignment_cost(graph, state.values)
    return state.values[:-1], cost, state.cycle
