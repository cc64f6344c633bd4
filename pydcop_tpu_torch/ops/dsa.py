"""DSA (Distributed Stochastic Algorithm) step — variants A/B/C.

Port of ``pydcop_tpu/ops/dsa.py`` (pyDCOP's dsa.py:214-431): per cycle
each variable computes its best local response given its neighbours'
previous values, and changes (to a uniform-random choice among optimal
values) with probability p when

- variant A: strict improvement exists (delta > 0);
- variant B: delta > 0, or delta == 0 with some incident constraint not
  at its own optimum — dropping the current value from the candidates
  when other optima exist;
- variant C: delta >= 0, same current-value dropping.

The whole population updates in lockstep from previous-cycle values.

The reference runs the cycles in one ``fori_loop``; here :func:`run_dsa`
is a host loop of :func:`dsa_step` calls that never reads the device:
the state's key (two host words) and cycle are Python values, every key
of a step comes from ``prng.split_words`` of the previous one, and the
draws are ``ops/threefry.py``'s kernels on the card.
"""

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from pydcop_tpu_torch.device import TorchFactorGraph
from pydcop_tpu_torch.ops import threefry
from pydcop_tpu_torch.ops.flush import ftz
from pydcop_tpu_torch.ops.localsearch import (
    assignment_cost,
    best_candidates,
    candidate_costs,
    current_of,
    factor_current_costs,
    placed,
    positional_max,
    random_best_choice,
    random_initial_values,
)
from pydcop_tpu_torch.utils import prng


class DsaState(NamedTuple):
    values: torch.Tensor  # [V+1] int32 current value index (sentinel last)
    key: prng.Words       # the two key words, on the host
    cycle: int


def init_state(graph: TorchFactorGraph, seed: int = 0) -> DsaState:
    key, k0 = prng.split_words(prng.key_words(seed))
    return DsaState(values=random_initial_values(k0, graph), key=key,
                    cycle=0)


def greedy_classes(graph) -> Tuple[np.ndarray, int]:
    """Greedy graph colouring of the variable adjacency (host numpy, a
    copy of the reference's): ([V+1] int32 class ids, n_classes) such
    that no two variables sharing a constraint get the same class.
    ``graph`` is the compiled (numpy) or the placed graph.  Used by the
    staggered schedule of adsa: per superstep only one class flips."""
    n = int(graph.var_costs.shape[0])
    pairs = []
    for bucket in graph.buckets:
        ids = _numpy(bucket.var_ids)
        arity = ids.shape[1]
        for p in range(arity):
            for q in range(p + 1, arity):
                pairs.append(ids[:, (p, q)])
    if pairs:
        edges = np.concatenate(pairs, axis=0)
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        keep = lo != hi  # drop self/sentinel-padding pairs
        edges = np.unique(
            np.stack([lo[keep], hi[keep]], axis=1), axis=0)
    else:
        edges = np.zeros((0, 2), dtype=np.int64)
    # CSR-style adjacency from the symmetric edge list.
    sym = np.concatenate([edges, edges[:, ::-1]], axis=0)
    order_idx = np.argsort(sym[:, 0], kind="stable")
    srcs, dsts = sym[order_idx, 0], sym[order_idx, 1]
    starts = np.searchsorted(srcs, np.arange(n + 1))
    degree = starts[1:] - starts[:-1]
    # The sentinel row (last) absorbs padding edges; colour it freely.
    classes = np.full(n, -1, dtype=np.int32)
    # Highest degree first keeps the class count near the graph's
    # chromatic bound (degree+1 worst case).
    for v in np.argsort(-degree[:-1], kind="stable"):
        neigh = dsts[starts[v]:starts[v + 1]]
        taken = set(int(c) for c in classes[neigh] if c >= 0)
        c = 0
        while c in taken:
            c += 1
        classes[v] = c
    classes[n - 1] = 0
    n_classes = int(classes.max()) + 1 if n > 1 else 1
    return classes, n_classes


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def factor_optima(graph: TorchFactorGraph) -> Tuple[torch.Tensor, ...]:
    """Per bucket, each factor's optimal (min) cost over all
    assignments (the reference's best_constraints_costs)."""
    return tuple(b.costs.reshape(b.costs.shape[0], -1).amin(dim=1)
                 for b in graph.buckets)


def violated_vars(graph: TorchFactorGraph, values: torch.Tensor,
                  optima: Optional[Tuple[torch.Tensor, ...]] = None
                  ) -> torch.Tensor:
    """[V+1] bool: has an incident constraint not at its optimal cost
    (``optima``: :func:`factor_optima`, computed here when not given)."""
    if optima is None:
        optima = factor_optima(graph)
    per_bucket = []
    for bucket, cur, opt in zip(graph.buckets,
                                factor_current_costs(graph, values),
                                optima):
        viol = (cur != opt).to(torch.int32)
        per_bucket.append(viol[:, None].expand(bucket.var_ids.shape))
    return positional_max(graph, per_bucket, 0) > 0


Probability = Union[float, torch.Tensor]


def dsa_choices(graph: TorchFactorGraph, values: torch.Tensor,
                variant: str,
                optima: Optional[Tuple[torch.Tensor, ...]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eligible [V+1] bool, choice_mask [V+1, D] bool) of one DSA
    cycle at ``values``: who may change, and among which values the
    new one is drawn."""
    cand = candidate_costs(graph, values)                   # [V+1, D]
    cur = current_of(cand, values)
    best, is_best = best_candidates(graph, cand)
    delta = ftz(cur - best)                                  # >= 0

    if variant == "A":
        return delta > 0, is_best
    n_best = is_best.sum(dim=1)
    one_hot_cur = (
        torch.arange(cand.shape[1], device=cand.device)[None, :]
        == values[:, None])
    drop_cur = ((delta == 0) & (n_best > 1))[:, None] & one_hot_cur
    choice_mask = is_best & ~drop_cur
    if variant == "B":
        eligible = (delta > 0) | (
            (delta == 0) & violated_vars(graph, values, optima))
    else:  # C
        eligible = delta >= 0
    return eligible, choice_mask


def dsa_step(state: DsaState, graph: TorchFactorGraph, *, variant: str,
             probability: Probability,
             classes: Optional[torch.Tensor] = None, n_classes: int = 1,
             optima: Optional[Tuple[torch.Tensor, ...]] = None
             ) -> DsaState:
    """One lockstep DSA cycle.  ``probability`` is a float or a [V+1]
    float32 tensor (p_mode=arity).  With ``classes`` / ``n_classes`` set
    (the staggered schedule of adsa) only the variables whose class
    equals ``cycle mod n_classes`` may flip."""
    key, k_choice, k_change = prng.split_words(state.key, 3)
    values = state.values
    eligible, choice_mask = dsa_choices(graph, values, variant, optima)
    new_vals = random_best_choice(k_choice, choice_mask)
    u = threefry.uniform(k_change, (values.shape[0],), values.device)
    change = eligible & (u < probability)
    if classes is not None and n_classes > 1:
        change = change & (classes == state.cycle % n_classes)
    values = torch.where(change, new_vals, values)
    return DsaState(values=values, key=key, cycle=state.cycle + 1)


def run_dsa(graph: TorchFactorGraph, max_cycles: int, *,
            variant: str = "B", probability: Probability = 0.7,
            seed: int = 0, classes: Optional[torch.Tensor] = None,
            n_classes: int = 1
            ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Full DSA run: ``max_cycles`` steps from the seeded initial state
    (with a staggered schedule the caller scales ``max_cycles`` by
    ``n_classes``).  A per-variable ``probability`` and ``classes`` may
    be numpy arrays: they are placed on the graph's device before the
    loop.  Returns (values [V], final cost, cycles)."""
    probability = placed(graph, probability)
    classes = placed(graph, classes)
    state = init_state(graph, seed)
    optima = factor_optima(graph) if variant == "B" else None
    for _ in range(max_cycles):
        state = dsa_step(state, graph, variant=variant,
                         probability=probability, classes=classes,
                         n_classes=n_classes, optima=optima)
    cost = assignment_cost(graph, state.values)
    return state.values[:-1], cost, state.cycle
