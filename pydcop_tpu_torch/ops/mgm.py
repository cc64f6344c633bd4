"""MGM (Maximum Gain Message) step — monotone local search.

Port of ``pydcop_tpu/ops/mgm.py`` (pyDCOP's mgm.py:213-609).  Per cycle
(the value phase and the gain phase in one lockstep step) each variable
computes its best local response and gain given its neighbours'
previous values; its proposal is a uniform-random optimal value when
the gain is positive, else its current value; only the variable with
the strictly largest gain in its neighbourhood moves, equal gains broken
by lexical variable order or by per-cycle random draws (``break_mode``).

As ``ops/dsa.py``: a host loop whose key chain and cycle stay on the
host, so the loop reads nothing from the device.
"""

from typing import NamedTuple, Tuple

import torch

from pydcop_tpu_torch.device import TorchFactorGraph
from pydcop_tpu_torch.ops import threefry
from pydcop_tpu_torch.ops.localsearch import (
    assignment_cost,
    candidate_costs,
    neighborhood_winners,
    placed,
    random_initial_values,
)
from pydcop_tpu_torch.utils import prng


class MgmState(NamedTuple):
    values: torch.Tensor  # [V+1] int32
    key: prng.Words
    cycle: int


def init_state(graph: TorchFactorGraph, seed: int = 0) -> MgmState:
    key, k0 = prng.split_words(prng.key_words(seed))
    return MgmState(values=random_initial_values(k0, graph), key=key,
                    cycle=0)


def mgm_step(state: MgmState, graph: TorchFactorGraph, *,
             lexic_ranks: torch.Tensor, break_mode: str) -> MgmState:
    """One lockstep MGM cycle (value + gain phases)."""
    key, k_choice, k_rand = prng.split_words(state.key, 3)
    values = state.values
    if break_mode == "random":
        # A fresh draw every cycle (the reference's random_nb).
        ranks = threefry.uniform(k_rand, values.shape, values.device)
    else:
        ranks = lexic_ranks
    cand = candidate_costs(graph, values)                   # [V+1, D]
    gain, proposed, _, wins = neighborhood_winners(
        graph, cand, values, k_choice, ranks)
    new_vals = torch.where(gain > 0, proposed, values)
    values = torch.where(wins, new_vals, values)
    return MgmState(values=values, key=key, cycle=state.cycle + 1)


def run_mgm(graph: TorchFactorGraph, max_cycles: int, *,
            lexic_ranks: torch.Tensor, break_mode: str = "lexic",
            seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Full MGM run.  ``lexic_ranks`` is [V+1] float32 (numpy arrays are
    placed on the graph's device before the loop).  Returns (values
    [V], final cost, cycles)."""
    lexic_ranks = placed(graph, lexic_ranks)
    state = init_state(graph, seed)
    for _ in range(max_cycles):
        state = mgm_step(state, graph, lexic_ranks=lexic_ranks,
                         break_mode=break_mode)
    cost = assignment_cost(graph, state.values)
    return state.values[:-1], cost, state.cycle
