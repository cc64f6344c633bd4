"""MGM2 step — coordinated 2-opt local search.

Port of ``pydcop_tpu/ops/mgm2.py`` (pyDCOP's mgm2.py:399-1050, the
5-phase protocol value / offer / answer / gain / go in one lockstep
cycle).  Its module docstring gives the phases and the device form's
documented divergences from the agent protocol; the port keeps the
reference's device form, draw for draw.

Two points of the port:

- The key chain is on the host: ``split`` of the state's key into five,
  ``fold_in`` of the family key per (bucket, p, q) family and per draw.
  Every draw is ``ops/threefry.py``'s kernel on the card: the offerer
  coin, the partner scores, the uniform pick among tied joint moves
  (``best_choice`` over the [F, dmax²] ties) and the acceptance draws.
- The reference's ``.at[idx].set(v, mode="drop")`` keeps, for an index
  that appears several times, the last update (XLA:CPU applies the
  updates in order; ``tests/test_torch_mgm.py`` holds it).  Indices
  repeat only on an exact tie of two uniform draws; CUDA's
  ``index_put_`` has no fixed winner there, so :func:`_drop_index` keeps
  the last update of each index and sends the others, and the dropped
  rows, to a spare row past the end of every array it writes.
"""

from typing import NamedTuple, Tuple

import torch

from pydcop_tpu_torch.device import TorchFactorGraph
from pydcop_tpu_torch.ops import threefry
from pydcop_tpu_torch.ops.flush import ftz
from pydcop_tpu_torch.ops.localsearch import (
    assignment_cost,
    best_candidates,
    candidate_costs,
    current_of,
    neighbor_max,
    neighbor_min_rank_where,
    placed,
    random_best_choice,
    random_initial_values,
)
from pydcop_tpu_torch.utils import prng

NEG = -torch.inf


class Mgm2State(NamedTuple):
    values: torch.Tensor  # [V+1] int32
    key: prng.Words
    cycle: int


def init_state(graph: TorchFactorGraph, seed: int = 0) -> Mgm2State:
    key, k0 = prng.split_words(prng.key_words(seed))
    return Mgm2State(values=random_initial_values(k0, graph), key=key,
                     cycle=0)


def _fix_two_axes(costs: torch.Tensor, var_ids: torch.Tensor,
                  values: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """Reduce a bucket cost tensor [F, D^arity] to [F, Dp, Dq] by fixing
    every axis except p and q at its variable's current value."""
    index = [torch.arange(costs.shape[0], device=costs.device)]
    for a in range(var_ids.shape[1]):
        index.append(slice(None) if a in (p, q)
                     else values[var_ids[:, a]].long())
    out = costs[tuple(index)]          # remaining axes in original order
    return out.transpose(1, 2) if p > q else out


def _families(graph: TorchFactorGraph):
    """All ordered (bucket, p, q) position pairs — the directed edge
    families of the interaction graph."""
    for bucket in graph.buckets:
        arity = bucket.var_ids.shape[1]
        for p in range(arity):
            for q in range(arity):
                if p != q:
                    yield bucket, p, q


def _drop_index(idx: torch.Tensor, keep: torch.Tensor,
                n: int) -> torch.Tensor:
    """Indices for ``x.at[where(keep, idx, n)].set(v, mode="drop")`` on
    an array padded with one spare row ``n``: each index keeps its last
    kept update; every other row goes to ``n``."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device)
    last.scatter_reduce_(0, idx, torch.where(keep, pos, -1), "amax")
    return torch.where(keep & (last[idx] == pos), idx, n)


def mgm2_step(state: Mgm2State, graph: TorchFactorGraph, *,
              threshold: float, favor: str,
              lexic_ranks: torch.Tensor) -> Mgm2State:
    """One lockstep MGM2 cycle (all 5 phases)."""
    values = state.values
    dev = values.device
    n_seg = graph.var_costs.shape[0]
    sentinel = n_seg - 1
    dmax = graph.var_costs.shape[1]
    key, k_uni, k_offer, k_coin, k_fam = prng.split_words(state.key, 5)

    # ---- phase 1: unilateral best response ----------------------------
    cand = candidate_costs(graph, values)                  # [V+1, D]
    cur = current_of(cand, values)
    best, is_best = best_candidates(graph, cand)
    uni_gain = ftz(cur - best)                             # >= 0
    uni_prop = random_best_choice(k_uni, is_best)
    uni_value = torch.where(uni_gain > 0, uni_prop, values)
    g_delta = ftz(cur[:, None] - cand)                     # [V+1, D]

    is_offerer = ((threefry.uniform(k_offer, (n_seg,), dev) < threshold)
                  & (torch.arange(n_seg, device=dev) != sentinel))

    # ---- partner selection: random incident edge per offerer ---------
    fams = list(_families(graph))
    fam_keys = [prng.fold_in_words(k_fam, i) for i in range(len(fams))]
    scores = []
    score_max = torch.full((n_seg,), NEG, device=dev)
    for (bucket, p, q), fk in zip(fams, fam_keys):
        src, dst = bucket.var_ids[:, p], bucket.var_ids[:, q]
        real = (src != sentinel) & (dst != sentinel)
        s = torch.where(
            real & is_offerer[src],
            threefry.uniform(prng.fold_in_words(fk, 0), src.shape, dev),
            NEG)
        scores.append(s)
        score_max.scatter_reduce_(0, src, s, "amax")

    # ---- phases 2-3: offers, global gains, acceptance ----------------
    acc_best = torch.full((n_seg,), NEG, device=dev)
    fam_results = []
    for (bucket, p, q), fk, s in zip(fams, fam_keys, scores):
        src, dst = bucket.var_ids[:, p], bucket.var_ids[:, q]
        n_f = src.shape[0]
        chosen = torch.isfinite(s) & (s == score_max[src])
        t = _fix_two_axes(bucket.costs, bucket.var_ids, values, p, q)
        a_cur, b_cur = values[src].long(), values[dst].long()
        t_a = torch.gather(t, 2, b_cur[:, None, None].expand(
            n_f, dmax, 1)).squeeze(2)            # [F, D] T(da, b_cur)
        t_b = torch.gather(t, 1, a_cur[:, None, None].expand(
            n_f, 1, dmax)).squeeze(1)            # [F, D] T(a_cur, db)
        t_cur = torch.gather(t_a, 1, a_cur[:, None]).squeeze(1)
        # G(da,db) = gA(da) + gB(db) + T(da,b) + T(a,db) - T(a,b) - T(da,db)
        gain = ftz(g_delta[src][:, :, None] + g_delta[dst][:, None, :])
        gain = ftz(gain + t_a[:, :, None])
        gain = ftz(gain + t_b[:, None, :])
        gain = ftz(gain - t_cur[:, None, None])
        gain = ftz(gain - t)
        # Offer condition: the offerer's own local view strictly
        # improves.
        local_a = ftz(ftz(cand[src][:, :, None] - t_a[:, :, None]) + t)
        offer_ok = local_a < cur[src][:, None, None]
        valid = (graph.var_valid[src][:, :, None]
                 & graph.var_valid[dst][:, None, :])
        flat_g = torch.where(offer_ok & valid, gain, NEG).reshape(n_f, -1)
        best_g = flat_g.amax(dim=1)
        # Random choice among tied best joint moves.
        flat_pick = threefry.best_choice(prng.fold_in_words(fk, 1),
                                         flat_g == best_g[:, None])
        da, db = flat_pick // dmax, flat_pick % dmax
        # An offer reaches the acceptor only if the target is not
        # itself an offerer (offerers reject).
        offered = chosen & ~is_offerer[dst] & (best_g > 0)
        best_g = torch.where(offered, best_g, NEG)
        acc_best.scatter_reduce_(0, dst, best_g, "amax")
        fam_results.append((src, dst, best_g, da, db, offered))

    # Acceptor commit decision.
    has_offer = torch.isfinite(acc_best)
    if favor == "coordinated":
        tie_ok = torch.ones((n_seg,), dtype=torch.bool, device=dev)
    elif favor == "no":
        tie_ok = threefry.uniform(k_coin, (n_seg,), dev) > 0.5
    else:  # "unilateral"
        tie_ok = torch.zeros((n_seg,), dtype=torch.bool, device=dev)
    acc_commit = has_offer & (
        (acc_best > uni_gain) | ((acc_best == uni_gain) & tie_ok))

    # Pick ONE accepted edge per committed acceptor (random among
    # gain-ties), then set the pair state at both endpoints.  The arrays
    # carry a spare row n_seg for the dropped updates.
    partner = torch.full((n_seg + 1,), -1, dtype=torch.int32, device=dev)
    pair_gain = torch.full((n_seg + 1,), NEG, device=dev)
    pair_val = torch.zeros((n_seg + 1,), dtype=torch.int32, device=dev)
    committed = torch.zeros((n_seg + 1,), dtype=torch.bool, device=dev)
    win_max = torch.full((n_seg,), NEG, device=dev)
    fam_w = []
    for i, (src, dst, best_g, da, db, offered) in enumerate(fam_results):
        w = torch.where(
            offered & (best_g == acc_best[dst]) & acc_commit[dst],
            threefry.uniform(prng.fold_in_words(k_fam, 10_000 + i),
                             src.shape, dev),
            NEG)
        fam_w.append(w)
        win_max.scatter_reduce_(0, dst, w, "amax")
    fam_accepted = []
    for (src, dst, best_g, da, db, _), w in zip(fam_results, fam_w):
        accepted = torch.isfinite(w) & (w == win_max[dst])
        fam_accepted.append(accepted)
        i_s = _drop_index(src, accepted, n_seg)
        i_d = _drop_index(dst, accepted, n_seg)
        partner[i_s] = dst.to(torch.int32)
        partner[i_d] = src.to(torch.int32)
        pair_gain[i_s] = best_g
        pair_gain[i_d] = best_g
        pair_val[i_s] = da
        pair_val[i_d] = db
        committed.index_fill_(0, i_s, True)
        committed.index_fill_(0, i_d, True)
    partner, pair_gain = partner[:n_seg], pair_gain[:n_seg]
    committed = committed[:n_seg]

    # ---- phase 4: gain exchange --------------------------------------
    g = torch.where(committed, pair_gain, uni_gain)

    # Max neighbour gain excluding the partner.
    nmax_excl = torch.full((n_seg,), NEG, device=dev)
    for bucket, p, q in _families(graph):
        src, dst = bucket.var_ids[:, p], bucket.var_ids[:, q]
        contrib = torch.where(dst != partner[src], g[dst], NEG)
        nmax_excl.scatter_reduce_(0, src, contrib, "amax")

    # ---- phase 5: moves ----------------------------------------------
    can_move = committed & (g > nmax_excl)
    new_values = torch.cat([values, values[:1]])
    for (src, dst, _, da, db, _), accepted in zip(fam_results,
                                                  fam_accepted):
        go = accepted & can_move[src] & can_move[dst]
        new_values[_drop_index(src, go, n_seg)] = da
        new_values[_drop_index(dst, go, n_seg)] = db
    new_values = new_values[:n_seg]

    # Uncommitted unilateral winners.
    nmax_all = neighbor_max(graph, g)
    nrank = neighbor_min_rank_where(graph, g, g, lexic_ranks)
    uni_win = (
        ~committed & (uni_gain > 0)
        & ((uni_gain > nmax_all)
           | ((uni_gain == nmax_all) & (lexic_ranks < nrank))))
    new_values = torch.where(uni_win, uni_value, new_values)
    return Mgm2State(values=new_values, key=key, cycle=state.cycle + 1)


def run_mgm2(graph: TorchFactorGraph, max_cycles: int, *,
             threshold: float = 0.5, favor: str = "unilateral",
             lexic_ranks: torch.Tensor, seed: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Full MGM2 run (``lexic_ranks`` as for ``run_mgm``).  Returns
    (values [V], final cost, cycles)."""
    lexic_ranks = placed(graph, lexic_ranks)
    state = init_state(graph, seed)
    for _ in range(max_cycles):
        state = mgm2_step(state, graph, threshold=threshold, favor=favor,
                          lexic_ranks=lexic_ranks)
    cost = assignment_cost(graph, state.values)
    return state.values[:-1], cost, state.cycle
