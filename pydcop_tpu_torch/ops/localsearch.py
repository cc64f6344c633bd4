"""Batched local-search reductions over the placed factor graph.

Port of ``pydcop_tpu/ops/localsearch.py``, the shared reductions of the
constraints-hypergraph family (dsa, adsa, dsatuto, mgm, mgm2): one BSP
cycle has every variable evaluate its candidate values against its
neighbours' previous-cycle values.

- :func:`candidate_costs`: per variable and candidate value, its own
  unary cost plus every incident constraint with the other variables
  fixed at their current values, summed in the reference's order (see
  :func:`positional_sum`), so the card gives the CPU's and the
  reference's bits.  On the card one launch reads a binary bucket's
  fixed rows out of its cost table (``segment_sum.positional_table_sum``);
  other arities' fixed tables are gathers first.
- :func:`neighbor_max` / :func:`neighbor_min_rank_where`: the
  neighbourhood max and the tie-breaking rank min, excluding the
  variable itself.  Max and min need no order: each is one
  ``scatter_reduce_`` per bucket over the per-edge values (with
  ``graph.agg_ell`` set, a dense gather through the ELL lists).
- :func:`random_best_choice` / :func:`random_initial_values`: uniform
  choices among True slots, the hand kernel ``ops/threefry.py`` on the
  card, with keys given as host words (``utils/prng.py``).

Values are int32 as the reference's (its state compares equal); they
are cast to int64 where they index.  Every float operation whose result
the reference's XLA:CPU would flush is followed by ``ftz``.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.device import TorchFactorGraph
from pydcop_tpu_torch.ops import segment_sum as _segment_sum
from pydcop_tpu_torch.ops import threefry
from pydcop_tpu_torch.ops.ell import gather_reduce
from pydcop_tpu_torch.ops.flush import ftz
from pydcop_tpu_torch.utils.prng import Words


def placed(graph: TorchFactorGraph, x):
    """``x`` on the graph's device when it is a numpy array (a copy),
    else ``x`` as it is: the per-variable arrays of a solve (p_mode
    probabilities, colour classes, lexical ranks) are placed once,
    before its loop."""
    if isinstance(x, np.ndarray):
        return torch.tensor(x, device=graph.var_costs.device)
    return x


def _fix_other_axes(costs: torch.Tensor, var_ids: torch.Tensor,
                    values: torch.Tensor, keep: int) -> torch.Tensor:
    """Reduce a bucket cost tensor [F, D, ..., D] to [F, D] by indexing
    every axis except ``keep`` with the current value of its variable."""
    index: List = [torch.arange(costs.shape[0], device=costs.device)]
    for q in range(var_ids.shape[1]):
        index.append(slice(None) if q == keep
                     else values[var_ids[:, q]].long())
    return costs[tuple(index)]


def _position_tables(graph: TorchFactorGraph,
                     values: torch.Tensor) -> List[torch.Tensor]:
    """Per bucket, the fixed tables of every position, [F, arity, D]."""
    return [torch.stack([
        _fix_other_axes(b.costs, b.var_ids, values, p)
        for p in range(b.var_ids.shape[1])], dim=1)
        for b in graph.buckets]


def positional_sum(graph: TorchFactorGraph, per_bucket: Sequence,
                   init: torch.Tensor) -> torch.Tensor:
    """``init`` [V+1, D] plus, per variable, the sum of its incident
    (bucket, position, factor) contributions, in the reference's order.

    Without ELL lists ``per_bucket`` holds one position-major
    [arity, F, D] tensor per bucket (the reference's [F, arity, D]
    transposed, so that each (bucket, position) unit is contiguous) and
    the sum is ``segment_sum.positional_sum``, the hand kernel on the
    card: XLA rewrites the reference's ``init + S(0, 0) + S(0, 1) +
    ...`` into one running sum from ``init``, with the units in the
    order and merged or summed on their own as
    ``segment_sum.positional_fold`` says (``graph.pos_order``,
    ``graph.pos_sep``).  With ``graph.agg_ell`` set it holds
    [F, arity, D] tensors and the sum is ``init + gather_reduce`` (the
    ELL order of MaxSum's aggregation), flushed."""
    if not per_bucket:
        return init
    if graph.agg_ell is not None:
        return _ell_sum(graph, per_bucket, init)
    return unit_sum(graph, [v.unbind(0) for v in per_bucket], init)


def unit_sum(graph: TorchFactorGraph, per_bucket: Sequence,
             init: torch.Tensor, ell: bool = True) -> torch.Tensor:
    """:func:`positional_sum` of per-position columns: ``per_bucket``
    holds, per bucket, its positions' [F, D] contributions in position
    order.  Without ELL lists (or with ``ell=False``: a caller whose
    reference scatters even when ELL lists are compiled) it is one
    launch of ``segment_sum.positional_sum``, the units in
    ``graph.pos_order``; else ``init + gather_reduce``."""
    if not per_bucket:
        return init
    if ell and graph.agg_ell is not None:
        return _ell_sum(graph, [torch.stack(list(cols), dim=1)
                                for cols in per_bucket], init)
    units = [u for cols in per_bucket for u in cols]
    return _segment_sum.positional_sum(
        [units[u] for u in graph.pos_order], graph.pos_perm,
        graph.agg_offsets, graph.pos_units, init, graph.agg_tiles,
        graph.pos_sep, graph.pos_mid)


def _ell_sum(graph: TorchFactorGraph, per_bucket, init: torch.Tensor
             ) -> torch.Tensor:
    """``init + gather_reduce`` of the [F, arity, D] ``per_bucket``
    through the ELL lists, flushed."""
    d = init.shape[1]
    flats = [v.reshape(-1, d) for v in per_bucket]
    flat = flats[0] if len(flats) == 1 else torch.cat(flats)
    return ftz(init + gather_reduce(graph.agg_ell, flat,
                                    n_buckets=len(per_bucket)))


def _edge_flat(per_bucket) -> torch.Tensor:
    """Concatenate per-bucket [F, arity] edge values into the flat [E]
    (bucket, factor, position) order the ELL lists index."""
    flats = [v.reshape(-1) for v in per_bucket]
    return flats[0] if len(flats) == 1 else torch.cat(flats)


def _reduce_edges(graph: TorchFactorGraph, per_bucket, fill,
                  reduce: str, ell: bool = True) -> torch.Tensor:
    """[V+1]: per variable, the max or min (``reduce``) of the
    per-edge scalars of its incident slots (``per_bucket``: one
    [F, arity] tensor per bucket), ``fill`` where it has none; through
    the ELL lists when the graph has them and ``ell`` (whose sentinel
    row lists no edge: ``fill`` there, where a scatter reduces the
    padding rows)."""
    n_seg = graph.var_costs.shape[0]
    if ell and graph.agg_ell is not None:
        return gather_reduce(graph.agg_ell, _edge_flat(per_bucket),
                             fill=fill, reduce=reduce)
    out = torch.full((n_seg,), fill, dtype=per_bucket[0].dtype,
                     device=graph.var_costs.device)
    op = "amax" if reduce == "max" else "amin"
    for b, vals in zip(graph.buckets, per_bucket):
        out.scatter_reduce_(0, b.var_ids.reshape(-1), vals.reshape(-1), op)
    return out


def positional_max(graph: TorchFactorGraph, per_bucket, fill,
                   ell: bool = True) -> torch.Tensor:
    """[V+1]: per variable, max over its incident (bucket, factor,
    position) slots of per-edge scalars (``per_bucket``: one [F, arity]
    tensor per bucket); ``fill`` for variables with no incident slots
    (and below every value: the reference's maximum with ``fill``).
    ``ell=False`` scatters even on a graph with ELL lists."""
    if not per_bucket:
        return torch.full((graph.var_costs.shape[0],), fill,
                          device=graph.var_costs.device)
    return _reduce_edges(graph, per_bucket, fill, "max", ell)


def candidate_costs(graph: TorchFactorGraph,
                    values: torch.Tensor) -> torch.Tensor:
    """[V+1, D]: cost of each candidate value per variable, given all
    other variables at ``values`` (includes own unary costs).

    Without ELL lists it is one launch of
    ``segment_sum.positional_table_sum`` (the plain version on the CPU)
    over the units in ``graph.pos_order``: a binary bucket's two
    positions are read out of its cost table at ``values`` where it
    lies, an arity-1 bucket's costs are its contributions as they are,
    and other arities' fixed tables are gathered first
    (``_fix_other_axes``)."""
    if not graph.buckets:
        return graph.var_costs
    if graph.agg_ell is not None:
        return _ell_sum(graph, _position_tables(graph, values),
                        graph.var_costs)
    units: List = []
    for b in graph.buckets:
        arity = b.var_ids.shape[1]
        if arity == 2:
            units += [_segment_sum.TableUnit(b.costs, b.var_ids, p)
                      for p in (0, 1)]
        elif arity == 1:
            units.append(b.costs)
        else:
            units += [_fix_other_axes(b.costs, b.var_ids, values, p)
                      for p in range(arity)]
    units = [units[u] for u in graph.pos_order]
    args = (graph.pos_perm, graph.agg_offsets, graph.pos_units,
            graph.var_costs, graph.agg_tiles, graph.pos_sep, graph.pos_mid)
    if graph.pos_other is None:
        return _segment_sum.positional_sum(units, *args)
    return _segment_sum.positional_table_sum(units, values,
                                             graph.pos_other, *args)


def factor_current_costs(graph: TorchFactorGraph,
                         values: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per bucket: [F] cost of each factor at the current assignment."""
    out = []
    for b in graph.buckets:
        index = [torch.arange(b.costs.shape[0], device=b.costs.device)]
        index += [values[b.var_ids[:, q]].long()
                  for q in range(b.var_ids.shape[1])]
        out.append(b.costs[tuple(index)])
    return tuple(out)


def assignment_cost(graph: TorchFactorGraph,
                    values: torch.Tensor) -> torch.Tensor:
    """Scalar float32 total cost (constraints + unary) of the
    assignment; ``values`` is the full [V+1] array (sentinel row
    excluded from the unary costs; padding factors cost 0).  The sums
    run in float64 and round once, so they can differ from the
    reference's float32 ``jnp.sum`` in its last bits (its reduction
    order is XLA's); the solve's ``cost`` is computed on the host."""
    unary = torch.gather(graph.var_costs[:-1], 1,
                         values[:-1, None].long()).squeeze(1)
    total = unary.sum(dtype=torch.float64)
    for costs in factor_current_costs(graph, values):
        total = total + costs.sum(dtype=torch.float64)
    return total.to(torch.float32)


def _others(vals: torch.Tensor, p: int, combine, fill) -> torch.Tensor:
    """Combine columns q != p of [F, arity] ``vals``; ``fill`` for a
    unary factor (no co-variable)."""
    cols = [vals[:, q] for q in range(vals.shape[1]) if q != p]
    if not cols:
        return torch.full(vals.shape[:1], fill, dtype=vals.dtype,
                          device=vals.device)
    out = cols[0]
    for c in cols[1:]:
        out = combine(out, c)
    return out


def neighbor_max(graph: TorchFactorGraph,
                 per_var: torch.Tensor) -> torch.Tensor:
    """[V+1]: max of float ``per_var`` over each variable's neighbours
    (variables sharing a constraint), excluding the variable itself;
    -inf without neighbours."""
    per_bucket = []
    for b in graph.buckets:
        vals = per_var[b.var_ids]                     # [F, arity]
        per_bucket.append(torch.stack([
            _others(vals, p, torch.maximum, -torch.inf)
            for p in range(vals.shape[1])], dim=1))
    if not per_bucket:
        return torch.full(per_var.shape, -torch.inf, dtype=per_var.dtype,
                          device=per_var.device)
    return _reduce_edges(graph, per_bucket, -torch.inf, "max")


def neighbor_min_rank_where(graph: TorchFactorGraph,
                            per_var: torch.Tensor, target: torch.Tensor,
                            ranks: torch.Tensor) -> torch.Tensor:
    """[V+1]: min rank among neighbours whose ``per_var`` equals the
    variable's ``target`` value (+inf when none) — MGM tie-breaking.
    ``ranks`` is float32 (lexical index or per-cycle random draws)."""
    per_bucket = []
    for b in graph.buckets:
        pv, rk, tgt = per_var[b.var_ids], ranks[b.var_ids], target[b.var_ids]
        cols = []
        for p in range(pv.shape[1]):
            m = None
            for q in range(pv.shape[1]):
                if q != p:
                    c = torch.where(pv[:, q] == tgt[:, p], rk[:, q],
                                    torch.inf)
                    m = c if m is None else torch.minimum(m, c)
            cols.append(m if m is not None else torch.full(
                pv.shape[:1], torch.inf, device=pv.device))
        per_bucket.append(torch.stack(cols, dim=1))
    if not per_bucket:
        return torch.full(per_var.shape, torch.inf, dtype=torch.float32,
                          device=per_var.device)
    return _reduce_edges(graph, per_bucket, torch.inf, "min")


def factor_valid_masks(graph: TorchFactorGraph
                       ) -> Tuple[torch.Tensor, ...]:
    """Per bucket: [F, D^arity] bool — the valid region of each factor's
    cost table (outer product of its variables' valid domain slots).
    Padding rows point at the all-invalid sentinel row, so their region
    is empty."""
    out = []
    for b in graph.buckets:
        n_f, arity = b.var_ids.shape
        valid = torch.ones((n_f,), dtype=torch.bool,
                           device=b.costs.device)
        for q in range(arity):
            vq = graph.var_valid[b.var_ids[:, q]]      # [F, D]
            shape = (n_f,) + (1,) * q + (vq.shape[1],)
            valid = valid[..., None] & vq.reshape(shape)
        out.append(valid)
    return tuple(out)


def factor_min_over_valid(bucket, valid: torch.Tensor) -> torch.Tensor:
    """[F]: each factor's min cost over its valid region (+inf when
    empty — padding rows)."""
    masked = torch.where(valid, bucket.costs, torch.inf)
    return masked.reshape(masked.shape[0], -1).amin(dim=1)


def factor_max_over_valid(bucket, valid: torch.Tensor) -> torch.Tensor:
    """[F]: each factor's max cost over its valid region (-inf when
    empty)."""
    masked = torch.where(valid, bucket.costs, -torch.inf)
    return masked.reshape(masked.shape[0], -1).amax(dim=1)


def current_of(cand: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """[V+1]: each row of ``cand`` at the variable's current value."""
    return torch.gather(cand, 1, values[:, None].long()).squeeze(1)


def neighborhood_winners(graph: TorchFactorGraph, cand: torch.Tensor,
                         values: torch.Tensor, key: Words,
                         ranks: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]:
    """Shared evaluate → propose → tie-break step of the MGM family.
    Given per-candidate costs ``cand`` [V+1, D], returns (improve,
    proposed, nmax, wins): the current cost minus the best candidate
    cost (>= 0); a uniform-random choice among the best candidates
    under ``key``; the max improvement among neighbours; and whether the
    variable's improvement is the strict neighbourhood max, the smallest
    ``ranks`` winning ties."""
    cur = current_of(cand, values)
    best, is_best = best_candidates(graph, cand)
    improve = ftz(cur - best)
    proposed = random_best_choice(key, is_best)
    nmax = neighbor_max(graph, improve)
    nrank = neighbor_min_rank_where(graph, improve, improve, ranks)
    wins = (improve > nmax) | ((improve == nmax) & (ranks < nrank))
    return improve, proposed, nmax, wins


def best_candidates(graph: TorchFactorGraph, cand: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_cost [V+1], is_best [V+1, D]) over valid domain slots."""
    masked = torch.where(graph.var_valid, cand, torch.inf)
    best = masked.amin(dim=1)
    return best, masked == best[:, None]


def random_best_choice(key: Words, is_best: torch.Tensor) -> torch.Tensor:
    """Uniform random choice among True slots per row ([N] int32) —
    the reference's random.choice(best_values) — drawn under ``key``
    (host words) by ``threefry.best_choice``."""
    return threefry.best_choice(key, is_best)


def random_initial_values(key: Words,
                          graph: TorchFactorGraph) -> torch.Tensor:
    """Random valid value per variable ([V+1] int32, sentinel row 0)."""
    return threefry.best_choice(key, graph.var_valid)
