"""The fused candidate-cost sum (``segment_sum.positional_table_sum``)
on the CPU, where it runs its plain version, against
``pydcop_tpu.ops.localsearch`` bit for bit.

``candidate_costs`` reads a binary bucket's contributions out of its
cost table (``TableUnit``) and sums every unit in one call; the plain
version copies the rows out as ``_fix_other_axes`` does and walks them
as ``positional_sum_reference`` does.  Held here, with real costs over
seven decades and the reference jitted with the graph as an argument:
``candidate_costs`` on mixed arity-2/3 graphs (with arity-1 buckets
beside them) at D in {1, 3, 5, 9}, every bit; ``unit_rows`` of a
``TableUnit`` equal to ``_fix_other_axes`` at both positions; the
fused entry equal to the contributions entry on the same rows; and the
wrapper's refusals, with no launch counted on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from pydcop_tpu.ops import localsearch as J
from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops import localsearch as T
from pydcop_tpu_torch.ops import segment_sum as S
from test_torch_localsearch import arrays, bits_equal, both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CANDIDATE_COSTS = jax.jit(J.candidate_costs)

# (V, [(arity, F)]) of the mixed graphs; units straddle V + 1.
MIXED = {
    "arity2_3": (150, [(2, 200), (3, 60)]),
    "arity1_2_3": (120, [(1, 50), (2, 150), (3, 40), (2, 20)]),
    "binary_only": (300, [(2, 500)]),
    "binary_merged": (300, [(2, 100)]),
}


def _values(seed, valid):
    rng = np.random.default_rng(seed)
    return np.array([rng.integers(0, int(row.sum()) or 1) for row in valid],
                    dtype=np.int32)


@pytest.mark.parametrize("d", [1, 3, 5, 9])
@pytest.mark.parametrize("name", list(MIXED))
def test_candidate_costs_through_the_fused_entry_equal(name, d):
    n_vars, sizes = MIXED[name]
    arr = arrays(d * 10 + len(sizes), n_vars, d, sizes)
    jg, tg = both(*arr, "scatter")
    assert tg.pos_other is not None         # the fused entry's graphs
    before = dict(_build.launch_counts)
    for s in range(2):
        values = _values(s, arr[1])
        bits_equal(T.candidate_costs(tg, torch.tensor(values)).numpy(),
                   CANDIDATE_COSTS(jg, values))
    assert dict(_build.launch_counts) == before


@pytest.mark.parametrize("d", [1, 3, 4])
def test_table_unit_rows_equal_fixed_axes(d):
    arr = arrays(5, 60, d, [(2, 80)])
    _, tg = both(*arr, "scatter")
    b = tg.buckets[0]
    values = torch.tensor(_values(3, arr[1]))
    for p in (0, 1):
        bits_equal(S.unit_rows(S.TableUnit(b.costs, b.var_ids, p),
                               values).numpy(),
                   T._fix_other_axes(b.costs, b.var_ids, values,
                                     p).numpy())


def test_fused_entry_equals_contributions_entry():
    arr = arrays(9, 100, 3, [(1, 40), (2, 150), (3, 30)])
    _, tg = both(*arr, "scatter")
    values = torch.tensor(_values(1, arr[1]))
    units = []
    for b in tg.buckets:
        if b.var_ids.shape[1] == 2:
            units += [S.TableUnit(b.costs, b.var_ids, p) for p in (0, 1)]
        else:
            units += [T._fix_other_axes(b.costs, b.var_ids, values, p)
                      for p in range(b.var_ids.shape[1])]
    units = [units[u] for u in tg.pos_order]
    args = (tg.pos_perm, tg.agg_offsets, tg.pos_units, tg.var_costs,
            tg.agg_tiles, tg.pos_sep, tg.pos_mid)
    fused = S.positional_table_sum(units, values, tg.pos_other, *args)
    rows = S.positional_sum([S.unit_rows(u, values) for u in units], *args)
    bits_equal(fused.numpy(), rows.numpy())


def test_fused_entry_refuses():
    arr = arrays(2, 40, 3, [(2, 60)])
    _, tg = both(*arr, "scatter")
    b = tg.buckets[0]
    units = [S.TableUnit(b.costs, b.var_ids, p) for p in (0, 1)]
    args = (tg.pos_perm, tg.agg_offsets, tg.pos_units, tg.var_costs)
    values = torch.zeros(41, dtype=torch.int32)
    with pytest.raises(ValueError):         # no values for table units
        S.positional_table_sum(units, None, tg.pos_other, *args)
    with pytest.raises(TypeError):          # values must be int32
        S.positional_table_sum(units, values.long(), tg.pos_other, *args)
    with pytest.raises(ValueError):         # a table of the wrong width
        S.positional_table_sum(
            [S.TableUnit(b.costs[:, :2, :2].contiguous(), b.var_ids, 0),
             units[1]], values, tg.pos_other, *args)
    with pytest.raises(ValueError):         # position 2 of a binary
        S.positional_table_sum([units[0], S.TableUnit(
            b.costs, b.var_ids, 2)], values, tg.pos_other, *args)


def test_units_out_of_xla_order_are_refused_without_sep():
    """Without ``sep`` the wrapper computes the fold and refuses units
    that XLA would add in another order (a one-edge unit it moves)."""
    arr = arrays(4, 20, 3, [(1, 60), (2, 1)])
    _, tg = both(*arr, "scatter")
    assert tg.pos_order == (1, 0, 2)
    units = [torch.zeros((n, 3)) for n in (60, 1, 1)]
    with pytest.raises(ValueError):
        S.positional_sum(units, tg.pos_perm, tg.agg_offsets, tg.pos_units,
                         tg.var_costs)
