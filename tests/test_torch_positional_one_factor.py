"""The local search's candidate-cost sum on graphs with one-factor
buckets, against ``pydcop_tpu.ops.localsearch`` on the CPU, bit for bit.

A bucket of one factor gives (bucket, position) units of one edge.  XLA
(jax 0.9.0, CPU) rewrites a scatter of one row into a
dynamic-update-slice after its fold of the reference's ``init + S(0, 0)
+ S(0, 1) + ...``, and that moves the row's add or changes how the next
unit is added (``segment_sum.positional_fold``, read from the optimised
HLO).  With real costs over seven decades a sum in another order
changes the bits, so every candidate cost is held with
``np.array_equal`` on the raw bits (the reference jitted with the graph
as an argument, as its engine does): over a grid of one-factor buckets
first, in the middle, last and two in a row, after units of more and of
fewer than V + 1 edges, arity 1-4 and D in {1, 2, 3, 4, 5, 8}, one-factor
buckets real or padding; over random graphs; and state by state through
40 cycles of DSA, MGM and MGM2 under ``scatter`` and ``ell``.  The
placement arrays of the positional order (``pos_order``, ``pos_units``,
``pos_sep``, the two-unit boundaries ``pos_mid`` and the binary
buckets' ``pos_other``) are held against numpy counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.ops import dsa as JD
from pydcop_tpu.ops import localsearch as J
from pydcop_tpu.ops import mgm as JM
from pydcop_tpu.ops import mgm2 as J2
from pydcop_tpu_torch.ops import dsa as TD
from pydcop_tpu_torch.ops import localsearch as T
from pydcop_tpu_torch.ops import mgm as TM
from pydcop_tpu_torch.ops import mgm2 as T2
from pydcop_tpu_torch.ops.segment_sum import (
    positional_fold,
    separate_buckets,
)
from test_torch_dsa import assert_same_state
from test_torch_localsearch import BIG, bits_equal, both, spread


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def one_factor_arrays(seed: int, n_vars: int, d: int, sizes,
                      pad_single: bool = False):
    """(var_costs, var_valid, [(costs, var_ids)]): ``sizes`` (arity, F)
    per bucket; a tenth of a larger bucket's rows (at least one) are
    padding on the sentinel, a one-factor bucket is a real factor (or
    padding with ``pad_single``); each variable's first 1..D slots
    valid, BIG costs elsewhere."""
    rng = np.random.default_rng(seed)
    dom = rng.integers(1, d + 1, size=n_vars)
    valid = np.zeros((n_vars + 1, d), bool)
    for i, k in enumerate(dom):
        valid[i, :k] = True
    var_costs = np.where(valid, spread(rng, (n_vars + 1, d)), BIG)
    var_costs[-1] = 0.0
    buckets = []
    for arity, f in sizes:
        ids = np.stack([rng.choice(n_vars, size=arity, replace=False)
                        for _ in range(f)]).astype(np.int32)
        if f > 1 or pad_single:
            ids[f - max(1, f // 10):] = n_vars
        buckets.append((spread(rng, (f,) + (d,) * arity), ids))
    return var_costs.astype(np.float32), valid, buckets


def current_values(seed: int, valid: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.array([rng.integers(0, int(row.sum()) or 1) for row in valid],
                    dtype=np.int32)


CANDIDATE_COSTS = jax.jit(J.candidate_costs)

# (label, sizes) at V = 20 (V + 1 = 21 rows): one-factor buckets after a
# unit of at least V + 1 edges and after one of fewer, first, in the
# middle, last and two in a row, of arity 1-4.
V = 20
ONE_FACTOR_SHAPES = [
    ("after_large", [(1, 60), (2, 1)]),
    ("after_large_binary", [(2, 30), (1, 1), (2, 25)]),
    ("after_small", [(1, 5), (1, 1), (1, 30)]),
    ("after_small_merged", [(2, 30), (1, 1), (2, 15)]),
    ("first", [(1, 1), (2, 30)]),
    ("first_binary", [(2, 1), (1, 40)]),
    ("middle", [(1, 30), (1, 30), (1, 1), (1, 30), (1, 30), (1, 30)]),
    ("last", [(1, 30), (1, 30), (1, 30), (1, 1)]),
    ("two_in_a_row", [(1, 30), (1, 1), (1, 1)]),
    ("two_apart", [(1, 30), (1, 1), (1, 30), (1, 1)]),
    ("after_update", [(1, 30), (1, 30), (1, 1), (1, 30), (1, 1)]),
    ("arity3", [(3, 12), (3, 1), (2, 20)]),
    ("arity4", [(4, 8), (4, 1), (1, 25), (4, 1)]),
    ("arity4_first", [(4, 1), (3, 10)]),
]
DS = [1, 2, 3, 4, 5, 8]


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("label,sizes", ONE_FACTOR_SHAPES,
                         ids=[s[0] for s in ONE_FACTOR_SHAPES])
def test_one_factor_candidate_costs_equal(label, sizes, d):
    for seed, pad in ((d, False), (d + 100, True)):
        arr = one_factor_arrays(seed, V, d, sizes, pad_single=pad)
        jg, tg = both(*arr, "scatter")
        for s in range(2):
            values = current_values(seed + s, arr[1])
            ref = CANDIDATE_COSTS(jg, values)
            bits_equal(T.candidate_costs(tg, torch.tensor(values)).numpy(),
                       ref)


@pytest.mark.parametrize("label,sizes", ONE_FACTOR_SHAPES[:6],
                         ids=[s[0] for s in ONE_FACTOR_SHAPES[:6]])
def test_one_factor_candidate_costs_equal_with_ell(label, sizes):
    arr = one_factor_arrays(3, V, 3, sizes)
    jg, tg = both(*arr, "ell")
    values = current_values(4, arr[1])
    bits_equal(T.candidate_costs(tg, torch.tensor(values)).numpy(),
               CANDIDATE_COSTS(jg, values))


@pytest.mark.parametrize("block", range(8))
def test_random_graphs_with_one_factor_buckets_equal(block):
    """Random bucket lists of arity 1-4, one-factor buckets common, unit
    sizes around V + 1, D in {1, 2, 3, 4, 5, 8}."""
    rng = np.random.default_rng(1000 + block)
    for trial in range(12):
        n_vars = int(rng.choice([4, 10, 20, 40]))
        d = int(rng.choice(DS))
        sizes = []
        for _ in range(int(rng.integers(1, 6))):
            arity = min(int(rng.integers(1, 5 if d <= 5 else 3)), n_vars)
            f = int(rng.choice([1, 1, 1, 2, 3, n_vars // 2, n_vars,
                                n_vars + 1, 2 * n_vars, 3 * n_vars]))
            sizes.append((arity, max(f, 1)))
        arr = one_factor_arrays(block * 100 + trial, n_vars, d, sizes)
        jg, tg = both(*arr, "scatter")
        values = current_values(trial, arr[1])
        bits_equal(T.candidate_costs(tg, torch.tensor(values)).numpy(),
                   CANDIDATE_COSTS(jg, values))


def test_fold_of_the_probed_hlo():
    """The orders read from the optimised HLO at V + 1 = 21 (unit sizes
    in (bucket, position) order)."""
    # A one-edge unit summed on its own moves before the running scatter.
    assert positional_fold([60, 1, 1], 21) == ((1, 0, 2), 0)
    assert positional_fold([30, 1, 30, 1], 21) == ((1, 3, 0, 2), 0)
    # One scattered into the sum makes the next unit scattered into it.
    assert positional_fold([30, 30, 1, 30, 30, 30], 21) == (
        (0, 1, 2, 3, 4, 5), 0b100010)
    assert positional_fold([1, 30], 21) == ((0, 1), 0)
    # Merged into a scatter of more edges, nothing changes.
    assert positional_fold([30, 30, 1, 15, 15], 21) == (
        (0, 1, 2, 3, 4), 0b10010)
    # Without one-edge units it is separate_buckets' fold.
    sizes = [30, 30, 30, 30, 5, 5]
    starts = np.cumsum([0] + sizes).tolist()
    assert positional_fold(sizes, 21) == (tuple(range(6)),
                                          separate_buckets(starts, 21))


@pytest.mark.parametrize("sizes", [[(2, 60)], [(2, 8)], [(1, 30), (2, 1)],
                                   [(2, 25), (3, 10), (2, 1)]])
def test_positional_placement_arrays(sizes):
    """pos_order / pos_units / pos_perm follow positional_fold; pos_mid
    is where each variable's second-unit edges start (two units);
    pos_other is the other variable of each binary slot."""
    arr = one_factor_arrays(7, V, 3, sizes)
    _, tg = both(*arr, "scatter")
    cols = [ids[:, p] for _, ids in arr[2] for p in range(ids.shape[1])]
    order, sep = positional_fold([c.shape[0] for c in cols], V + 1)
    assert tg.pos_order == order and tg.pos_sep == sep
    seg = np.concatenate([cols[u] for u in order])
    perm = np.argsort(seg, kind="stable")
    np.testing.assert_array_equal(tg.pos_perm.numpy(), perm)
    np.testing.assert_array_equal(
        tg.pos_units.numpy(),
        np.cumsum([0] + [cols[u].shape[0] for u in order]))
    offsets = tg.agg_offsets.numpy()
    if len(cols) == 2:
        first = cols[order[0]]
        mid = [offsets[v] + int((first == v).sum()) for v in range(V + 1)]
        np.testing.assert_array_equal(tg.pos_mid.numpy(), mid)
        for v in range(V + 1):      # the slots before mid are unit 0's
            slots = tg.pos_perm.numpy()[offsets[v]:offsets[v + 1]]
            assert ((slots < first.shape[0])
                    == (np.arange(offsets[v], offsets[v + 1])
                        < mid[v])).all()
    else:
        assert tg.pos_mid is None
    units = [(ids, p) for _, ids in arr[2] for p in range(ids.shape[1])]
    other_of = np.concatenate([
        ids[:, 1 - p] if ids.shape[1] == 2 else np.zeros(len(ids), np.int32)
        for ids, p in (units[u] for u in order)])
    np.testing.assert_array_equal(tg.pos_other.numpy(), other_of[perm])


def lexic(n: int) -> np.ndarray:
    ranks = np.arange(n, dtype=np.float32)
    ranks[-1] = np.inf
    return ranks


SOLVE_SHAPES = {
    "one_factor_mixed": (30, 3, [(1, 40), (2, 1), (2, 45), (3, 1),
                                 (1, 1)]),
    "one_factor_binary": (24, 4, [(2, 1), (2, 40), (1, 1), (2, 1)]),
}


def solve_pair(name, aggregation):
    n_vars, d, sizes = SOLVE_SHAPES[name]
    arr = one_factor_arrays(len(sizes), n_vars, d, sizes)
    return both(*arr, aggregation)


CYCLES = 40


@pytest.mark.parametrize("aggregation", ["scatter", "ell"])
@pytest.mark.parametrize("name", list(SOLVE_SHAPES))
@pytest.mark.parametrize("variant", ["A", "B", "C"])
def test_dsa_with_one_factor_buckets_equal_every_step(name, aggregation,
                                                      variant):
    jg, tg = solve_pair(name, aggregation)
    jstate, tstate = JD.init_state(jg, 3), TD.init_state(tg, 3)
    step = jax.jit(lambda s, g: JD.dsa_step(s, g, variant=variant,
                                            probability=0.7))
    moved = 0
    for _ in range(CYCLES):
        before = tstate.values.clone()
        jstate = step(jstate, jg)
        tstate = TD.dsa_step(tstate, tg, variant=variant, probability=0.7)
        assert_same_state(tstate, jstate)
        moved += int((tstate.values != before).sum())
    assert moved > 0


@pytest.mark.parametrize("aggregation", ["scatter", "ell"])
@pytest.mark.parametrize("name", list(SOLVE_SHAPES))
def test_mgm_with_one_factor_buckets_equal_every_step(name, aggregation):
    jg, tg = solve_pair(name, aggregation)
    ranks = lexic(jg.var_costs.shape[0])
    jstate, tstate = JM.init_state(jg, 5), TM.init_state(tg, 5)
    step = jax.jit(lambda s, g: JM.mgm_step(
        s, g, lexic_ranks=jnp.asarray(ranks), break_mode="lexic"))
    for _ in range(CYCLES):
        jstate = step(jstate, jg)
        tstate = TM.mgm_step(tstate, tg, lexic_ranks=torch.tensor(ranks),
                             break_mode="lexic")
        assert_same_state(tstate, jstate)


@pytest.mark.parametrize("favor", ["unilateral", "no", "coordinated"])
@pytest.mark.parametrize("name", list(SOLVE_SHAPES))
def test_mgm2_with_one_factor_buckets_equal_every_step(name, favor):
    jg, tg = solve_pair(name, "scatter")
    ranks = lexic(jg.var_costs.shape[0])
    jstate, tstate = J2.init_state(jg, 9), T2.init_state(tg, 9)
    step = jax.jit(lambda s, g: J2.mgm2_step(
        s, g, threshold=0.5, favor=favor, lexic_ranks=jnp.asarray(ranks)))
    for _ in range(CYCLES):
        jstate = step(jstate, jg)
        tstate = T2.mgm2_step(tstate, tg, threshold=0.5, favor=favor,
                              lexic_ranks=torch.tensor(ranks))
        assert_same_state(tstate, jstate)
