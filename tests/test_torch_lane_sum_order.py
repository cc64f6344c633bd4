"""The lane layout's belief sum (pydcop_tpu_torch/ops/lane_sum.py) and
its placement arrays against the JAX package's lane aggregation, on the
CPU.

Tolerance: none.  Every comparison is bit-equality (``uint32`` views of
float32), the reference jitted with the graph as an argument:

- the row table [V+1, 2P] of ``lane_sum_table`` holds the reference's
  beliefs and sums (``aggregate_beliefs``), each half padded with zeros
  to ``row_floats(D)``, at D in {1, 2, 3, 8, 11, 28, 32, 33}, on graphs
  of one to four buckets with a hub above ``HEAVY_DEGREE``;
  ``lane_sum`` returns its halves as views;
- ``lane_beliefs`` holds the reference's beliefs where it keeps no sums
  (its scatters start from ``var_costs``);
- the placement array the kernel's walk reads: ``agg_heavy``, the
  variables of degree above ``HEAVY_DEGREE`` by degree, descending,
  placed by ``to_lane_device_graph``.
"""

import jax
import numpy as np
import pytest
import torch

from pydcop_tpu.ops import maxsum_lane as JL
from pydcop_tpu_torch.ops.lane_sum import (
    HEAVY_DEGREE,
    heavy_variables,
    lane_beliefs,
    lane_order,
    lane_sum,
    lane_sum_table,
    row_floats,
)
from test_torch_maxsum_lane import bits_equal, drawn_lane, msgs, port_lane, t


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


DOMAINS = [1, 2, 3, 8, 11, 28, 32, 33]


def hub_lane(d, seed):
    """A lane graph of up to four buckets whose variable 0 has more
    than HEAVY_DEGREE edges."""
    buckets = [(1, 5), (2, 90), (3, 6), (4, 2)] if d <= 8 else \
        [(1, 3), (2, 90)]
    lane = drawn_lane(30, buckets, d, seed, decades=(1, 3, 6)[seed % 3])
    out = []
    for b in lane.buckets:
        ids = np.array(b.var_ids)
        if ids.shape[0] == 2:
            ids[0, :80] = 0
            ids[1, :80] = np.where(ids[1, :80] == 0, 1, ids[1, :80])
        out.append(b._replace(var_ids=ids))
    return lane._replace(buckets=tuple(out))


@pytest.mark.parametrize("d", DOMAINS)
def test_table_holds_the_reference_beliefs_and_sums(d):
    lane = hub_lane(d, d)
    f2v = msgs(lane, d)
    rb, rs = jax.jit(JL.aggregate_beliefs)(lane, tuple(f2v))
    pg = port_lane(lane)
    args = (t(f2v), pg.agg_perm, pg.agg_offsets, pg.agg_buckets,
            pg.var_costs, pg.agg_heavy)
    table = lane_sum_table(*args)
    p = row_floats(d)
    assert table.shape == (lane.n_vars + 1, 2 * p)
    want = np.zeros(table.shape, np.float32)
    want[:, :d] = np.asarray(rb).T
    want[:, p:p + d] = np.asarray(rs).T
    bits_equal(want, table)
    beliefs, sums = lane_sum(*args)
    bits_equal(rb, beliefs)
    bits_equal(rs, sums)
    assert beliefs.data_ptr() == sums.data_ptr() - 4 * p


@pytest.mark.parametrize("d", DOMAINS)
def test_beliefs_without_sums_start_from_the_costs(d):
    lane = hub_lane(d, d + 1)
    f2v = msgs(lane, d + 1)
    ref = jax.jit(lambda g, m: JL.aggregate_beliefs(g, m)[0])(lane,
                                                               tuple(f2v))
    pg = port_lane(lane)
    got = lane_beliefs(t(f2v), pg.agg_perm, pg.agg_offsets,
                       pg.agg_buckets, pg.var_costs)
    bits_equal(ref, got)


@pytest.mark.parametrize("d", [3, 11])
def test_placement_arrays(d):
    lane = hub_lane(d, 5)
    pg = port_lane(lane)
    degree = np.diff(pg.agg_offsets.numpy())
    heavy = pg.agg_heavy.numpy()
    assert heavy.dtype == np.int32
    assert heavy.tolist() == sorted(
        np.flatnonzero(degree > HEAVY_DEGREE).tolist(),
        key=lambda v: (-degree[v], v))
    assert 0 in heavy.tolist()
    ids = [np.asarray(b.var_ids) for b in lane.buckets]
    perm, offsets, _ = lane_order(ids, lane.n_vars + 1)
    np.testing.assert_array_equal(perm, pg.agg_perm.numpy())
    # Several hubs: by degree, descending, ties by index.
    hubs = np.cumsum([0, HEAVY_DEGREE + 6, HEAVY_DEGREE + 36, 3,
                      HEAVY_DEGREE + 1, HEAVY_DEGREE + 36, HEAVY_DEGREE])
    assert heavy_variables(hubs).tolist() == [1, 4, 0, 3]
