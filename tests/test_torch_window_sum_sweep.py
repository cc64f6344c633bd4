"""Random graphs in the ranges of ROADMAP Queue C item 1's probe log,
against the jitted JAX reference on the CPU, bit for bit (uint32
views): the whole-graph totals at the local search's site
(``assignment_cost``) and MaxSum's (``assignment_constraint_cost``).

The log names graph seeds without their shapes (12, 1024, 1030 at
``localsearch``; 56, 1022, 1023, 1028, 1030 at ``maxsum``) and the
generator that drew them was not kept.  This file sweeps the one
``tests/test_torch_window_sum_context.py`` commits (``random_case``;
that file holds the named seeds) over its seeds 0-47 and 1000-1031 at
both sites, four cost draws each.  Every graph holds (seed 11 at
``maxsum``, V=12 D=1 [(2, 25), (3, 8), (4, 21)], was open until the
rule for a bucket of 8 factors beside others was found:
``window_sum._eight_beside``).
"""

import pytest
import torch

from test_torch_window_sum_context import (
    LOGGED_SEEDS,
    differing,
    random_case,
)
from test_torch_window_sum_open_shapes import skeleton


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SWEEP = [(site, seed) for seed in list(range(48)) + list(range(1000, 1032))
         for site in ("localsearch", "maxsum")
         if (site, seed) not in LOGGED_SEEDS]
@pytest.mark.parametrize("site,seed", SWEEP)
def test_random_graph(site, seed):
    n_vars, d, buckets = random_case(seed)
    g0 = skeleton(n_vars, buckets, d, seed)
    assert differing(site, g0, range(4)) == [], (n_vars, d, buckets)
