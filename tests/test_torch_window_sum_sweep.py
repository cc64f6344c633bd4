"""Random graphs in the ranges of ROADMAP Queue C item 1's probe log,
against the jitted JAX reference on the CPU, bit for bit (uint32
views): the whole-graph totals at the local search's site
(``assignment_cost``) and MaxSum's (``assignment_constraint_cost``).

The log names graph seeds without their shapes (12, 1024, 1030 at
``localsearch``; 56, 1022, 1023, 1028, 1030 at ``maxsum``) and the
generator that drew them was not kept.  This file sweeps the one
``tests/test_torch_window_sum_context.py`` commits (``random_case``;
that file holds the named seeds) over its seeds 0-47 and 1000-1031 at
both sites, four cost draws each.  A graph whose order follows no rule
found is ``xfail(strict=True)`` with its bits.
"""

import pytest
import torch

from test_torch_window_sum_context import (
    LOGGED_SEEDS,
    differing,
    open_case,
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
OPEN_SWEEP = {
    ("maxsum", 11): (
        "V=12 D=1 [(2, 25), (3, 8), (4, 21)]: the ternary bucket of 8 "
        "factors in lanes beside neighbours of 21 and 25 factors (the "
        "rule found covers 2-8).  Draws 0, 2: ref 0x419ebded port "
        "0x419ebdef, ref 0xc947a056 port 0xc947a057"),
}


@pytest.mark.parametrize("site,seed", [
    pytest.param(site, seed, marks=open_case(OPEN_SWEEP[(site, seed)]))
    if (site, seed) in OPEN_SWEEP else (site, seed)
    for site, seed in SWEEP])
def test_random_graph(site, seed):
    n_vars, d, buckets = random_case(seed)
    g0 = skeleton(n_vars, buckets, d, seed)
    assert differing(site, g0, range(4)) == [], (n_vars, d, buckets)
