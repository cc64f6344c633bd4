"""The rule for a bucket of 8 factors beside other buckets
(``window_sum._eight_beside``), pinned by a grid against the jitted JAX
reference on the CPU, bit for bit (uint32 views).

Alone, such a bucket's gathered costs are summed left to right at these
shapes; in the reference's fusion LLVM's SLP vectoriser takes the 8
values as one vector (lanes of 4 or 8 give the same bits) when enough
other direct sums (2-32 values) share the straight block.  Read from
the optimised IR (the 8-value ``llvm.vector.reduce.fadd`` appears or
not) and the sums' bits over six cost draws: counting each direct-sum
bucket by its arity (8-ary ones not at ``maxsum``) and, at the local
search's site, the variable costs as 1 when V <= 32, a ternary bucket
goes in lanes at ``maxsum`` with D = 1 from a count of 2, at
``localsearch`` from 3 with D >= 3; a 4-ary one from 2 and a 5-ary one
from 1 with D = 2.  Each case asserts the form the rule gives and that
the port's totals equal the reference's.
"""

import pytest
import torch

from pydcop_tpu_torch.ops.window_sum import gather_stages
from test_torch_window_sum_context import differing
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


# (site, V, D, arity of the 8-factor bucket, neighbours, in lanes?)
CASES = [
    # Local search, ternary, D >= 3: the variable costs count while V <= 32.
    ("localsearch", 12, 3, 3, [(2, 1)], False),
    ("localsearch", 12, 3, 3, [(2, 2)], True),
    ("localsearch", 12, 3, 3, [(2, 24)], True),
    ("localsearch", 12, 3, 3, [(2, 32)], True),
    ("localsearch", 12, 3, 3, [(2, 33)], False),
    ("localsearch", 12, 3, 3, [(1, 20), (2, 40)], False),
    ("localsearch", 12, 3, 3, [(1, 2), (2, 2)], True),
    ("localsearch", 20, 4, 3, [(2, 16)], True),
    ("localsearch", 20, 3, 3, [(2, 40)], False),
    ("localsearch", 33, 3, 3, [(1, 20)], False),
    ("localsearch", 33, 3, 3, [(1, 1), (2, 16)], False),
    ("localsearch", 33, 3, 3, [(4, 2)], True),
    ("localsearch", 33, 3, 3, [(1, 20), (2, 16)], True),
    ("localsearch", 40, 4, 3, [(2, 16)], False),
    ("localsearch", 40, 4, 3, [(1, 20), (2, 16)], True),
    ("localsearch", 80, 3, 3, [(1, 20), (2, 16)], True),
    ("localsearch", 80, 3, 3, [(1, 24), (4, 16)], True),
    ("localsearch", 80, 3, 3, [(1, 33), (2, 2)], False),
    # Local search, D = 2: ternary never; 4-ary from 2; 5-ary from 1.
    ("localsearch", 12, 2, 3, [(2, 16)], False),
    ("localsearch", 12, 2, 4, [(1, 20)], True),
    ("localsearch", 40, 2, 4, [(2, 16)], True),
    ("localsearch", 40, 2, 4, [(1, 20)], False),
    ("localsearch", 40, 2, 4, [(2, 40)], False),
    ("localsearch", 20, 2, 5, [(2, 40)], True),
    ("localsearch", 40, 2, 5, [(1, 20)], True),
    ("localsearch", 40, 2, 5, [(2, 40)], False),
    # MaxSum, ternary, D = 1.
    ("maxsum", 12, 1, 3, [(2, 1)], False),
    ("maxsum", 12, 1, 3, [(2, 21)], True),
    ("maxsum", 20, 1, 3, [(2, 31)], True),
    ("maxsum", 40, 1, 3, [(2, 33)], False),
    ("maxsum", 12, 1, 3, [(4, 12)], True),
    ("maxsum", 80, 1, 3, [(4, 24)], True),
    ("maxsum", 12, 1, 3, [(1, 20)], False),
    ("maxsum", 12, 1, 3, [(8, 8)], False),
    ("maxsum", 12, 1, 3, [(6, 24)], True),
    ("maxsum", 12, 1, 3, [(2, 1), (4, 1)], False),
]


@pytest.mark.parametrize("site,n_vars,d,arity,near,lanes", CASES)
def test_eight_factors_beside_others(site, n_vars, d, arity, near, lanes):
    context = near + ([(0, n_vars)] if site == "localsearch" else [])
    form = gather_stages(site, arity, d, 8, near=context)
    assert (form != ()) == lanes
    g0 = skeleton(n_vars, sorted(near + [(arity, 8)]), d, 3)
    assert differing(site, g0, range(6)) == []
