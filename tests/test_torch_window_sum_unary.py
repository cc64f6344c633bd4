"""The rule for a unary sum beside other buckets, pinned by grids
against the jitted JAX reference on the CPU, bit for bit (uint32 views):
the local search's variable costs and a unary bucket (at both sites)
take lanes from 22 values at D = 2 and from 20 at D >= 3 (25 and 22
alone) when the other buckets of 2-32 factors, summed in the same loop
fusion, have arities adding up to 5 or more (at ``maxsum`` 8-ary ones do
not count) (``window_sum.gather_stages``, ``near``; the other rules:
``tests/test_torch_window_sum_neighbours.py``).  Each grid also holds
the neighbours that leave the form alone.
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


UNARY_NEAR = [[(5, 8)], [(6, 20)], [(8, 4)], [(4, 16)], [(2, 16), (3, 8)],
              [(2, 23), (3, 24)], [(2, 23), (4, 16)], [(2, 16), (4, 40)],
              [(1, 8), (4, 16)]]


def unary_cases():
    for site in ("localsearch", "maxsum"):
        for d in (2, 3):
            for near in UNARY_NEAR:
                # Beside [(2, 16), (3, 8)] at the local search's site
                # with D = 3 the ternary bucket of 8 factors goes in
                # lanes too (window_sum._eight_beside).
                yield near, d, site


@pytest.mark.parametrize("near,d,site", unary_cases())
def test_unary_bucket_beside_others(near, d, site):
    """A unary bucket of 20, 22 and 24 factors (80 variables)."""
    direct = sum(a for a, m in near if 2 <= m <= 32
                 and not (site == "maxsum" and a == 8))
    first = (22 if d == 2 else 20) if direct >= 5 else (
        25 if d == 2 else 22)
    for n in (20, 22, 24):
        if (1, n) in near:
            continue
        assert (gather_stages(site, 1, d, n, near=near) != ()) == (
            n >= first)
        g0 = skeleton(80, sorted(near + [(1, n)]), d, seed=7 * n + d)
        assert differing(site, g0, range(3)) == []


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("near", [[(2, 16), (3, 24)], [(1, 8), (4, 16)],
                                  [(2, 23), (4, 16)], [(1, 20), (2, 16)],
                                  [(2, 40), (3, 24)]])
def test_variable_costs_beside_two_buckets(near, d):
    """The local search's variable costs of 20, 22 and 24 values."""
    for n_vars in (20, 22, 24):
        g0 = skeleton(n_vars, sorted(near), d, seed=n_vars + 3 * d)
        assert differing("localsearch", g0, range(3)) == []
