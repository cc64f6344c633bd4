"""The sum-order rules that read the graph around an operand, pinned by
grids against the jitted JAX reference on the CPU, bit for bit (uint32
views); the residual at arity 16 is in
``tests/test_torch_window_sum_residual16.py``.

Found by reading the optimised HLO (the buckets' reductions share one
loop fusion) and the LLVM IR (the lanes of each reduction loop), then
searching the lane forms over cost draws of one, three and six decades
(``window_sum.gather_stages``, ``near``):

- a unary sum (``tests/test_torch_window_sum_unary.py``);
- at ``maxsum`` a 5-ary bucket of 20-23 factors beside a bucket of
  arity 3, 4, 6 or 7 and 2-32 factors goes in lanes of 4 then 2, and
  one of 32 in lanes of 8;
- at ``maxsum`` with D = 1, a ternary bucket of 8 factors beside a
  binary bucket of 2-20 factors or one of arity 4-7 and 2-8 factors
  goes in lanes.

Each grid also holds the neighbours that leave the form alone.
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


L4x16_2x20 = ((4, 16), (2, 20))


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", [21, 32])
@pytest.mark.parametrize("neighbour", [(3, 8), (4, 2), (6, 20), (7, 32),
                                       (2, 16), (8, 4), (4, 40), (1, 8)])
def test_five_ary_bucket_beside_one_other_at_maxsum(neighbour, n, d):
    a, m = neighbour
    changed = a in (3, 4, 6, 7) and 2 <= m <= 32
    head = gather_stages("maxsum", 5, d, n, near=[neighbour])
    if n < 24:
        assert head == (L4x16_2x20 if changed else ((8, 16),))
    else:
        assert head == (((8, 32),) if changed else ((16, 32),))
    g0 = skeleton(80, sorted([(5, n), neighbour]), d, seed=n + d + a + m)
    assert differing("maxsum", g0, range(3)) == []


@pytest.mark.parametrize("neighbour", [(2, 2), (4, 8), (7, 5), (2, 20),
                                       (8, 4), (1, 8), (2, 33)])
def test_unit_domain_ternary_bucket_of_8_at_maxsum(neighbour):
    a, m = neighbour
    changed = 2 <= m <= (20 if a == 2 else 8 if 4 <= a <= 7 else 1)
    assert (gather_stages("maxsum", 3, 1, 8, near=[neighbour]) != ()) \
        == changed
    for n_vars in (12, 40):
        g0 = skeleton(n_vars, sorted([(3, 8), neighbour]), 1,
                      seed=n_vars + a + m)
        assert differing("maxsum", g0, range(4)) == []
