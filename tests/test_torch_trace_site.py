"""The traced run's per-cycle constraint costs
(``ops/maxsum.py::run_maxsum_trace``, ``ops/maxsum.py::trace_site``)
against the JAX package's ``MaxSumEngine.run_trace``, on the CPU.

Inside the reference's traced loop the bucket sums are not summed as a
standalone ``assignment_constraint_cost`` sums them: at D >= 2 LLVM
gives them the probe's forms (20-23 factors of arity 2-6 in lanes of 8
then 2, 32 factors of arity 5-6 in lanes of 8), at D = 1 it sums them
left to right.  These shapes gave other bits before ``trace_site``
(found while porting the partitioned engine, whose shards' local
buckets land in those ranges).

Tolerance: none (the cost trace's bytes).
"""

import numpy as np
import pytest
import torch

from pydcop_tpu.algorithms.maxsum import build_engine as jax_build_engine
from pydcop_tpu_torch.algorithms.maxsum import build_engine
from torch_sharding_common import _problem, both

V = 45


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _cold_dispatch_caches():
    """Every test starts with both packages' batch dispatch caches
    empty, so ``cold_start`` compares like with like."""
    import pydcop_tpu.engine.batch as JB
    import pydcop_tpu_torch.engine.batch as TB

    JB._warm.clear()
    TB._warm.clear()


def _mix(mods, spec, seed, d):
    """Buckets of (arity, factors) over V variables, random scopes."""
    rng = np.random.default_rng(seed + 77)
    scopes = [tuple(int(x) for x in rng.choice(V, size=a, replace=False))
              for a, n in spec for _ in range(n)]
    return _problem(mods, "mix", V, d, scopes, 3, seed)


def assert_same_trace(spec, d, seed=0, cycles=8):
    jdcop, tdcop = both(_mix, spec, seed, d)
    ref = jax_build_engine(jdcop, {}).run_trace(cycles)
    out = build_engine(tdcop, {}, device="cpu").run_trace(cycles)
    a, b = ref.metrics["cost_trace"], out.metrics["cost_trace"]
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (spec, d)


@pytest.mark.parametrize("d", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("n", [20, 21, 23])
def test_binary_bucket_of_20_to_23_factors(n, d):
    assert_same_trace([(2, n)], d)
    assert_same_trace([(2, n), (3, 6)], d, seed=1)


@pytest.mark.parametrize("arity,n", [(3, 20), (4, 22), (5, 21), (6, 20),
                                     (5, 32), (6, 32)])
def test_wider_buckets_at_the_probe_forms(arity, n):
    assert_same_trace([(arity, n), (2, 40)], 2)


@pytest.mark.parametrize("spec", [
    [(2, 16)], [(6, 8)], [(5, 22)], [(4, 8), (2, 16)],
    [(3, 24), (4, 4)], [(1, 40), (4, 22), (2, 24)]])
def test_unit_domain_sums_left_to_right(spec):
    assert_same_trace(spec, 1)


@pytest.mark.parametrize("seed", range(12))
def test_random_bucket_mixes(seed):
    rng = np.random.default_rng(1000 + seed)
    k = int(rng.integers(1, 4))
    arities = rng.choice([1, 2, 3, 4, 5, 6], size=k, replace=False)
    spec = [(int(a), int(rng.choice([2, 4, 8, 12, 16, 20, 22, 24, 28, 32,
                                     40]))) for a in arities]
    d = int(rng.choice([1, 2, 3, 4]))
    while any(d ** a > 5000 for a, _ in spec):
        d -= 1
    assert_same_trace(spec, d, seed=seed)
