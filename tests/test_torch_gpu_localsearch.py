"""On the card: the local-search slice's kernels equal their plain
versions, and its solves equal the CPU's.

This file imports neither JAX nor the JAX package.  Every test is
marked ``gpu`` and decides inside itself whether a card is present;
without one it skips.  Where JAX is missing run:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu_localsearch.py

- ``threefry.uniform`` equals its plain version (``utils/prng.py``) bit
  for bit (uint32 views) at one element, odd sizes, 2-D shapes and
  three ranges, under several keys, seed 2**63 - 1 included.
- ``threefry.best_choice`` equals its plain version at K in {1, 2, 3,
  8, 9, 128} with empty, single and full rows.
- ``segment_sum.positional_sum`` (the kernel's positional mode) equals
  its plain version bit for bit on order-sensitive contributions: four
  buckets of arity 1-4 whose units merge and separate, a hub of several
  shared-memory passes, and a generic D (> 8).
- A card solve of every algorithm and option (dsa A/B/C with p_mode
  arity, adsa staggered, dsatuto, mgm lexic/random, mgm2 with each
  favor, ell) equals the CPU solve — assignment, cycles and cost — and
  a second card solve; the threefry and segment_sum counters grew.
- The DSA, MGM and MGM2 loops read nothing from the card:
  ``torch.cuda.set_sync_debug_mode("error")`` around them raises on
  any synchronising call.
"""

import numpy as np
import pytest
import torch

import pydcop_tpu_torch.dcop.dcop as dcop_mod
import pydcop_tpu_torch.dcop.objects as objects
import pydcop_tpu_torch.dcop.relations as relations
from pydcop_tpu_torch.api import solve
from pydcop_tpu_torch.engine.convert import graph_from_numpy
from pydcop_tpu_torch.ops import _build, threefry
from pydcop_tpu_torch.ops.dsa import run_dsa
from pydcop_tpu_torch.ops.mgm import run_mgm
from pydcop_tpu_torch.ops.mgm2 import run_mgm2
from pydcop_tpu_torch.ops.segment_sum import (
    positional_sum,
    positional_sum_reference,
)
from pydcop_tpu_torch.utils import prng


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


KEYS = [prng.key_words(0), prng.key_words(7),
        prng.fold_in_words(prng.key_words(2 ** 63 - 1), 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1,), (7,), (10_001,), (241, 128),
                                   (10_001, 3)])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.37, 2.5),
                                   (1e-7, 3e-7)])
def test_uniform_kernel_equals_plain(shape, lo, hi):
    _need_card()
    for key in KEYS:
        out = threefry.uniform(key, shape, "cuda", lo, hi).cpu().numpy()
        ref = threefry.uniform_reference(key, shape, "cpu", lo,
                                         hi).numpy()
        np.testing.assert_array_equal(out.view(np.uint32),
                                      ref.view(np.uint32))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 3, 8, 9, 128])
def test_best_choice_kernel_equals_plain(k):
    _need_card()
    rng = np.random.default_rng(k)
    mask = rng.random((3_001, k)) < 0.4
    mask[0] = False          # empty row
    mask[1] = True           # full row
    mask[2] = False
    mask[2, k - 1] = True    # single slot
    for key in KEYS:
        out = threefry.best_choice(key, torch.tensor(mask, device="cuda"))
        ref = threefry.best_choice_reference(key, torch.tensor(mask))
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.cpu().numpy(), ref.numpy())


def _units_graph(d: int, seed: int, hub: bool = False):
    """Array-built graph of arity 1-4 buckets (sizes around V + 1, so
    that units merge and separate), order-sensitive contributions."""
    rng = np.random.default_rng(seed)
    n_vars = 300
    buckets = []
    for arity, f in ((1, 150), (2, 260), (3, 90), (4, 40)):
        ids = rng.integers(0, n_vars, size=(f, arity)).astype(np.int32)
        if hub:
            ids[: f // 2, 0] = 0   # variable 0 of degree ~270 + others
        ids[-3:] = n_vars
        buckets.append((np.zeros((f,) + (d,) * arity, np.float32), ids))
    var_costs = (rng.normal(size=(n_vars + 1, d))
                 * 10.0 ** rng.integers(-3, 4, size=(n_vars + 1, d))
                 ).astype(np.float32)
    valid = np.ones_like(var_costs, bool)
    graph = graph_from_numpy(var_costs, valid, buckets, device="cuda")
    units = [torch.tensor(
        (rng.normal(size=(ids.shape[0], d))
         * 10.0 ** rng.integers(-3, 4, size=(ids.shape[0], d))
         ).astype(np.float32), device="cuda")
        for _, ids in buckets for _p in range(ids.shape[1])]
    return graph, units


@pytest.mark.gpu
@pytest.mark.parametrize("d,hub", [(1, False), (3, False), (3, True),
                                   (5, False), (11, False)])
def test_positional_sum_kernel_equals_plain(d, hub):
    _need_card()
    graph, units = _units_graph(d, seed=d, hub=hub)
    out = positional_sum(units, graph.pos_perm, graph.agg_offsets,
                         graph.pos_units, graph.var_costs, graph.agg_tiles)
    ref = positional_sum_reference(
        torch.cat(units).cpu(), graph.pos_perm.cpu(),
        graph.agg_offsets.cpu(), graph.pos_units.cpu(),
        graph.var_costs.cpu())
    np.testing.assert_array_equal(out.cpu().numpy().view(np.uint32),
                                  ref.numpy().view(np.uint32))


def real_cost_dcop(n_vars: int, seed: int = 0):
    """~1.5 binary and 0.3 ternary constraints per variable over D = 3
    with real-valued random costs, so sums in another order show."""
    rng = np.random.default_rng(seed)
    dom = objects.Domain("d3", "", [0, 1, 2])
    dcop = dcop_mod.DCOP(f"real_{n_vars}", objective="min")
    vs = [objects.Variable(f"v{i:05d}", dom) for i in range(n_vars)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(int(n_vars * 1.5)):
        a, b = rng.choice(n_vars, size=2, replace=False)
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[a], vs[b]], rng.normal(size=(3, 3)) * 10.0
            ** rng.integers(-2, 3, size=(3, 3)), f"c{i}"))
    for i in range(int(n_vars * 0.3)):
        a, b, c = rng.choice(n_vars, size=3, replace=False)
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[a], vs[b], vs[c]], rng.normal(size=(3, 3, 3)),
            f"t{i}"))
    dcop.add_agents([objects.AgentDef("a0")])
    return dcop


CASES = [
    ("dsa", {"variant": "A"}), ("dsa", {"variant": "B"}),
    ("dsa", {"variant": "C", "p_mode": "arity"}),
    ("adsa", {"schedule": "staggered"}), ("dsatuto", {}),
    ("mgm", {}), ("mgm", {"break_mode": "random"}),
    ("mgm2", {}), ("mgm2", {"favor": "no"}),
    ("mgm2", {"favor": "coordinated"}),
    ("dsa", {"aggregation": "ell"}), ("mgm2", {"aggregation": "ell"}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("algo,params", CASES)
def test_card_solve_equals_cpu_solve(algo, params):
    _need_card()
    dcop = real_cost_dcop(600, seed=3)
    before = dict(_build.launch_counts)
    card = [solve(dcop, algo, max_cycles=40, algo_params=params)
            for _ in range(2)]
    grew = {k: _build.launch_counts[k] - before.get(k, 0)
            for k in ("segment_sum", threefry.UNIFORM,
                      threefry.BEST_CHOICE)}
    cpu = solve(dcop, algo, max_cycles=40, algo_params=params,
                device="cpu")
    for res in card:
        assert res["metrics"]["device"].startswith("cuda")
        assert res["assignment"] == cpu["assignment"]
        assert (res["cycles"], res["cost"]) == (cpu["cycles"], cpu["cost"])
    assert grew[threefry.BEST_CHOICE] > 0
    if params.get("aggregation") != "ell":
        assert grew["segment_sum"] > 0


@pytest.mark.gpu
def test_loops_read_nothing_from_the_card():
    _need_card()
    from pydcop_tpu_torch.algorithms.dsa import _arity_probabilities
    from pydcop_tpu_torch.algorithms.mgm import lexic_ranks
    from pydcop_tpu_torch.device import to_device_graph
    from pydcop_tpu_torch.engine.compile import compile_dcop

    host, meta = compile_dcop(real_cost_dcop(300, seed=5))
    graph = to_device_graph(host, "cuda")
    prob = torch.tensor(_arity_probabilities(host, 0.7), device="cuda")
    ranks = torch.tensor(lexic_ranks(meta), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run_dsa(graph, 10, variant="B", probability=prob, seed=1)
        run_mgm(graph, 10, lexic_ranks=ranks, break_mode="random")
        for favor in ("unilateral", "no"):
            run_mgm2(graph, 10, lexic_ranks=ranks, favor=favor)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
