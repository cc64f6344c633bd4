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
  8, 9, 128} with empty, single and full rows, and over K in {1, 2, 3,
  5, 9, 33} x mask densities {0, 0.1, 0.4, 0.9, 1.0}, on masks that do
  not start on a 4-byte boundary, and on full rows whose draws tie.
- ``segment_sum.positional_sum`` (the contributions entry) equals its
  plain version bit for bit on order-sensitive contributions: four
  buckets of arity 1-4 whose units merge and separate, a hub of several
  shared-memory passes, and a generic D (> 8); both positional entries
  (``positional_table_sum``, the fused gather-and-sum, through
  ``localsearch.candidate_costs``) equal their plain versions on mixed
  arity-2/3/4 graphs, one-binary-bucket graphs (two units, separate and
  merged), a hub, and the one-factor-bucket graphs of
  ``tests/test_torch_positional_one_factor.py``, at D in {1, 3, 5, 8,
  11}.
- A card solve of every algorithm and option (dsa A/B/C with p_mode
  arity, adsa staggered, dsatuto, mgm lexic/random, mgm2 with each
  favor, ell) equals the CPU solve — assignment, cycles and cost — and
  a second card solve; the threefry and segment_sum counters grew.
- The DSA, MGM and MGM2 loops read nothing from the card:
  ``torch.cuda.set_sync_debug_mode("error")`` around them raises on
  any synchronising call.
- DBA (hard CSP, early stop, ``infinity``, ell), GDBA (three mode
  triples, ell) and MixedDSA (variants A, B, C on hard equality tables
  with soft tables on half the edges) solved on the card equal the CPU
  solve and a second card solve; the contributions entry of the
  positional sum counted launches.  DBA's chunk of gated steps reads
  nothing from the card, and a whole ``run_dba`` synchronises at most
  ceil(cycles / chunk) + 1 times (counted under
  ``set_sync_debug_mode("warn")``), with the cycles of a chunk of 1.
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
from pydcop_tpu_torch.ops import localsearch as ls
from pydcop_tpu_torch.ops.dsa import run_dsa
from pydcop_tpu_torch.ops.mgm import run_mgm
from pydcop_tpu_torch.ops.mgm2 import run_mgm2
from pydcop_tpu_torch.ops.segment_sum import (
    POSITIONAL,
    POSITIONAL_TABLE,
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


DENSITIES = [0.0, 0.1, 0.4, 0.9, 1.0]


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 3, 5, 9, 33])
def test_best_choice_kernel_equals_plain_over_densities(k):
    """Each density on a mask that starts one byte past an aligned
    word (a view of a larger mask), so the kernel's first and last
    words hold bytes outside the mask."""
    _need_card()
    rng = np.random.default_rng(100 + k)
    for density in DENSITIES:
        big = torch.tensor(rng.random((2_501, k)) < density,
                           device="cuda").reshape(-1)
        mask = big[1:1 + 2_500 * k].reshape(2_500, k)
        assert mask.data_ptr() % 4 != 0
        for key in KEYS:
            out = threefry.best_choice(key, mask)
            ref = threefry.best_choice_reference(key, mask.cpu())
            np.testing.assert_array_equal(out.cpu().numpy(), ref.numpy())


@pytest.mark.gpu
def test_best_choice_kernel_breaks_ties_like_plain():
    """Full rows of 33 slots: among 2,000,000 rows some rows' largest
    draw is drawn twice (23-bit mantissas: ~8 rows expected), and the
    first index wins there."""
    _need_card()
    key = KEYS[1]
    mask = torch.ones((2_000_000, 33), dtype=torch.bool, device="cuda")
    u = threefry.uniform(key, mask.shape, "cuda")
    tied = (u == u.max(dim=1, keepdim=True).values).sum(dim=1) > 1
    assert int(tied.sum()) > 0
    del u
    out = threefry.best_choice(key, mask)
    ref = threefry.best_choice_reference(key, mask)
    assert torch.equal(out, ref)


def _spread(rng, shape):
    return (rng.normal(size=shape)
            * 10.0 ** rng.integers(-3, 4, size=shape)).astype(np.float32)


# (label, V, D, [(arity, F)]): one-factor buckets (real, not padding),
# one binary bucket (two units: separate at F >= V + 1, merged below),
# mixed arities, a hub.
TABLE_GRAPHS = [
    ("mixed_d3", 300, 3, [(2, 400), (3, 90), (1, 120), (4, 30)]),
    ("mixed_d5", 200, 5, [(1, 80), (2, 260), (3, 40)]),
    ("binary_sep_d3", 500, 3, [(2, 900)]),
    ("binary_merged_d3", 500, 3, [(2, 200)]),
    ("binary_d1", 400, 1, [(2, 700)]),
    ("binary_d8", 150, 8, [(2, 260)]),
    ("binary_d11", 150, 11, [(2, 260), (1, 30)]),
    ("hub_d3", 400, 3, [(2, 3_000)]),
    ("one_factor_after_large", 20, 3, [(1, 60), (2, 1)]),
    ("one_factor_first", 20, 4, [(2, 1), (1, 40)]),
    ("one_factor_two_apart", 20, 3, [(1, 30), (1, 1), (1, 30), (1, 1)]),
    ("one_factor_binary", 24, 4, [(2, 1), (2, 40), (1, 1), (2, 1)]),
]


def _table_graph(label, n_vars, d, sizes, seed):
    rng = np.random.default_rng(seed)
    buckets = []
    for arity, f in sizes:
        ids = np.stack([rng.choice(n_vars, size=arity, replace=False)
                        for _ in range(f)]).astype(np.int32)
        if label.startswith("hub"):
            ids[: f // 2, 0] = 0
        if f > 1:
            ids[f - max(1, f // 10):] = n_vars
        buckets.append((_spread(rng, (f,) + (d,) * arity), ids))
    var_costs = _spread(rng, (n_vars + 1, d))
    valid = np.ones_like(var_costs, bool)
    cpu = graph_from_numpy(var_costs, valid, buckets, device="cpu")
    card = graph_from_numpy(var_costs, valid, buckets, device="cuda")
    values = rng.integers(0, d, size=n_vars + 1).astype(np.int32)
    return cpu, card, values


@pytest.mark.gpu
@pytest.mark.parametrize("label,n_vars,d,sizes", TABLE_GRAPHS,
                         ids=[g[0] for g in TABLE_GRAPHS])
def test_positional_entries_equal_plain(label, n_vars, d, sizes):
    """The fused entry through candidate_costs, and the contributions
    entry on the same rows, against the CPU's plain version."""
    _need_card()
    cpu, card, values = _table_graph(label, n_vars, d, sizes, len(sizes))
    ref = ls.candidate_costs(cpu, torch.tensor(values))
    before = dict(_build.launch_counts)
    out = ls.candidate_costs(card, torch.tensor(values, device="cuda"))
    entry = (POSITIONAL_TABLE if any(a == 2 for a, _ in sizes)
             else POSITIONAL)
    assert _build.launch_counts[entry] == before.get(entry, 0) + 1
    np.testing.assert_array_equal(out.cpu().numpy().view(np.uint32),
                                  ref.numpy().view(np.uint32))
    per = [t.transpose(0, 1).contiguous()
           for t in ls._position_tables(card, torch.tensor(
               values, device="cuda"))]
    out = ls.positional_sum(card, per, card.var_costs)
    assert _build.launch_counts[POSITIONAL] == before.get(
        POSITIONAL, 0) + 1 + (entry == POSITIONAL)
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
            for k in (POSITIONAL_TABLE, threefry.UNIFORM,
                      threefry.BEST_CHOICE)}
    cpu = solve(dcop, algo, max_cycles=40, algo_params=params,
                device="cpu")
    for res in card:
        assert res["metrics"]["device"].startswith("cuda")
        assert res["assignment"] == cpu["assignment"]
        assert (res["cycles"], res["cost"]) == (cpu["cycles"], cpu["cost"])
    assert grew[threefry.BEST_CHOICE] > 0
    if params.get("aggregation") != "ell":
        assert grew[POSITIONAL_TABLE] > 0


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


def csp_dcop(n_vars: int, seed: int = 0, infinity: float = 10000.0,
             extra_soft: bool = False, n_colors: int = 3):
    """A ring with ~n/3 random chords over 3 colours, equal colours
    costing ``infinity`` (the reference's ``coloring_csp``), and with
    ``extra_soft`` seeded real tables on the first half of its edges."""
    rng = np.random.default_rng(seed)
    dom = objects.Domain("colors", "color", list(range(n_colors)))
    dcop = dcop_mod.DCOP(f"csp_{n_vars}", objective="min")
    vs = [objects.Variable(f"v{i:05d}", dom) for i in range(n_vars)]
    for v in vs:
        dcop.add_variable(v)
    eq = np.where(np.eye(n_colors) > 0, infinity, 0.0)
    edges = [(i, (i + 1) % n_vars) for i in range(n_vars)]
    seen = set(edges)
    for _ in range(n_vars // 3):
        i, j = (int(x) for x in rng.choice(n_vars, size=2, replace=False))
        if (i, j) not in seen and (j, i) not in seen:
            edges.append((i, j))
            seen.add((i, j))
    for k, (i, j) in enumerate(edges):
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[i], vs[j]], eq, f"c{k}"))
    if extra_soft:
        for k, (i, j) in enumerate(edges[: n_vars // 2]):
            dcop.add_constraint(relations.NAryMatrixRelation(
                [vs[i], vs[j]], rng.random((n_colors, n_colors)), f"s{k}"))
    dcop.add_agents([objects.AgentDef("a0")])
    return dcop


BREAKOUT_CASES = [
    ("dba", "csp", {"max_distance": 10}),
    ("dba", "csp", {"aggregation": "ell", "seed": 2}),
    ("dba", "real", {"infinity": 1}),
    ("gdba", "real", {}),
    ("gdba", "real", {"modifier": "M", "violation": "NM",
                      "increase_mode": "R"}),
    ("gdba", "real", {"violation": "MX", "increase_mode": "T",
                      "aggregation": "ell"}),
    ("mixeddsa", "mixed", {"variant": "A"}),
    ("mixeddsa", "mixed", {"variant": "B"}),
    ("mixeddsa", "mixed", {"variant": "C"}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("algo,problem,params", BREAKOUT_CASES)
def test_breakout_card_solve_equals_cpu_solve(algo, problem, params):
    _need_card()
    dcop = {"csp": lambda: csp_dcop(900, seed=4),
            "real": lambda: real_cost_dcop(600, seed=3),
            "mixed": lambda: csp_dcop(900, seed=6, infinity=float("inf"),
                                      extra_soft=True)}[problem]()
    before = dict(_build.launch_counts)
    card = [solve(dcop, algo, max_cycles=120, algo_params=params)
            for _ in range(2)]
    grew = _build.launch_counts[POSITIONAL] - before.get(POSITIONAL, 0)
    cpu = solve(dcop, algo, max_cycles=120, algo_params=params,
                device="cpu")
    for res in card:
        assert res["metrics"]["device"].startswith("cuda")
        assert res["assignment"] == cpu["assignment"]
        assert (res["cycles"], res["cost"]) == (cpu["cycles"], cpu["cost"])
    if params.get("aggregation") != "ell" or algo == "mixeddsa":
        assert grew > 0
    if problem == "csp":
        assert card[0]["cycles"] < 120


@pytest.mark.gpu
def test_dba_chunk_reads_nothing_and_run_reads_once_a_chunk():
    _need_card()
    import math
    import warnings

    from pydcop_tpu_torch.algorithms.mgm import lexic_ranks
    from pydcop_tpu_torch.device import to_device_graph
    from pydcop_tpu_torch.engine.compile import compile_dcop
    from pydcop_tpu_torch.ops import dba

    host, meta = compile_dcop(csp_dcop(900, seed=4))
    graph = to_device_graph(host, "cuda")
    ranks = torch.tensor(lexic_ranks(meta), device="cuda")
    kw = dict(infinity=10000.0, max_distance=10, lexic_ranks=ranks)
    state = dba.init_state(graph, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dba.run_chunk(state, graph, 16, max_cycles=400, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = dba.run_dba(graph, 400, chunk=1, **kw)
    for chunk in (4, 16):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                values, cost, cycles = dba.run_dba(graph, 400, chunk=chunk,
                                                   **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        reads = sum("synchroniz" in str(w.message) for w in seen)
        assert cycles == want[2] < 400
        assert 1 <= reads <= math.ceil(cycles / chunk) + 1, reads
        assert torch.equal(values, want[0]) and float(cost) == float(want[1])
