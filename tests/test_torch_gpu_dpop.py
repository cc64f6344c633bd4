"""On the card: the window sum kernel equals its plain version, and the
exact slice's solves equal the CPU's.

This file imports neither JAX nor the JAX package.  Every test is
marked ``gpu`` and decides inside itself whether a card is present;
without one it skips.  Where JAX is missing run:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu_dpop.py

- ``window_sum.window_tree_sum`` (``csrc/window_sum.cu``) equals
  ``window_tree_sum_plain`` bit for bit (uint32 views) at sizes 2 to
  1,500,000, on signed values over eight decades, subnormal entries,
  +inf, +-inf (a NaN: any two NaNs agree, their payloads differ between
  the card and an x86 CPU) and signed zeros; with every head form of ``gather_stages``
  at 8-32 values; and on [F, arity, D] operands with the row lanes of
  ``residual_lanes`` (windows of 32 rows, a direct sum, an axis longer
  than 32 at D = 128).
- The whole-graph totals on the card (``localsearch.assignment_cost``,
  ``maxsum.assignment_constraint_cost`` at both sites, the variable-side
  sum) equal the CPU's on mixed-arity graphs with real costs, and the
  kernel's counter grew.
- DPOP's UTIL step on the card gives the CPU's ``acc`` and ``util`` bit
  for bit (no NaN in these inputs), and ``api.solve(dcop, "dpop")`` on
  the card equals the CPU solve (assignment, cost, cycles, every
  metric); SyncBB and NCBB through ``api.solve`` on ``cuda`` equal their
  CPU runs.
"""

import numpy as np
import pytest
import torch

import pydcop_tpu_torch.dcop.dcop as dcop_mod
import pydcop_tpu_torch.dcop.objects as objects
import pydcop_tpu_torch.dcop.relations as relations
from pydcop_tpu_torch.api import solve
from pydcop_tpu_torch.engine.convert import graph_from_numpy
from pydcop_tpu_torch.engine.compile import compile_dcop
from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops import dpop as dpop_ops
from pydcop_tpu_torch.ops import localsearch as ls
from pydcop_tpu_torch.ops import maxsum as ms
from pydcop_tpu_torch.ops.window_sum import (
    COUNTER,
    gather_stages,
    residual_lanes,
    window_tree_sum,
    window_tree_sum_plain,
)


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


def wide(rng, shape):
    return (rng.standard_normal(shape)
            * 10.0 ** rng.uniform(-4, 4, shape)).astype(np.float32)


def values_of(kind, shape, seed):
    rng = np.random.default_rng(seed)
    x = wide(rng, shape)
    flat = x.reshape(-1)
    if kind == "subnormal":
        flat[rng.random(flat.size) < 0.3] = np.float32(-1e-39)
        flat[rng.random(flat.size) < 0.1] = np.float32(1.3e-38)
    elif kind == "inf":
        flat[rng.integers(0, flat.size)] = np.inf
        flat[rng.integers(0, flat.size)] = -np.inf
    elif kind == "posinf":
        flat[rng.integers(0, flat.size)] = np.inf
    elif kind == "zeros":
        flat[rng.random(flat.size) < 0.5] = -0.0
    return x


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """Bit for bit, except that any two NaNs agree: an invalid add makes
    0x7FFFFFFF on the card and 0xFFC00000 on an x86 CPU."""
    both_nan = np.isnan(a) & np.isnan(b)
    return bool(np.all(both_nan | (a.view(np.uint32) == b.view(np.uint32))))


def same_on_card(x, head=(), lanes=1):
    plain = window_tree_sum_plain(torch.from_numpy(x), head, lanes)
    card = window_tree_sum(torch.from_numpy(x).cuda(), head, lanes)
    torch.cuda.synchronize()
    assert card.device.type == "cuda" and card.shape == ()
    assert same_bits(card.cpu().numpy(), plain.numpy()), (
        float(card), float(plain))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["signed", "subnormal", "inf", "posinf",
                                  "zeros"])
@pytest.mark.parametrize("size", [2, 7, 31, 32, 33, 64, 1025, 15_000,
                                  1_000_001, 1_500_000])
def test_window_sum_kernel_equals_plain(size, kind):
    _need_card()
    before = _build.launch_counts[COUNTER]
    for seed in range(2):
        same_on_card(values_of(kind, (size,), seed))
    assert _build.launch_counts[COUNTER] == before + 2


HEADS = sorted({gather_stages(site, arity, d, n, widest)
                for site in ("localsearch", "maxsum", "probe")
                for arity in range(5) for d in (2, 3, 4, 5)
                for n in range(8, 33) for widest in (2, 3)})


@pytest.mark.gpu
@pytest.mark.parametrize("head", HEADS)
def test_window_sum_heads_equal_plain(head):
    _need_card()
    for n in (8, 16, 20, 23, 24, 31, 32):
        same_on_card(values_of("signed", (n, 1), n), head)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(17, 2, 3), (100, 2, 3), (14_999, 2, 3),
                                   (1_500_000, 2, 3), (17, 4, 3),
                                   (100, 4, 3), (100, 8, 3), (70, 3, 5),
                                   (300, 2, 8), (10, 2, 128),
                                   (40, 2, 128)])
def test_window_sum_residual_shapes_equal_plain(shape):
    _need_card()
    x = np.abs(values_of("signed", shape, 3))
    same_on_card(x, lanes=residual_lanes(shape))
    same_on_card(x)


def mixed_graph(seed, n_vars=400, d=3):
    """A graph of unary, binary and ternary factors with real costs
    over eight decades (the buckets' counts hit the windowed and the
    direct sums)."""
    rng = np.random.default_rng(seed)
    dom = objects.Domain("d", "", list(range(d)))
    dcop = dcop_mod.DCOP("g", objective="min")
    vs = [objects.Variable(f"v{i:04d}", dom) for i in range(n_vars)]
    for v in vs:
        dcop.add_variable(v)
    k = 0
    for arity, count in ((1, 21), (2, 600), (3, 25)):
        for _ in range(count):
            scope = [vs[i] for i in rng.choice(n_vars, arity,
                                               replace=False)]
            dcop.add_constraint(relations.NAryMatrixRelation(
                scope, wide(rng, (d,) * arity).astype(np.float64),
                f"c{k}"))
            k += 1
    g, _ = compile_dcop(dcop, aggregation="scatter", use_cache=False)
    arrays = (g.var_costs, g.var_valid,
              [(b.costs, b.var_ids) for b in g.buckets])
    return (graph_from_numpy(*arrays, device="cpu",
                             aggregation="scatter"),
            graph_from_numpy(*arrays, device="cuda",
                             aggregation="scatter"), g)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_whole_graph_totals_on_the_card_equal_the_cpu(seed):
    _need_card()
    cpu, card, g = mixed_graph(seed)
    rng = np.random.default_rng(seed)
    n, d = g.var_costs.shape
    vals = torch.from_numpy(rng.integers(0, d, n).astype(np.int32))
    base = torch.from_numpy(wide(rng, (n - 1, d)))
    before = _build.launch_counts[COUNTER]
    pairs = [(ls.assignment_cost(cpu, vals),
              ls.assignment_cost(card, vals.cuda()))]
    for site in ("maxsum", "probe"):
        pairs.append((ms.assignment_constraint_cost(cpu, vals[:-1], site),
                      ms.assignment_constraint_cost(card, vals[:-1].cuda(),
                                                    site)))
        pairs.append((ms.variable_cost(base, vals[:-1], site),
                      ms.variable_cost(base.cuda(), vals[:-1].cuda(),
                                       site)))
    for plain, on_card in pairs:
        assert on_card.device.type == "cuda"
        assert (on_card.cpu().numpy().view(np.uint32)
                == plain.numpy().view(np.uint32))
    assert _build.launch_counts[COUNTER] > before


SIGNATURES = [
    ((3,), ((0,),)),
    ((4, 3), ((0,), (0, 1))),
    ((3, 2, 5), ((0,), (0, 1), (0, 2), (1, 2))),
    ((5, 3, 3, 2), ((0,), (0, 1, 2), (0, 3), (1, 2, 3))),
    ((8, 8, 8, 8, 8, 8), ((0,), (0, 1), (0, 2), (0, 3), (0, 4), (0, 5))),
]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("index", range(len(SIGNATURES)))
def test_util_step_on_the_card_equals_the_cpu(index, mode):
    _need_card()
    shape, axes_tuples = SIGNATURES[index]
    rng = np.random.default_rng(index)
    comps = []
    for axes in axes_tuples:
        comp = wide(rng, (5,) + tuple(shape[a] for a in axes))
        comp[rng.random(comp.shape) < 0.2] = -0.0
        comp[rng.random(comp.shape) < 0.1] = np.float32(-1e-39)
        comps.append(comp)
    kernel = dpop_ops._kernel_for((shape, axes_tuples, mode, True))
    c_acc, c_util = kernel(*(torch.from_numpy(c) for c in comps))
    g_acc, g_util = kernel(*(torch.from_numpy(c).cuda() for c in comps))
    np.testing.assert_array_equal(g_acc.cpu().numpy().view(np.uint32),
                                  c_acc.numpy().view(np.uint32))
    np.testing.assert_array_equal(g_util.cpu().numpy().view(np.uint32),
                                  c_util.numpy().view(np.uint32))


def random_dcop(n, d, seed, extra_edges=0, objective="min", integer=False):
    rng = np.random.default_rng(seed)
    dom = objects.Domain("c", "", list(range(d)))
    dcop = dcop_mod.DCOP("t", objective=objective)
    vs = [objects.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)

    def table(shape):
        if integer:
            return rng.integers(0, 20, shape).astype(float)
        return rng.random(shape)

    k = 0
    for i in range(1, n):
        p = rng.integers(0, i)
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[p], vs[i]], table((d, d)), f"c{k}"))
        k += 1
    for _ in range(extra_edges):
        i, j = rng.choice(n, size=2, replace=False)
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[i], vs[j]], table((d, d)), f"c{k}"))
        k += 1
    return dcop


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,seed,extra,objective", [
    (300, 3, 0, 0, "min"), (200, 4, 1, 15, "min"), (120, 3, 2, 10, "max"),
    (60, 8, 3, 4, "min")])
def test_dpop_card_solve_equals_cpu(n, d, seed, extra, objective):
    _need_card()
    dcop = random_dcop(n, d, seed, extra, objective)
    for cec in ("on", "off"):
        params = {"engine": "jit", "cec": cec}
        cpu = solve(dcop, "dpop", algo_params=params, device="cpu")
        card = solve(dcop, "dpop", algo_params=params, device="cuda")
        for key in ("assignment", "cost", "violations", "cycles",
                    "status"):
            assert card[key] == cpu[key], key
        assert card["metrics"] == cpu["metrics"]
        assert card["metrics"]["engine"] == "jit"


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["syncbb", "ncbb"])
def test_tree_searches_on_cuda_equal_cpu(algo):
    _need_card()
    dcop = random_dcop(10, 3, 4, extra_edges=3, integer=True)
    cpu = solve(dcop, algo, device="cpu")
    card = solve(dcop, algo, device="cuda")
    for key in ("assignment", "cost", "cycles", "metrics"):
        assert card[key] == cpu[key], key
    assert card["cost"] == solve(dcop, "dpop", device="cuda")["cost"]
