"""The port's belief aggregation (pydcop_tpu_torch/ops/segment_sum.py and
the CSR arrays of device.to_device_graph) against the JAX reference.

- The placement arrays ``agg_perm``/``agg_offsets`` equal the perm,
  starts and ends of ``pydcop_tpu.engine.compile.build_aggregation_arrays``
  (``np.array_equal``) on two fixtures, a mixed-arity 30-variable graph
  with sentinel padding rows, a graph with a hub of degree 1,100, and
  the array-built graph of ``engine.convert.graph_from_numpy``.
- A model of the CUDA kernel's walk (per variable, float32 adds one at
  a time over its CSR edges, from +0.0, with each odd bucket summed on
  its own and added) equals the plain version bit for bit, and both
  equal the jitted JAX ``aggregate_beliefs`` on the same messages, on
  those graphs and on array-built graphs of 2 to 6 buckets.  Tolerance:
  none.  The messages span seven decades, so a sum taken in another
  order changes the bits: a plain edge-order walk across buckets, and a
  reversed walk of the hub, both differ.
- The wrapper refuses what the kernel does not take and, on the CPU,
  runs the plain version without counting a launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydcop_tpu.dcop.dcop as jd
import pydcop_tpu.dcop.objects as jo
import pydcop_tpu.dcop.relations as jr
import pydcop_tpu_torch.dcop.dcop as td
import pydcop_tpu_torch.dcop.objects as to
import pydcop_tpu_torch.dcop.relations as tr
from pydcop_tpu.engine.compile import (
    CompiledFactorGraph,
    FactorBucket,
    build_aggregation_arrays,
)
from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu.ops import maxsum as J
from pydcop_tpu_torch.device import to_device_graph
from pydcop_tpu_torch.engine.compile import compile_dcop as torch_compile
from pydcop_tpu_torch.engine.convert import (
    graph_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops import maxsum as T
from pydcop_tpu_torch.ops.segment_sum import (
    segment_sum,
    segment_sum_reference,
    separate_buckets,
)
from test_torch_compile import load_both

PAD_TO = 8


def build_mixed(objects, relations, dcop_mod, n_vars=30, seed=3):
    """30 variables over domains of 2 and 3 values, with unary, binary
    and ternary integer-cost constraints."""
    rng = np.random.default_rng(seed)
    doms = [objects.Domain("d2", "", [0, 1]),
            objects.Domain("d3", "", [0, 1, 2])]
    dcop = dcop_mod.DCOP("mixed30", objective="min")
    vs = [objects.Variable(f"v{i}", doms[i % 2]) for i in range(n_vars)]
    for v in vs:
        dcop.add_variable(v)
    k = 0
    for arity, count in ((1, 8), (2, 40), (3, 15)):
        for _ in range(count):
            scope = [vs[i] for i in rng.choice(n_vars, arity, replace=False)]
            table = rng.integers(0, 9, size=[len(v.domain) for v in scope])
            dcop.add_constraint(relations.NAryMatrixRelation(
                scope, table.astype(np.float64), f"c{k}"))
            k += 1
    dcop.add_agents([objects.AgentDef("a0")])
    return dcop


def build_hub(objects, relations, dcop_mod, n_vars=1_200, seed=4):
    """Variable 0 shares a binary factor with each of 1,100 others; a
    few hundred random factors more."""
    rng = np.random.default_rng(seed)
    dom = objects.Domain("c", "", [0, 1, 2])
    dcop = dcop_mod.DCOP("hub", objective="min")
    vs = [objects.Variable(f"v{i}", dom) for i in range(n_vars)]
    for v in vs:
        dcop.add_variable(v)
    pairs = [(0, i) for i in range(1, 1_101)]
    pairs += [tuple(rng.choice(np.arange(1, n_vars), 2, replace=False))
              for _ in range(300)]
    for k, (i, j) in enumerate(pairs):
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[i], vs[j]], rng.integers(0, 5, size=(3, 3)).astype(float),
            f"c{k}"))
    dcop.add_agents([objects.AgentDef("a0")])
    return dcop


def _both(problem):
    """(JAX graph, port graph on the CPU), each compiled by its own
    package from its own objects."""
    kw = {}
    if problem == "mixed30":
        pair = (build_mixed(jo, jr, jd), build_mixed(to, tr, td))
        kw["pad_to"] = PAD_TO
    elif problem == "hub":
        pair = (build_hub(jo, jr, jd), build_hub(to, tr, td))
    else:
        pair = load_both(problem)
    g, _ = jax_compile(pair[0], noise_level=0.01, **kw)
    tg, _ = torch_compile(pair[1], noise_level=0.01, **kw)
    return g, to_device_graph(tg, "cpu")


PROBLEMS = ["coloring_12_3.yml", "loft_scene.yml", "mixed30", "hub"]


def _assert_reference_arrays(g, tg):
    n_seg = g.var_costs.shape[0]
    perm, _, starts, ends, _ = build_aggregation_arrays(
        g.buckets, n_seg, "boundary")
    for name in ("agg_perm", "agg_offsets", "agg_buckets"):
        assert getattr(tg, name).dtype == torch.int32, name
    offsets = tg.agg_offsets.numpy()
    assert offsets.shape == (n_seg + 1,)
    np.testing.assert_array_equal(tg.agg_perm.numpy(), perm)
    np.testing.assert_array_equal(offsets[:-1], starts)
    np.testing.assert_array_equal(offsets[1:], ends)
    np.testing.assert_array_equal(
        tg.agg_buckets.numpy(),
        np.cumsum([0] + [b.var_ids.size for b in g.buckets]))


@pytest.mark.parametrize("problem", PROBLEMS)
def test_placement_arrays_equal_reference(problem):
    g, tg = _both(problem)
    _assert_reference_arrays(g, tg)
    degree = np.diff(tg.agg_offsets.numpy())
    if problem == "mixed30":
        assert [b.var_ids.shape[1] for b in g.buckets] == [1, 2, 3]
        # Sentinel padding rows: their edges land in row V like any other.
        n_pad = sum(int((b.var_ids == g.var_costs.shape[0] - 1).sum())
                    for b in g.buckets)
        assert n_pad > 0 and degree[-1] == n_pad
    if problem == "hub":
        assert degree[0] >= 1_000


def array_graphs(n_buckets, seed=6, n_vars=60, d=3):
    """(JAX graph, port graph on the CPU) built from the same arrays:
    buckets of arity 1, 2, ... with random sizes, a tenth of each
    bucket's rows padding (sentinel V)."""
    rng = np.random.default_rng(seed)
    buckets = []
    for arity in range(1, n_buckets + 1):
        f = int(rng.integers(20, 80))
        ids = rng.integers(0, n_vars, size=(f, arity)).astype(np.int32)
        ids[-(f // 10):] = n_vars
        buckets.append((np.zeros((f,) + (d,) * arity, np.float32), ids))
    var_costs = (rng.normal(size=(n_vars + 1, d)) * 10).astype(np.float32)
    var_valid = np.ones_like(var_costs, bool)
    g = CompiledFactorGraph(var_costs, var_valid,
                            tuple(FactorBucket(c, i) for c, i in buckets))
    return g, graph_from_numpy(var_costs, var_valid, buckets, device="cpu")


def test_placement_arrays_from_numpy_graph():
    """The array-built entry (the scale leg's) gets the arrays too."""
    _assert_reference_arrays(*array_graphs(4))


def _messages(g, seed):
    """Per-bucket f2v messages spread over seven decades (BIG on the
    invalid slots, like the real ones)."""
    rng = np.random.default_rng(seed)
    d = g.var_costs.shape[1]
    out = []
    for b in g.buckets:
        shape = b.var_ids.shape + (d,)
        m = (rng.normal(size=shape)
             * 10.0 ** rng.integers(-3, 4, size=shape)).astype(np.float32)
        out.append(np.where(g.var_valid[b.var_ids], m, np.float32(1e9)))
    return out


def kernel_walk(flat, perm, offsets, buckets, var_costs, reverse=False,
                bucket_form=True):
    """What csrc/segment_sum.cu computes, as numpy float32: per variable,
    +0.0 plus each CSR edge's message row, one add at a time, a separate
    bucket's rows (``separate_buckets``: the odd ones unless XLA merged
    them) into a sum of their own that is added when the walk leaves the
    bucket (``bucket_form=False``: all into one sum)."""
    sep = separate_buckets(list(buckets), var_costs.shape[0])

    def own(b):
        return (sep >> b) & 1

    sums = np.zeros_like(var_costs)
    for v in range(var_costs.shape[0]):
        edges = perm[offsets[v]:offsets[v + 1]]
        acc = np.zeros(var_costs.shape[1], np.float32)
        part = np.zeros_like(acc)
        b = 0
        for e in (edges[::-1] if reverse else edges):
            while bucket_form and e >= buckets[b + 1]:
                if own(b):
                    acc, part = acc + part, np.zeros_like(part)
                b += 1
            if own(b):
                part = part + flat[e]
            else:
                acc = acc + flat[e]
        sums[v] = acc + part if own(b) else acc
    return var_costs + sums, sums


def _check_walk_plain_jax(g, tg, seed):
    f2v = _messages(g, seed)
    d = g.var_costs.shape[1]
    flat = np.concatenate([m.reshape(-1, d) for m in f2v])
    arrays = (tg.agg_perm.numpy(), tg.agg_offsets.numpy(),
              tg.agg_buckets.numpy(), tg.var_costs.numpy())
    walk_b, walk_s = kernel_walk(flat, *arrays)

    plain_b, plain_s = segment_sum_reference(
        torch.from_numpy(flat), tg.agg_perm, tg.agg_offsets, tg.agg_buckets,
        tg.var_costs)
    np.testing.assert_array_equal(plain_s.numpy(), walk_s)
    np.testing.assert_array_equal(plain_b.numpy(), walk_b)

    # The port's aggregate_beliefs (it flattens and concatenates the
    # buckets itself) and the reference jitted as its engine jits it,
    # with the graph an argument, on the same f2v.
    tb, ts = T.aggregate_beliefs(tg, tuple(torch.from_numpy(m) for m in f2v))
    jb, js = jax.jit(J.aggregate_beliefs)(g, tuple(f2v))
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    np.testing.assert_array_equal(ts.numpy(), walk_s)
    return flat, arrays, walk_s


@pytest.mark.parametrize("problem", PROBLEMS)
def test_kernel_walk_equals_plain_and_jax(problem):
    g, tg = _both(problem)
    flat, arrays, walk_s = _check_walk_plain_jax(g, tg, 7)
    if problem == "hub":
        # The order matters at these magnitudes: reversed, the hub's
        # 1,100-term sum rounds differently.
        _, rev_s = kernel_walk(flat, *arrays, reverse=True)
        assert not np.array_equal(rev_s[0], walk_s[0])


@pytest.mark.parametrize("n_buckets", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_walk_equals_jax_across_buckets(n_buckets, seed):
    """Bucket counts 2-6: the odd/even form matches the jitted reference
    where a single running sum over all edges does not."""
    g, tg = array_graphs(n_buckets, seed=seed)
    flat, arrays, walk_s = _check_walk_plain_jax(g, tg, 10 + seed)
    _, one_sum = kernel_walk(flat, *arrays, bucket_form=False)
    assert not np.array_equal(one_sum, walk_s)


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    g, tg = _both("coloring_12_3.yml")
    d = g.var_costs.shape[1]
    flat = torch.from_numpy(np.concatenate(
        [m.reshape(-1, d) for m in _messages(g, 8)]))
    args = (flat, tg.agg_perm, tg.agg_offsets, tg.agg_buckets,
            tg.var_costs)
    before = _build.launch_counts["segment_sum"]
    out = segment_sum(*args)
    ref = segment_sum_reference(*args)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert _build.launch_counts["segment_sum"] == before


def _valid_args(n_vars=5, d=3):
    perm = torch.tensor([1, 0, 3, 2], dtype=torch.int32)
    offsets = torch.tensor([0, 2, 2, 3, 3, 4, 4], dtype=torch.int32)
    buckets = torch.tensor([0, 2, 4], dtype=torch.int32)
    return [torch.zeros((4, d)), perm, offsets, buckets,
            torch.zeros((n_vars + 1, d))]


@pytest.mark.parametrize("bad,err", [
    ("msgs_dtype", TypeError), ("perm_dtype", TypeError),
    ("offsets_dtype", TypeError), ("buckets_dtype", TypeError),
    ("costs_dtype", TypeError), ("msgs_shape", ValueError),
    ("perm_shape", ValueError), ("offsets_shape", ValueError),
    ("buckets_shape", ValueError), ("costs_rank", ValueError),
    ("non_contiguous", ValueError), ("device_mismatch", ValueError),
    ("unsupported_device", ValueError),
])
def test_wrapper_refuses(bad, err):
    args = _valid_args()
    segment_sum(*args)          # the unaltered arguments are taken
    if bad == "msgs_dtype":
        args[0] = args[0].double()
    elif bad == "perm_dtype":
        args[1] = args[1].long()
    elif bad == "offsets_dtype":
        args[2] = args[2].long()
    elif bad == "buckets_dtype":
        args[3] = args[3].long()
    elif bad == "costs_dtype":
        args[4] = args[4].half()
    elif bad == "msgs_shape":
        args[0] = torch.zeros((4, 2))
    elif bad == "perm_shape":
        args[1] = args[1].reshape(2, 2)
    elif bad == "offsets_shape":
        args[2] = args[2][:-1].contiguous()
    elif bad == "buckets_shape":
        args[3] = args[3][:1].contiguous()
    elif bad == "costs_rank":
        args[4] = args[4].reshape(-1)
    elif bad == "non_contiguous":
        args[0] = torch.zeros((3, 4)).t()
        assert args[0].shape == (4, 3) and not args[0].is_contiguous()
    elif bad == "device_mismatch":
        args[1] = args[1].to("meta")
    else:
        args = [a.to("meta") for a in args]
    with pytest.raises(err):
        segment_sum(*args)


KW = dict(damping=0.5, damp_vars=True, damp_factors=True, stability=0.1)


def _sensitive_state(g, seed):
    """A mid-run state whose messages span seven decades, as numpy."""
    rng = np.random.default_rng(seed)
    v2f, f2v = _messages(g, seed), _messages(g, seed + 1)
    counts = [rng.integers(0, 6, size=b.var_ids.shape).astype(np.int8)
              for b in g.buckets]
    return dict(v2f=v2f, f2v=f2v, v2f_count=counts,
                f2v_count=[c[::-1].copy() for c in counts],
                stable=False, cycle=3)


@pytest.mark.parametrize("problem", ["mixed30", "buckets4"])
def test_jitted_loop_from_sensitive_state(problem):
    """The reference's jitted superstep and its jitted solve loop
    (``lax.while_loop``), with the graph an argument as its engine
    passes it, sum in the same bucket form as a lone jitted
    aggregate_beliefs: 10 cycles from a state whose sums are
    order-sensitive end in the same state and values on both sides.
    (Closed over as constants, the graph lets XLA fold var_to_factor's
    division by the valid-slot count into another rounding.)"""
    g, tg = _both(problem) if problem == "mixed30" else array_graphs(4)
    s = _sensitive_state(g, 21)
    js = J.MaxSumState(**{k: (tuple(jax.numpy.asarray(a) for a in v)
                              if isinstance(v, list) else jax.numpy.asarray(v))
                          for k, v in s.items()})
    js = js._replace(cycle=js.cycle.astype(jax.numpy.int32))
    ts = state_from_numpy(**s, device="cpu")
    one = jax.jit(lambda st, gr: J.superstep(st, gr, **KW))(js, g)
    _same_state(one, T.superstep(ts, tg, **KW))
    run = jax.jit(lambda gr, st: J.run_maxsum_from(
        gr, st, 10, stop_on_convergence=False, **KW))
    (jstate, jvals), (tstate, tvals) = run(g, js), T.run_maxsum_from(
        tg, ts, 10, stop_on_convergence=False, **KW)
    _same_state(jstate, tstate)
    np.testing.assert_array_equal(np.asarray(jvals), tvals.numpy())


def _same_state(jstate, tstate):
    tn = state_to_numpy(tstate)
    for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
        for a, b in zip(getattr(jstate, field), tn[field]):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=field)
    assert bool(jstate.stable) == tn["stable"]
    assert int(jstate.cycle) == tn["cycle"]


def _random_bucket_graph(trial):
    """A graph of 2-5 buckets (arity 1, 2, ...) whose sizes straddle
    V + 1, so that XLA merges some buckets' scatters and not others;
    every tenth row padding; D in {1, 3, 5}."""
    rng = np.random.default_rng(1000 + trial)
    n_vars = int(rng.integers(20, 200))
    d = int(rng.choice([1, 3, 5]))
    buckets = []
    for arity in range(1, int(rng.integers(2, 6)) + 1):
        f = int(rng.integers(1, max(2, n_vars // (arity + 1) + 10)))
        ids = rng.integers(0, n_vars, size=(f, arity)).astype(np.int32)
        ids[-(f // 10 or 1):] = n_vars
        buckets.append((np.zeros((f,) + (d,) * arity, np.float32), ids))
    var_costs = (rng.normal(size=(n_vars + 1, d)) * 10).astype(np.float32)
    var_valid = np.ones_like(var_costs, bool)
    g = CompiledFactorGraph(var_costs, var_valid,
                            tuple(FactorBucket(c, i) for c, i in buckets))
    return g, graph_from_numpy(var_costs, var_valid, buckets, device="cpu")


@pytest.mark.parametrize("trial", range(16))
def test_bucket_fold_follows_xla_merges(trial):
    """XLA merges the scatter-adds of consecutive buckets into one
    running sum while their edges are fewer than V + 1
    (``separate_buckets``); the port's sums equal the jitted
    reference's on order-sensitive messages, merged or not."""
    g, tg = _random_bucket_graph(trial)
    _check_walk_plain_jax(g, tg, 20 + trial)


def test_bucket_folds_of_the_probed_shapes():
    """The shapes probed against the reference's optimised HLO: two
    buckets of 100 edges at V + 1 = 101 merge (one scatter), at 101
    edges they do not; with none merged the fold is odd/even."""
    assert separate_buckets([0, 50, 100], 101) == 0
    assert separate_buckets([0, 51, 101], 101) == 0b10
    assert separate_buckets([0, 99, 101], 101) == 0b10
    assert separate_buckets([0, 48, 100, 175], 151) == 0b100
    assert separate_buckets([0, 500, 1000, 1500, 2000, 2500], 101) == 0b1010
    assert separate_buckets([0, 10, 30, 60, 100, 150, 210], 1001) == 0
    assert separate_buckets([0, 60, 62, 65, 69, 74], 51) == 0b10
    assert separate_buckets([0, 7], 3) == 0


def test_merged_buckets_in_the_jitted_superstep():
    """The shape of ROADMAP Queue C's first open item (two buckets of
    48 and 52 edges at V + 1 = 151, merged by XLA into one scatter):
    ten supersteps from order-sensitive messages equal the jitted
    reference's, every message."""
    from test_torch_aggregation_options import strategy_graphs

    g, tg = strategy_graphs(2, "scatter", seed=1, d=3)
    assert separate_buckets(tg.agg_buckets.tolist(), 151) == 0
    f2v = _messages(g, 31)
    v2f = _messages(g, 32)
    counts = [np.zeros(b.var_ids.shape, np.int8) for b in g.buckets]
    state = dict(v2f=v2f, f2v=f2v, v2f_count=counts, f2v_count=counts,
                 stable=False, cycle=3)
    js = J.MaxSumState(
        v2f=tuple(jnp.asarray(a) for a in v2f),
        f2v=tuple(jnp.asarray(a) for a in f2v),
        v2f_count=tuple(jnp.asarray(a) for a in counts),
        f2v_count=tuple(jnp.asarray(a) for a in counts),
        stable=jnp.asarray(False), cycle=jnp.asarray(3, jnp.int32))
    ts = state_from_numpy(**state, device="cpu")
    kw = dict(damping=0.5, damp_vars=True, damp_factors=True,
              stability=0.1)
    step = jax.jit(lambda s, gr: J.superstep(s, gr, **kw))
    for _ in range(10):
        js, ts = step(js, g), T.superstep(ts, tg, **kw)
    for name in ("v2f", "f2v", "v2f_count", "f2v_count"):
        for a, b in zip(getattr(js, name), getattr(ts, name)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("d", [27, 28, 30, 32, 33])
def test_domain_mean_after_a_fold_ending_on_its_own(d):
    """Unary factors beside the binary ones (two buckets, the second
    summed on its own): XLA fuses the add of the two scatters into the
    gathers of var_to_factor and LLVM vectorises the domain sum of 28 to
    32 slots (ROADMAP Queue C; the plain left-to-right sum differed from
    cycle 4 at D = 28 and 30, from cycle 10 at D = 32).  Fourteen
    supersteps equal the jitted reference's, every message, at D on both
    sides of that range."""
    from test_torch_prune import KW as PRUNE_KW
    from test_torch_prune import loopy_graphs

    g, tg = loopy_graphs(aggregation="scatter", d=d, seed=0,
                         unary="factors")
    assert len(g.buckets) == 2
    assert T._sums_fused(tg)
    step = jax.jit(lambda s, gr: J.superstep(s, gr, **PRUNE_KW))
    js, ts = J.init_state(g), T.init_state(tg)
    for c in range(14):
        js, ts = step(js, g), T.superstep(ts, tg, **PRUNE_KW)
    for name in ("v2f", "f2v", "v2f_count", "f2v_count"):
        for a, b in zip(getattr(js, name), getattr(ts, name)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=name)
    assert bool(js.stable) == bool(ts.stable)
