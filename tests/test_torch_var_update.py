"""The superstep's fused per-edge update (pydcop_tpu_torch/ops/var_update.py)
and the flush-to-zero arithmetic of every plain superstep operation,
against the jitted JAX reference on the same graph and state.

XLA:CPU runs the reference with subnormals flushed to zero at every
operation.  The state here puts about half of all messages in
1.2e-38 .. 1e-36 (normal numbers whose sums, differences and means are
subnormal), and 60 cycles of the reference's jitted solve loop end in
the port's messages, counts and values bit for bit, checked after every
cycle (a differing subnormal can vanish again a few cycles later): under the ``scatter``, ``sorted`` and ``ell`` aggregations, with
branch-and-bound pruning, on arity-3 and arity-4 buckets, on the
D = 28..33 graphs whose domain mean XLA vectorises, and at damping 0.5
and 0.7.  Tolerance: none (the float32 bit patterns are compared).
Before the flush was applied after every operation the port differed
within 12 cycles.  ``boundary`` adds its prefix sum in another order
than XLA's, so there the port is held to the reference's tolerance.

The plain epilogue also equals the reference's ``_damp``,
``_send_or_suppress`` and ``var_to_factor`` chain, and the wrappers run
the plain version on CPU tensors without counting a launch.  The card's
side (the kernel against this plain version, the card's run of the
Queue C state against the CPU's) is in
``tests/test_torch_gpu_determinism.py``, which imports no JAX.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu.ops import maxsum as J
from pydcop_tpu_torch.engine.convert import (
    graph_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops import maxsum as T
from pydcop_tpu_torch.ops import var_update as V
from test_torch_aggregation_options import strategy_graphs
from test_torch_compile import build_coloring_both
from test_torch_prune import loopy_graphs

FLT_MIN = np.finfo(np.float32).tiny
FIELDS = ("v2f", "f2v", "v2f_count", "f2v_count")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def coloring_graphs(aggregation):
    """The 300-variable colouring, compiled by the reference and placed
    for the port from the same arrays."""
    jax_dcop = build_coloring_both(300)[0]
    g, _ = jax_compile(jax_dcop, noise_level=0.01, aggregation=aggregation,
                       use_cache=False)
    tg = graph_from_numpy(g.var_costs, g.var_valid,
                          [(b.costs, b.var_ids) for b in g.buckets], "cpu",
                          aggregation=aggregation)
    return g, tg


def tiny_state(g, seed):
    """A mid-run state (cycle 3) with about half of all messages of
    magnitude 1.2e-38 .. 1e-36, the rest of order 1, some exact zeros,
    BIG on invalid slots, random SAME_COUNT counts; as numpy."""
    rng = np.random.default_rng(seed)
    d = g.var_costs.shape[1]
    out = {f: [] for f in FIELDS}
    for b in g.buckets:
        shape = b.var_ids.shape + (d,)
        valid = g.var_valid[b.var_ids]
        for field in ("v2f", "f2v"):
            m = rng.normal(size=shape)
            tiny = rng.random(shape) < 0.5
            m[tiny] = np.sign(m[tiny]) * 10.0 ** rng.uniform(
                np.log10(FLT_MIN), -36, tiny.sum())
            m[rng.random(shape) < 0.05] = 0.0
            out[field].append(
                np.where(valid, m.astype(np.float32), np.float32(1e9)))
        for field in ("v2f_count", "f2v_count"):
            out[field].append(
                rng.integers(0, 6, size=b.var_ids.shape).astype(np.int8))
    return dict(out, stable=False, cycle=3)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def run_both(g, tg, state, *, cycles=60, chunk=1, prune=False,
             damping=0.5):
    """``cycles`` of the reference's jitted solve loop and of the port's
    from ``state``, compared every ``chunk`` cycles: messages and
    counts bit for bit, then the values."""
    kw = dict(damping=damping, damp_vars=True, damp_factors=True,
              stability=0.1, stop_on_convergence=False, prune=prune)
    run = jax.jit(lambda gr, st: J.run_maxsum_from(gr, st, chunk, **kw))
    js = J.MaxSumState(
        **{f: tuple(jnp.asarray(a) for a in state[f]) for f in FIELDS},
        stable=jnp.asarray(False), cycle=jnp.asarray(3, jnp.int32))
    ts = state_from_numpy(**state, device="cpu")
    for done in range(chunk, cycles + 1, chunk):
        js, jvals = run(g, js)
        ts, tvals = T.run_maxsum_from(tg, ts, chunk, **kw)
        tn = state_to_numpy(ts)
        for f in FIELDS:
            for a, b in zip(getattr(js, f), tn[f]):
                np.testing.assert_array_equal(
                    _bits(b), _bits(a), err_msg=f"{f} after {done} cycles")
        assert bool(js.stable) == tn["stable"]
        np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))


def makes_subnormals(g, state):
    """Whether unflushed float32 arithmetic on ``state`` makes subnormal
    numbers in the first superstep's variable side (numpy keeps them)."""
    sums = np.zeros(g.var_costs.shape, np.float32)
    for b, m in zip(g.buckets, state["f2v"]):
        np.add.at(sums, b.var_ids.reshape(-1), m.reshape(-1, m.shape[-1]))
    found = 0
    for b, m in zip(g.buckets, state["f2v"]):
        x = sums[b.var_ids] - m
        found += int(np.sum((x != 0) & (np.abs(x) < FLT_MIN)))
    return found


@pytest.mark.parametrize("aggregation", ["scatter", "sorted", "ell"])
@pytest.mark.parametrize("damping", [0.5, 0.7])
def test_subnormal_state_equals_jax_on_the_colouring(aggregation, damping):
    g, tg = coloring_graphs(aggregation)
    state = tiny_state(g, 1)
    assert makes_subnormals(g, state) > 0
    run_both(g, tg, state, damping=damping)


@pytest.mark.parametrize("aggregation", ["scatter", "sorted", "ell"])
@pytest.mark.parametrize("damping", [0.5, 0.7])
def test_subnormal_state_equals_jax_on_arity_three_and_four(aggregation,
                                                            damping):
    g, tg = strategy_graphs(4, aggregation, seed=5)
    assert [b.var_ids.shape[1] for b in g.buckets] == [1, 2, 3, 4]
    run_both(g, tg, tiny_state(g, 2), damping=damping)


@pytest.mark.parametrize("damping", [0.5, 0.7])
@pytest.mark.parametrize("aggregation", ["scatter", "sorted"])
def test_subnormal_state_equals_jax_with_pruning(aggregation, damping):
    g, tg = loopy_graphs(aggregation=aggregation, d=16, seed=1,
                         unary="factors")
    assert T.prune_tables(tg)[1] is not None
    run_both(g, tg, tiny_state(g, 3), prune=True, damping=damping)


@pytest.mark.parametrize("d", [28, 30, 32, 33])
@pytest.mark.parametrize("damping", [0.5, 0.7])
def test_subnormal_state_equals_jax_on_the_fold_graphs(d, damping):
    """Unary and binary buckets, the second summed on its own: the
    domain mean is vectorised (D = 28..32) or windowed (D = 33)."""
    g, tg = loopy_graphs(aggregation="scatter", d=d, seed=0,
                         unary="factors")
    assert T._sums_fused(tg)
    run_both(g, tg, tiny_state(g, 4), damping=damping)


def test_subnormal_state_boundary_within_reference_tolerance():
    g, tg = coloring_graphs("boundary")
    state = tiny_state(g, 5)
    kw = dict(damping=0.5, damp_vars=True, damp_factors=True,
              stability=0.1, stop_on_convergence=False)
    js = J.MaxSumState(
        **{f: tuple(jnp.asarray(a) for a in state[f]) for f in FIELDS},
        stable=jnp.asarray(False), cycle=jnp.asarray(3, jnp.int32))
    jstate, _ = jax.jit(lambda gr, st: J.run_maxsum_from(gr, st, 1, **kw))(
        g, js)
    tstate, _ = T.run_maxsum_from(
        tg, state_from_numpy(**state, device="cpu"), 1, **kw)
    for a, b in zip(jstate.v2f, state_to_numpy(tstate)["v2f"]):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("damping", [0.0, 0.5, 0.7, 0.9])
@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("problem", ["colouring", "arity4", "d33"])
def test_plain_v2f_update_equals_jax_chain(problem, first, damping):
    """One bucket's plain v2f_update equals the reference's
    var_to_factor, _damp and _send_or_suppress on that bucket, and its
    stable flag the reference's all-match over live edges."""
    if problem == "colouring":
        g, tg = coloring_graphs("scatter")
    elif problem == "arity4":
        g, tg = strategy_graphs(4, "scatter", seed=6)
    else:
        g, tg = loopy_graphs(aggregation="scatter", d=33, seed=2,
                             unary="factors")
    state = tiny_state(g, 7)
    f2v = tuple(jnp.asarray(a) for a in state["f2v"])
    jb, js = jax.jit(J.aggregate_beliefs)(g, f2v)
    cand = jax.jit(J.var_to_factor)(g, f2v, jb, js)
    jfirst = jnp.asarray(first)
    if damping > 0:
        cand = jax.jit(partial(J._damp, damping=damping))(
            cand, tuple(jnp.asarray(a) for a in state["v2f"]), first=jfirst)
    ts = state_from_numpy(**state, device="cpu")
    ts = ts._replace(cycle=torch.tensor(0 if first else 3, dtype=torch.int32))
    tb, tsum = T.aggregate_beliefs(tg, ts.f2v)
    for i, bucket in enumerate(g.buckets):
        valid = g.var_valid[bucket.var_ids]
        sent, cnt, match = jax.jit(partial(J._send_or_suppress,
                                           stability=0.1))(
            cand[i], state["v2f"][i], state["v2f_count"][i], valid=valid,
            first=jfirst)
        want_stable = (not first) and bool(
            np.all(np.asarray(match) | ~valid.any(-1)))
        stable = ts.cycle != 0
        out, out_cnt = V.v2f_update(
            tb, tsum, ts.f2v[i], ts.v2f[i], ts.v2f_count[i],
            tg.buckets[i].var_ids, tg.var_valid, ts.cycle, stable,
            damping=damping, stability=0.1, fused=T._sums_fused(tg))
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(sent))
        np.testing.assert_array_equal(out_cnt.numpy(), np.asarray(cnt))
        assert bool(stable) == want_stable


@pytest.mark.parametrize("damping", [0.0, 0.5, 0.7])
def test_plain_send_update_equals_jax_chain(damping):
    g, tg = strategy_graphs(3, "scatter", seed=8)
    state = tiny_state(g, 9)
    cand = tuple(jnp.asarray(a) for a in tiny_state(g, 10)["f2v"])
    prev = tuple(jnp.asarray(a) for a in state["f2v"])
    jfirst = jnp.asarray(False)
    if damping > 0:
        cand = jax.jit(partial(J._damp, damping=damping))(
            cand, prev, first=jfirst)
    ts = state_from_numpy(**state, device="cpu")
    tcand = tuple(torch.from_numpy(a) for a in tiny_state(g, 10)["f2v"])
    for i, bucket in enumerate(g.buckets):
        valid = g.var_valid[bucket.var_ids]
        sent, cnt, _ = jax.jit(partial(J._send_or_suppress, stability=0.1))(
            cand[i], prev[i], state["f2v_count"][i], valid=valid,
            first=jfirst)
        stable = torch.tensor(True)
        out, out_cnt = V.send_update(
            tcand[i], ts.f2v[i], ts.f2v_count[i], tg.buckets[i].var_ids,
            tg.var_valid, ts.cycle, stable, damping=damping, stability=0.1)
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(sent))
        np.testing.assert_array_equal(out_cnt.numpy(), np.asarray(cnt))


def test_wrappers_on_cpu_run_the_plain_version_without_launching():
    g, tg = coloring_graphs("scatter")
    ts = state_from_numpy(**tiny_state(g, 11), device="cpu")
    tb, tsum = T.aggregate_beliefs(tg, ts.f2v)
    _build.launch_counts.clear()
    args = (ts.f2v[0], ts.v2f[0], ts.v2f_count[0], tg.buckets[0].var_ids,
            tg.var_valid, ts.cycle)
    a = V.v2f_update(tb, tsum, *args, torch.tensor(True), damping=0.5,
                     stability=0.1)
    b = V.v2f_update_reference(tb, tsum, *args, torch.tensor(True),
                               damping=0.5, stability=0.1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert _build.launch_counts[V.KERNEL] == 0


@pytest.mark.parametrize("bad,err", [
    ("count_dtype", TypeError), ("var_ids_dtype", TypeError),
    ("prev_shape", ValueError), ("stable_shape", ValueError),
    ("non_contiguous", ValueError),
])
def test_wrapper_refuses(bad, err):
    g, tg = coloring_graphs("scatter")
    ts = state_from_numpy(**tiny_state(g, 12), device="cpu")
    cand, prev, cnt = ts.f2v[0], ts.f2v[0].clone(), ts.f2v_count[0]
    ids, stable = tg.buckets[0].var_ids, torch.tensor(True)
    if bad == "count_dtype":
        cnt = cnt.to(torch.int32)
    elif bad == "var_ids_dtype":
        ids = ids.to(torch.int32)
    elif bad == "prev_shape":
        prev = prev[:-1]
    elif bad == "stable_shape":
        stable = torch.ones(2, dtype=torch.bool)
    else:
        prev = prev.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(err):
        V.send_update(cand, prev, cnt, ids, tg.var_valid, ts.cycle, stable,
                      damping=0.5, stability=0.1)
