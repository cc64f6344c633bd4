"""Each function of pydcop_tpu_torch/ops/maxsum.py against its JAX
counterpart in pydcop_tpu/ops/maxsum.py, on the same compiled graph and
the same state (carried across as numpy by engine/convert.py).

Tolerance: none — every comparison is ``np.array_equal``.  The port keeps
the reference's operation order everywhere, and on the CPU both
backends add in the same sequence.  The reference side is jitted where
its solve loop is: XLA folds the per-bucket segment sums into one
accumulation in bucket order, which the port reproduces (eager JAX
rounds differently on multi-bucket graphs).  Damping by 0.5 keeps the
multiplies exact, so an FMA contraction rounds identically.  The only
sum whose order legitimately differs is ``assignment_constraint_cost``'s
reduction over factors; it is checked on integer-valued tables, where
every order is exact.
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
from pydcop_tpu_torch.ops import maxsum as T
from test_torch_compile import MIXED_YAML, build_coloring_both, load_both

KW = dict(damping=0.5, damp_vars=True, damp_factors=True, stability=0.1)


def _graphs(name):
    """(JAX numpy graph, port graph on the CPU) for one test problem."""
    if name == "mixed":
        jax_dcop = load_both(MIXED_YAML)[0]
    elif name == "coloring300":
        jax_dcop = build_coloring_both(300)[0]
    else:
        jax_dcop = load_both(name)[0]
    g, _ = jax_compile(jax_dcop, noise_level=0.01)
    tg = graph_from_numpy(g.var_costs, g.var_valid,
                          [(b.costs, b.var_ids) for b in g.buckets], "cpu")
    return g, tg


def _random_state(g, seed, cycle=3):
    """A mid-run state: random messages (BIG on invalid slots, like the
    real ones) and random SAME_COUNT counters, as numpy."""
    rng = np.random.default_rng(seed)
    d = g.var_costs.shape[1]
    v2f, f2v, vc, fc = [], [], [], []
    for b in g.buckets:
        valid = g.var_valid[b.var_ids]
        for out in (v2f, f2v):
            m = rng.normal(size=b.var_ids.shape + (d,)).astype(np.float32)
            out.append(np.where(valid, m, np.float32(1e9)))
        vc.append(rng.integers(0, 6, size=b.var_ids.shape).astype(np.int8))
        fc.append(rng.integers(0, 6, size=b.var_ids.shape).astype(np.int8))
    return dict(v2f=v2f, f2v=f2v, v2f_count=vc, f2v_count=fc,
                stable=False, cycle=cycle)


def _jax_state(s):
    return J.MaxSumState(
        v2f=tuple(jnp.asarray(a) for a in s["v2f"]),
        f2v=tuple(jnp.asarray(a) for a in s["f2v"]),
        v2f_count=tuple(jnp.asarray(a) for a in s["v2f_count"]),
        f2v_count=tuple(jnp.asarray(a) for a in s["f2v_count"]),
        stable=jnp.asarray(s["stable"]),
        cycle=jnp.asarray(s["cycle"], jnp.int32),
    )


def _eq(jax_out, torch_out):
    if isinstance(jax_out, (tuple, list)):
        assert len(jax_out) == len(torch_out)
        for a, b in zip(jax_out, torch_out):
            _eq(a, b)
        return
    a = np.asarray(jax_out)
    b = torch_out.numpy() if isinstance(torch_out, torch.Tensor) \
        else np.asarray(torch_out)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


PROBLEMS = ["mixed", "loft_scene.yml", "coloring300"]


@pytest.mark.parametrize("problem", PROBLEMS)
def test_factor_to_var(problem):
    g, tg = _graphs(problem)
    s = _random_state(g, 1)
    _eq(J.factor_to_var(g, tuple(s["v2f"])),
        T.factor_to_var(tg, state_from_numpy(**s, device="cpu").v2f))


def test_factor_to_var_covers_arities_one_two_three():
    g, _ = _graphs("mixed")
    assert [b.var_ids.shape[1] for b in g.buckets] == [1, 2, 3]


@pytest.mark.parametrize("problem", PROBLEMS)
def test_aggregate_beliefs_and_var_to_factor(problem):
    g, tg = _graphs(problem)
    s = _random_state(g, 2)
    ts = state_from_numpy(**s, device="cpu")
    # Jitted, as the reference's solve loop runs it: XLA then folds the
    # per-bucket segment sums into one accumulation in bucket order.
    jb, js = jax.jit(lambda f: J.aggregate_beliefs(g, f))(tuple(s["f2v"]))
    tb, tsum = T.aggregate_beliefs(tg, ts.f2v)
    _eq((jb, js), (tb, tsum))
    _eq(J.var_to_factor(g, tuple(s["f2v"]), jb, js),
        T.var_to_factor(tg, ts.f2v, tb, tsum))


def test_aggregate_beliefs_constraint_free():
    g, tg = _graphs("mixed")
    g = g._replace(buckets=())
    tg = tg._replace(buckets=())
    _eq(J.aggregate_beliefs(g, ()), T.aggregate_beliefs(tg, ()))


@pytest.mark.parametrize("damping", [0.5, 0.7, 0.9, 0.25, 0.95, 0.1])
@pytest.mark.parametrize("first", [False, True])
def test_damp(first, damping):
    """Damping 0.5 (the default) and, since the recovery ladder bumps
    it, other values: XLA:CPU fuses the reference's multiply-add into
    one rounding, which the port reproduces bit for bit."""
    g, _ = _graphs("mixed")
    a, b = _random_state(g, 3), _random_state(g, 4)
    new = tuple(a["v2f"])
    old = tuple(b["v2f"])
    damp = jax.jit(partial(J._damp, damping=damping))
    _eq(damp(new, old, first=jnp.asarray(first)),
        T._damp(tuple(torch.from_numpy(x) for x in new),
                tuple(torch.from_numpy(x) for x in old), damping,
                torch.tensor(first)))


@pytest.mark.parametrize("damping", [0.5, 0.7, 0.25])
def test_damped_messages_decaying_to_zero_flush_like_the_reference(damping):
    """Messages of 1.3e-38 .. 1e-36 (normal, as in every state the port
    carries: its candidates are flushed) damped into the subnormal
    range: the reference runs with subnormals flushed to zero (XLA:CPU's
    FTZ/DAZ), and the port's damped candidates, flushed to zeros of
    their sign, carry the same bits."""
    g, _ = _graphs("mixed")
    rng = np.random.default_rng(13)
    msgs = []
    for seed in (5, 6):
        m = tuple(_random_state(g, seed)["v2f"])
        for a in m:
            tiny = rng.random(a.shape) < 0.7
            a[tiny] = np.sign(a[tiny]) * 10.0 ** rng.uniform(
                -37.9, -36, tiny.sum())
            a[rng.random(a.shape) < 0.1] = 0.0
        msgs.append(m)
    new, old = msgs
    damp = jax.jit(partial(J._damp, damping=damping))
    ref = damp(new, old, first=jnp.asarray(False))
    out = T._flush_subnormals(T._damp(
        tuple(torch.from_numpy(x) for x in new),
        tuple(torch.from_numpy(x) for x in old), damping,
        torch.tensor(False)))
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                      b.numpy().view(np.uint32))
    assert any(np.any(np.asarray(a) == 0) for a in ref)


@pytest.mark.parametrize("first", [False, True])
def test_send_or_suppress(first):
    g, _ = _graphs("coloring300")
    s = _random_state(g, 5)
    rng = np.random.default_rng(6)
    prev = s["v2f"][0]
    # Mix exact repeats, near repeats (within stability) and changes.
    pick = rng.integers(0, 3, size=prev.shape[:2])[..., None]
    cand = np.where(pick == 0, prev,
                    np.where(pick == 1, prev * np.float32(1.01),
                             prev + np.float32(1.0))).astype(np.float32)
    valid = g.var_valid[g.buckets[0].var_ids]
    count = s["v2f_count"][0]
    ref = J._send_or_suppress(cand, prev, count, 0.1, valid,
                              jnp.asarray(first))
    out = T._send_or_suppress(
        torch.from_numpy(cand), torch.from_numpy(prev),
        torch.from_numpy(count), 0.1, torch.from_numpy(valid),
        torch.tensor(first))
    _eq(ref, out)
    assert out[1].dtype == torch.int8


def test_select_values_ties_go_to_first_index():
    g, tg = _graphs("mixed")
    v, d = g.var_costs.shape
    beliefs = np.zeros((v, d), np.float32)
    beliefs[0] = [1.0, 0.5, 0.5]      # tie between slots 1 and 2
    beliefs[1] = [2.0, 2.0, 2.0]      # all tied -> 0
    beliefs[2] = [3.0, 3.0, -9.0]     # c has 2 values: slot 2 is invalid
    beliefs[3] = [0.0, -1.0, -1.0]
    ref = np.asarray(J.select_values(g, beliefs))
    out = T.select_values(tg, torch.from_numpy(beliefs)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, [1, 0, 0, 1])
    assert out.dtype == np.int32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assignment_constraint_cost(seed):
    g, tg = _graphs("mixed")
    rng = np.random.default_rng(seed)
    hi = g.var_valid[:-1].sum(axis=1)
    values = (rng.random(len(hi)) * hi).astype(np.int32)
    ref = float(J.assignment_constraint_cost(g, values))
    out = float(T.assignment_constraint_cost(tg, torch.from_numpy(values)))
    assert out == ref


@pytest.mark.parametrize("problem,cycles", [
    ("mixed", 30), ("loft_scene.yml", 30), ("coloring300", 60),
])
def test_superstep_trajectory_from_zero(problem, cycles):
    """N supersteps from zero messages; every field compared after every
    cycle (the JAX side jitted, as the reference's solve loop runs it)."""
    g, tg = _graphs(problem)
    step = jax.jit(lambda s, gr: J.superstep(s, gr, **KW))
    js, ts = J.init_state(g), T.init_state(tg)
    for c in range(cycles):
        js, ts = step(js, g), T.superstep(ts, tg, **KW)
        tn = state_to_numpy(ts)
        for f in ("v2f", "f2v", "v2f_count", "f2v_count"):
            for a, b in zip(getattr(js, f), tn[f]):
                np.testing.assert_array_equal(
                    np.asarray(a), b, err_msg=f"{f} at cycle {c + 1}")
        assert bool(js.stable) == tn["stable"], c
        assert int(js.cycle) == tn["cycle"]


def test_superstep_from_a_carried_state():
    """A mid-run JAX state carried over through engine/convert continues
    identically on both sides."""
    g, tg = _graphs("coloring300")
    s = _random_state(g, 8, cycle=5)
    js, ts = _jax_state(s), state_from_numpy(**s, device="cpu")
    step = jax.jit(lambda s, gr: J.superstep(s, gr, **KW))
    for _ in range(5):
        js, ts = step(js, g), T.superstep(ts, tg, **KW)
    _eq((js.v2f, js.f2v, js.v2f_count, js.f2v_count),
        (ts.v2f, ts.f2v, ts.v2f_count, ts.f2v_count))


@pytest.mark.parametrize("stop", [True, False])
def test_run_maxsum_cycles_and_values(stop):
    g, tg = _graphs("coloring300")
    run = jax.jit(partial(J.run_maxsum, max_cycles=150,
                          stop_on_convergence=stop, **KW))
    jstate, jvals = run(g)
    tstate, tvals = T.run_maxsum(tg, 150, stop_on_convergence=stop, **KW)
    assert int(jstate.cycle) == int(tstate.cycle)
    assert bool(jstate.stable) == bool(tstate.stable)
    np.testing.assert_array_equal(np.asarray(jvals), tvals.numpy())


def test_state_round_trip():
    g, _ = _graphs("mixed")
    s = _random_state(g, 9, cycle=7)
    back = state_to_numpy(state_from_numpy(**s, device="cpu"))
    for f in ("v2f", "f2v", "v2f_count", "f2v_count"):
        _eq(tuple(s[f]), tuple(torch.from_numpy(a) for a in back[f]))
    assert back["cycle"] == 7 and back["stable"] is False
