"""The lane layout's variable-side entries (pydcop_tpu_torch/ops/
lane_var_update.py) against the JAX package's lane superstep
(pydcop_tpu/ops/maxsum_lane.py), on the CPU.

Tolerance: none.  Every comparison is bit-equality (``uint32`` views of
float32).  The reference's superstep is jitted with the graph as an
argument, as its engine runs it; the plain versions of both entries
(``lane_v2f_update_reference``, ``lane_send_update_reference``, what
the kernels of ``csrc/lane_var_update.cu`` are held to on the card) are
fed the port's own belief table and factor candidates and must give
every message, count and the ``stable`` flag of the reference's next
state: at D in {1, 2, 3, 8, 11, 28, 31, 32, 33}, damping 0, 0.5 and 0.7,
the first cycle, a state a few cycles into a run (suppressed edges,
counts at SAME_COUNT), a state with subnormal messages, padding edges on
the sentinel variable and graphs of several buckets.  At D = 28..32 the
domain mean is summed left to right, not in the edge layout's
vectorised ``fused`` forms (which the lane reference does not take).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.ops import maxsum_lane as JL
from pydcop_tpu_torch.engine.convert import lane_state_from_numpy
from pydcop_tpu_torch.ops import maxsum_lane as TL
from pydcop_tpu_torch.ops.lane_var_update import (
    lane_send_update,
    lane_send_update_reference,
    lane_v2f_update,
    lane_v2f_update_reference,
)
from test_torch_maxsum_lane import bits_equal, drawn_lane, port_lane
from test_torch_var_update import tiny_state
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


DOMAINS = [1, 2, 3, 8, 11, 28, 31, 32, 33]
CASES = [(0.5, "first"), (0.5, "mid"), (0.7, "mid"), (0.0, "mid"),
         (0.5, "tiny"), (0.7, "tiny")]


def spec(d):
    if d <= 8:
        return 12, [(1, 3), (2, 15), (3, 4)]
    if d <= 11:
        return 14, [(2, 20), (3, 3)]
    return 9, [(1, 2), (2, 12)]


def padded(lane, n=2):
    """``lane`` with ``n`` padding factors on the sentinel variable
    appended to every bucket."""
    v = lane.n_vars
    buckets = []
    for b in lane.buckets:
        ids = np.asarray(b.var_ids)
        costs = np.asarray(b.costs)
        buckets.append(b._replace(
            var_ids=np.concatenate(
                [ids, np.full((ids.shape[0], n), v, ids.dtype)], 1),
            costs=np.concatenate(
                [costs, np.zeros(costs.shape[:-1] + (n,), costs.dtype)], -1)))
    return lane._replace(buckets=tuple(buckets))


def _states(lane, kind, step, d, seed):
    """The reference state of ``kind`` and its port copy."""
    if kind == "tiny":
        v, buckets = spec(d)
        edge = skeleton(v, buckets, d, seed)
        edge = edge._replace(var_valid=np.asarray(lane.var_valid).T,
                             buckets=tuple(
                                 b._replace(var_ids=np.asarray(lb.var_ids).T)
                                 for b, lb in zip(edge.buckets, lane.buckets)))
        s = tiny_state(edge, seed)
        rstate = JL.LaneState(
            v2f=tuple(jnp.asarray(np.transpose(m, (2, 1, 0)))
                      for m in s["v2f"]),
            f2v=tuple(jnp.asarray(np.transpose(m, (2, 1, 0)))
                      for m in s["f2v"]),
            v2f_count=tuple(jnp.asarray(c.T) for c in s["v2f_count"]),
            f2v_count=tuple(jnp.asarray(c.T) for c in s["f2v_count"]),
            stable=jnp.asarray(False), cycle=jnp.asarray(3, jnp.int32))
    else:
        rstate = JL.init_state(lane)
        if kind == "mid":
            for _ in range(9):
                rstate = step(rstate, lane)
    pstate = lane_state_from_numpy(
        *[[np.asarray(x) for x in f] for f in rstate[:4]],
        stable=bool(rstate.stable), cycle=int(rstate.cycle), device="cpu")
    return rstate, pstate


@pytest.mark.parametrize("damping,kind", CASES)
@pytest.mark.parametrize("d", DOMAINS)
def test_entries_equal_the_reference_superstep(d, damping, kind):
    v, buckets = spec(d)
    lane = padded(drawn_lane(v, buckets, d, d))
    kw = dict(damping=damping, damp_vars=True, damp_factors=True,
              stability=0.1)
    step = jax.jit(partial(JL.superstep, **kw))
    rstate, pstate = _states(lane, kind, step, d, d)
    want = step(rstate, lane)
    pg = port_lane(lane)
    table = TL.aggregate_table(pg, pstate.f2v)
    f2v_cand = TL.factor_to_var(pg, pstate.v2f)
    stable = pstate.cycle != 0
    suppressed = 0
    for i, b in enumerate(pg.buckets):
        args = (b.var_ids, pg.var_valid, pstate.cycle, stable)
        sent, cnt = lane_send_update_reference(
            f2v_cand[i], pstate.f2v[i], pstate.f2v_count[i], *args,
            damping=damping, stability=0.1)
        bits_equal(want.f2v[i], sent)
        bits_equal(want.f2v_count[i], cnt)
        sent, cnt = lane_v2f_update_reference(
            table, pstate.f2v[i], pstate.v2f[i], pstate.v2f_count[i], *args,
            damping=damping, stability=0.1)
        bits_equal(want.v2f[i], sent)
        bits_equal(want.v2f_count[i], cnt)
        suppressed += int((np.asarray(want.v2f_count[i]) > 4).sum())
    assert bool(stable) == bool(want.stable)
    if kind == "mid" and d <= 3:
        assert suppressed > 0
    got = TL.superstep(pstate, pg, **kw)
    for rf, pf in zip(want[:4], got[:4]):
        for r, p in zip(rf, pf):
            bits_equal(r, p)
    assert bool(got.stable) == bool(want.stable)
    assert int(got.cycle) == int(want.cycle)


@pytest.mark.parametrize("d", [3, 33])
def test_wrappers_run_the_plain_versions_on_the_cpu(d):
    v, buckets = spec(d)
    lane = drawn_lane(v, buckets, d, 1)
    pg = port_lane(lane)
    state = TL.init_state(pg)
    for _ in range(3):
        state = TL.superstep(state, pg, damping=0.5, damp_vars=True,
                             damp_factors=True, stability=0.1)
    table = TL.aggregate_table(pg, state.f2v)
    b = pg.buckets[-1]
    for entry, ref, lead in (
            (lane_v2f_update, lane_v2f_update_reference,
             (table, state.f2v[-1])),
            (lane_send_update, lane_send_update_reference,
             (state.f2v[-1],))):
        flags = [torch.ones((), dtype=torch.bool) for _ in range(2)]
        outs = [fn(*lead, state.v2f[-1], state.v2f_count[-1], b.var_ids,
                   pg.var_valid, state.cycle, flag, damping=0.7,
                   stability=0.1)
                for fn, flag in ((entry, flags[0]), (ref, flags[1]))]
        for x, y in zip(*outs):
            bits_equal(x.numpy(), y)
        assert bool(flags[0]) == bool(flags[1])


def test_placement_edge_valid_bits():
    lane = padded(drawn_lane(12, [(1, 3), (2, 15), (3, 4)], 5, 3))
    valid = np.asarray(lane.var_valid)
    valid[1:, 4] = False
    lane = lane._replace(var_valid=valid)
    pg = port_lane(lane)
    for b in pg.buckets:
        ids = b.var_ids.numpy()
        want = sum((valid[k][ids].astype(np.uint8) << k)
                   for k in range(valid.shape[0]))
        np.testing.assert_array_equal(b.edge_valid.numpy(), want)
        np.testing.assert_array_equal(b.var_ids32.numpy(), ids)
    wide = port_lane(drawn_lane(9, [(2, 12)], 11, 3))
    assert all(b.edge_valid is None for b in wide.buckets)


def test_entries_refuse_bad_input():
    lane = drawn_lane(12, [(2, 15)], 3, 3)
    pg = port_lane(lane)
    state = TL.init_state(pg)
    b = pg.buckets[0]
    table = TL.aggregate_table(pg, state.f2v)
    args = (state.v2f[0], state.v2f_count[0], b.var_ids, pg.var_valid,
            state.cycle, torch.ones((), dtype=torch.bool))
    with pytest.raises(ValueError, match="table"):
        lane_v2f_update(table[:, :3].contiguous(), state.f2v[0], *args,
                        damping=0.5, stability=0.1)
    with pytest.raises(TypeError, match="int8"):
        lane_send_update(state.f2v[0], state.v2f[0],
                         state.v2f_count[0].to(torch.int32), *args[2:],
                         damping=0.5, stability=0.1)
    with pytest.raises(ValueError, match="D, arity, F"):
        lane_send_update(state.f2v[0], state.v2f[0], state.v2f_count[0],
                         b.var_ids.t().contiguous(), *args[3:],
                         damping=0.5, stability=0.1)
