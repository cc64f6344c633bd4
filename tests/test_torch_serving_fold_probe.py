"""``engine/batch.py``'s ``stacked_fold`` on the serving plane's flush
shapes, probed against the JAX package's vmapped solve on the CPU.

The service hands ``run_stacked`` three kinds of stack the batch tests
did not hold: bins of one structure padded up the bin ladder from 1 to
16 members (``pad_to_bin`` repeats the last member), envelope-padded
members of different structures (``stack_to_envelope``, then the bin
padding), and such mixed flushes where members carry a one-edge bucket
(a single unary factor: the shape whose belief-sum order XLA moves in a
solo solve but not under ``vmap``).  Each flush is assembled here the
way ``_prepare_stacked`` assembles it in both packages, then the
reference's ``jax.jit(jax.vmap(run_maxsum))`` over the stacked lanes
and the port's disjoint union (``stack_union`` placed with
``member_fold``) run 25 cycles.

What the probe found: a stack of ONE member (a solo request's bin of
one) is not summed in the vmapped order.  XLA drops a batch axis of
one, and the lane's one-edge bucket then moves as in a solo solve, so
``stacked_fold`` gave the one-edge bucket's messages other last bits.
``member_fold`` places a stack of one with the solo fold
(``segment_sum.positional_fold``) and two or more with
``stacked_fold``.

Tolerance: none.  Every lane's values and every final message and
count tensor are equal bit for bit, with the members' costs drawn over
1, 3 and 6 decades (the probe method of the sum-order work: one
decade alone hides orders).
"""

import jax
import numpy as np
import pytest
import torch

import pydcop_tpu.engine.batch as JB
import pydcop_tpu.serving.binning as JBin
import pydcop_tpu_torch.engine.batch as TB
import pydcop_tpu_torch.serving.binning as TBin
from pydcop_tpu.ops import maxsum as JM
from pydcop_tpu_torch.device import to_device_graph
from pydcop_tpu_torch.ops import maxsum as TM
from test_torch_maxsum_lane import bits_equal, port_graph
from test_torch_window_sum_open_shapes import costs, skeleton

CYCLES = 25
DECADES = (1, 3, 6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _cold_dispatch_caches():
    """Both packages' dispatch caches empty before each test."""
    JB._warm.clear()
    TB._warm.clear()


def _drawn(spec, seed, decades):
    """A compiled reference graph of ``spec`` with its costs drawn
    over ``decades`` (bucket costs non-negative, as tables are)."""
    g0 = skeleton(*spec, 1)
    rng = np.random.default_rng(seed)
    return g0._replace(
        var_costs=costs(rng, g0.var_costs.shape, decades),
        buckets=tuple(b._replace(costs=np.abs(costs(rng, b.costs.shape,
                                                    decades)))
                      for b in g0.buckets))


def _covering(graphs):
    """The envelope covering every member (each package's own
    ``envelope_key``, maximised per axis)."""
    envs = [JBin.envelope_key(g) for g in graphs]
    arities = sorted({a for e in envs for a, _ in e.rows})
    rows = tuple((a, max(dict(e.rows).get(a, JBin.DEFAULT_LADDER.rows[0])
                         for e in envs)) for a in arities)
    return JBin.Envelope(max(e.v_env for e in envs),
                         max(e.d_env for e in envs), rows)


def _flush(members, envelope=None):
    """The stack ``_prepare_stacked`` dispatches, in each package:
    envelope padding first, then the bin padding."""
    ref = list(members)
    port = [port_graph(g) for g in members]
    if envelope is not None:
        ref, _ = JB.stack_to_envelope(ref, envelope)
        port, _ = TB.stack_to_envelope(port, TBin.Envelope(*envelope))
    ref, n_ref, _ = JB.pad_to_bin(ref, JB.DEFAULT_BIN_SIZES)
    port, n_port, _ = TB.pad_to_bin(port, TB.DEFAULT_BIN_SIZES)
    assert n_ref == n_port == len(members)
    return ref, port


def _assert_lanes_equal(ref, port):
    def one(g):
        return JM.run_maxsum(g, CYCLES, stop_on_convergence=False)

    rs, rv = jax.jit(jax.vmap(one))(JB.stack_graphs(ref))
    placed = to_device_graph(TB.stack_union(port), "cpu",
                             fold=TB.member_fold(port))
    ps, pv = TM.run_maxsum(placed, CYCLES, stop_on_convergence=False)
    n = len(port)
    rows = port[0].var_costs.shape[0]
    values = torch.cat([pv, pv.new_zeros(1)]).view(n, rows)[:, :-1]
    bits_equal(rv, values)
    for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
        for r, p in zip(getattr(rs, field), getattr(ps, field)):
            bits_equal(r, p.reshape((n,) + tuple(np.asarray(r).shape[1:])))


# One structure with a one-edge bucket beside its binary ring.
BIN_SPEC = (20, [(1, 1), (2, 18)], 3)


@pytest.mark.parametrize("decades", DECADES)
@pytest.mark.parametrize("n_members", [1, 2, 3, 5, 9, 16])
def test_padded_bins_equal_the_vmapped_reference(n_members, decades):
    members = [_drawn(BIN_SPEC, 10 * n_members + s, decades)
               for s in range(n_members)]
    _assert_lanes_equal(*_flush(members))


# Mixed flushes: different structures under one envelope (the service
# groups members of one arity set: ``binning.envelope_key``), some
# with a one-edge bucket, some with every bucket of one edge.
MIXED_FLUSHES = {
    "one_edge_unary": [(12, [(1, 1), (2, 10)], 3), (9, [(1, 3), (2, 8)], 3),
                       (15, [(1, 1), (2, 14)], 3)],
    "one_edge_every_bucket": [(9, [(1, 1), (2, 1), (3, 1)], 3),
                              (7, [(1, 2), (2, 6), (3, 1)], 3),
                              (11, [(1, 1), (2, 9), (3, 2)], 2)],
    "binary_only": [(10, [(2, 9)], 2), (8, [(2, 7)], 5),
                    (6, [(2, 5)], 4), (13, [(2, 12)], 3), (5, [(2, 1)], 3)],
    "domains": [(10, [(1, 1), (2, 9)], 2), (8, [(1, 1), (2, 7)], 5),
                (6, [(1, 2), (2, 5)], 4), (13, [(1, 1), (2, 12)], 3),
                (5, [(1, 1), (2, 4)], 3)],
}


@pytest.mark.parametrize("decades", DECADES)
@pytest.mark.parametrize("flush", sorted(MIXED_FLUSHES))
def test_envelope_flushes_equal_the_vmapped_reference(flush, decades):
    specs = MIXED_FLUSHES[flush]
    members = [_drawn(spec, 7 * i + decades, decades)
               for i, spec in enumerate(specs)]
    env = _covering(members)
    _assert_lanes_equal(*_flush(members, env))


def test_prepared_stacks_use_member_fold():
    """``_prepare_stacked`` (every served stack) places a stack of one
    with the solo fold and a wider one with ``stacked_fold`` — also
    after bin padding turns one request into a wider stack."""
    g = port_graph(_drawn(BIN_SPEC, 0, 3))
    args = (40, 0.5, "both", 0.1)
    assert TB._prepare_stacked([g], *args, None, False, None).fold is None
    assert TB._prepare_stacked([g], *args, (2,), False, None).fold == \
        TB.stacked_fold(g)
    assert TB._prepare_stacked([g, g, g], *args, None, False,
                               None).fold == TB.stacked_fold(g)
