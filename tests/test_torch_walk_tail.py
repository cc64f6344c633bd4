"""The plain belief sum's tail (``ops/segment_sum.py::_walk``): once a
few rows of high degree are left — a hub, or a padded graph's sentinel
row, as every shard of the partitioned engine has — each row finishes in
one sequential float32 accumulate instead of one rank at a time.

Tolerance: none.  The tail gives the rank-by-rank walk's bits (and so
the reference's, which the rank walk is held to elsewhere) on hubs of
hundreds of edges, over seven decades, with signed zeros, with messages
whose partial sums fall among the subnormals (the add-by-add fallback),
in ``segment_sum_reference``, ``positional_sum_reference`` (a non-zero
start) and ``subset_sum_reference``; the sharded engine's CPU run is
unchanged by it.
"""

import numpy as np
import pytest
import torch

import pydcop_tpu_torch.ops.segment_sum as seg

FLT_MIN = np.finfo(np.float32).tiny


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _hub_case(seed, n_vars=60, hubs=(700, 300, 90), d=3, tiny=False):
    rng = np.random.default_rng(seed)
    ids = list(rng.integers(0, n_vars, size=2 * n_vars))
    for h, deg in enumerate(hubs):
        ids += [n_vars - 1 - h] * deg
    ids = np.asarray(ids)
    rng.shuffle(ids)
    n_edges = ids.shape[0]
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    offsets = np.searchsorted(ids[perm], np.arange(n_vars + 2),
                              side="left").astype(np.int32)
    scale = 10.0 ** rng.integers(-3, 4, size=(n_edges, d))
    msgs = (rng.normal(size=(n_edges, d)) * scale).astype(np.float32)
    msgs[::13] = -0.0
    if tiny:
        msgs = (rng.choice([-1.0, 1.0], size=(n_edges, d))
                * rng.uniform(1.0, 1.5, size=(n_edges, d))
                * FLT_MIN).astype(np.float32)
    return (torch.from_numpy(msgs), torch.from_numpy(perm),
            torch.from_numpy(offsets))


def _rank_walk(monkeypatch, fn):
    monkeypatch.setattr(seg, "TAIL_ROWS", -1)
    try:
        return fn()
    finally:
        monkeypatch.undo()


def _bits(x):
    return x.numpy().view(np.int32)


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_tail_equals_the_rank_walk(monkeypatch, seed, tiny):
    msgs, perm, offsets = _hub_case(seed, tiny=tiny)
    n_rows = offsets.shape[0] - 1
    var_costs = torch.zeros((n_rows, msgs.shape[1]))
    one = torch.tensor([0, msgs.shape[0]], dtype=torch.int32)
    init = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n_rows, msgs.shape[1])).astype(np.float32))

    def run():
        return (seg.segment_sum_reference(msgs, perm, offsets, one,
                                          var_costs),
                seg.positional_sum_reference(msgs, perm, offsets, one,
                                             init),
                seg.subset_sum_reference(msgs, perm[::2].contiguous(),
                                         torch.div(offsets, 2,
                                                   rounding_mode="floor")))

    (b, s), p, q = run()
    (rb, rs), rp, rq = _rank_walk(monkeypatch, run)
    for a, r in ((b, rb), (s, rs), (p, rp), (q, rq)):
        assert np.array_equal(_bits(a), _bits(r))


def test_tail_triggers_and_falls_back_on_subnormal_chains(monkeypatch):
    """The hubs go through ``_finish_row``; a chain of subnormal-sized
    partial sums takes its add-by-add form."""
    calls = []
    real = seg._finish_row
    monkeypatch.setattr(seg, "_finish_row",
                        lambda *a: calls.append(a[3] - a[2]) or real(*a))
    msgs, perm, offsets = _hub_case(0, tiny=True)
    n_rows = offsets.shape[0] - 1
    one = torch.tensor([0, msgs.shape[0]], dtype=torch.int32)
    seg.segment_sum_reference(msgs, perm, offsets, one,
                              torch.zeros((n_rows, 3)))
    assert len(calls) >= 2 and max(calls) > 600
