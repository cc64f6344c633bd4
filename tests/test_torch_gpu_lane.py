"""On the card: the lane layout's belief sum and variable side.

This file imports neither JAX nor the JAX package.  Every test is
marked ``gpu`` and decides inside itself whether a card is present;
without one it skips.  Where JAX is missing run:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu_lane.py

Tolerance: none; every comparison is ``torch.equal`` (bit-equality of
float32, signed zeros included, as the flushed kernels promise).

- ``csrc/lane_sum.cu`` (the row stage and the walk) equals its plain
  version at D = 1..8, 11 and 33, on one to three buckets with a hub
  above ``HEAVY_DEGREE`` (a warp of its own) and one-edge buckets, with
  subnormal messages and on message views off a 16-byte boundary; its
  ``from_costs`` mode (``lane_beliefs``) too, and without the hub list
  (every variable one thread).
- Both entries of ``csrc/lane_var_update.cu`` equal their plain versions
  at the same domains, at damping 0, 0.5 and 0.7, at cycle 0 and 3, with
  suppressed edges, padding edges and a subnormal state; ``stable`` as
  the plain versions leave it; a CUDA call without the placement arrays
  raises.
- Whole lane runs (``run_maxsum`` with and without the early stop, at
  damping 0, 0.5 and 0.7, and the cost trace) give on the card what
  they give on the CPU, and the lane superstep launches ``lane_sum``
  once and each entry once a bucket a cycle.
"""

import numpy as np
import pytest
import torch

from pydcop_tpu_torch.engine.compile import BIG
from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops import maxsum_lane as lane_ops
from pydcop_tpu_torch.ops.lane_sum import (
    KERNEL as LANE_SUM,
    lane_beliefs,
    lane_beliefs_reference,
    heavy_variables,
    lane_order,
    lane_sum_reference,
    lane_sum_table,
    padded_table,
    row_floats,
)
from pydcop_tpu_torch.ops.lane_var_update import (
    SEND,
    V2F,
    lane_send_update,
    lane_send_update_reference,
    lane_v2f_update,
    lane_v2f_update_reference,
)
from test_torch_gpu_batch import _costs, _lane_graph, ring


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


DOMAINS = [1, 2, 3, 4, 5, 6, 7, 8, 11, 33]


def _tiny(rng, m, share=0.5):
    t = rng.random(m.shape) < share
    m[t] = (np.sign(m[t]) * 10.0 ** rng.uniform(-37.9, -36, t.sum())
            ).astype(np.float32)
    return m


def _parts(d, buckets, n_rows, seed, tiny=False):
    """Random lane buckets over ``n_rows`` variables: ids with a hub of
    degree above HEAVY_DEGREE, messages [D, a, F] (subnormal halves with
    ``tiny``), and var_costs [D, n_rows]."""
    rng = np.random.default_rng(seed)
    ids, msgs = [], []
    for a, f in buckets:
        v = rng.integers(0, n_rows, size=(a, f)).astype(np.int64)
        if f > 4:
            v[0, :f // 2] = 1            # the hub
        ids.append(v)
        m = _costs(rng, (d, a, f))
        msgs.append(_tiny(rng, m) if tiny else m)
    return ids, msgs, _costs(rng, (d, n_rows))


def _card_views(arrays, offset):
    """Each array on the card, as a view ``offset`` floats into a larger
    buffer when ``offset`` > 0 (off a 16-byte boundary)."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)).cuda()
        if offset:
            buf = torch.empty(t.numel() + offset, dtype=t.dtype,
                              device="cuda")
            buf[offset:] = t.reshape(-1)
            t = buf[offset:].view(t.shape)
        out.append(t)
    return out


SUM_CASES = [([(2, 300)], 0), ([(1, 1), (2, 140), (3, 1)], 1),
             ([(2, 1), (3, 160)], 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("buckets,offset", SUM_CASES)
@pytest.mark.parametrize("d", DOMAINS)
def test_lane_sum_equals_plain(d, buckets, offset, tiny):
    _need_card()
    n_rows = 97
    ids, msgs, var_costs = _parts(d, buckets, n_rows, d, tiny)
    perm, offsets, starts = lane_order(ids, n_rows)
    heavy = heavy_variables(offsets)
    assert heavy.tolist()[:1] == [1]
    cpu = [torch.from_numpy(x) for x in (perm, offsets, starts)]
    vc = torch.from_numpy(var_costs)
    beliefs, sums = lane_sum_reference([torch.from_numpy(m) for m in msgs],
                                       *cpu, vc)
    from_costs = lane_beliefs_reference([torch.from_numpy(m) for m in msgs],
                                        *cpu, vc)
    card = _card_views(msgs, offset)
    arrays = [t.cuda() for t in cpu] + [vc.cuda()]
    place = [torch.from_numpy(heavy).cuda()]
    before = _build.launch_counts[LANE_SUM]
    table = lane_sum_table(card, *arrays, *place)
    got = lane_beliefs(card, *arrays, *place)
    bare = lane_sum_table(card, *arrays)
    assert _build.launch_counts[LANE_SUM] == before + 3
    assert torch.equal(table.cpu(), padded_table(beliefs, sums))
    assert torch.equal(bare.cpu(), table.cpu())
    assert torch.equal(got.cpu(), from_costs)


def _bucket(d, a, f, n_rows, seed):
    """One bucket's inputs: ids [a, F] (the last factor padding on the
    sentinel), var_valid [D, V+1] (the sentinel and some slots invalid),
    the placement arrays, and a table [V+1, 2P] (zeros in the pads)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_rows - 1, size=(a, f)).astype(np.int64)
    ids[:, -1] = n_rows - 1
    valid = rng.random((d, n_rows)) < 0.8
    valid[0] = True
    valid[:, -1] = False
    bits = None
    if d <= 8:
        bits = (np.packbits(valid.T, axis=1, bitorder="little")[:, 0]
                [ids]).astype(np.uint8)
    p = row_floats(d)
    table = np.zeros((n_rows, 2 * p), np.float32)
    table[:, :d] = _costs(rng, (n_rows, d))
    table[:, p:p + d] = _costs(rng, (n_rows, d))
    return rng, ids, valid, bits, table


def _state(rng, d, a, f, valid_e, tiny, near=None):
    """Messages f2v, prev [D, a, F] and counts [a, F]; ``near``: prev
    within 1e-3 relative of it on half the edges, so they match."""
    f2v = _costs(rng, (d, a, f))
    prev = _costs(rng, (d, a, f))
    if near is not None:
        close = rng.random((a, f)) < 0.5
        prev = np.where(close[None], near * np.float32(1.0005), prev)
    if tiny:
        f2v, prev = _tiny(rng, f2v), _tiny(rng, prev)
    f2v = np.where(valid_e, f2v, np.float32(BIG)).astype(np.float32)
    prev = np.where(valid_e, prev, np.float32(BIG)).astype(np.float32)
    count = rng.integers(0, 6, size=(a, f)).astype(np.int8)
    return f2v, prev, count


@pytest.mark.gpu
@pytest.mark.parametrize("cycle,tiny", [(0, False), (3, False), (3, True)])
@pytest.mark.parametrize("damping", [0.0, 0.5, 0.7])
@pytest.mark.parametrize("d", DOMAINS)
def test_lane_var_entries_equal_plain(d, damping, cycle, tiny):
    _need_card()
    n_rows, a, f = 61, 2, 700
    rng, ids, valid, bits, table = _bucket(d, a, f, n_rows, d)
    valid_e = valid[:, ids]
    f2v, prev, count = _state(rng, d, a, f, valid_e, tiny)
    # The v2f candidates of the plain version, so half the edges match.
    cpu_cycle = torch.tensor(cycle, dtype=torch.int32)
    cand = lane_v2f_update_reference(
        torch.from_numpy(table), torch.from_numpy(f2v),
        torch.from_numpy(f2v), torch.from_numpy(count),
        torch.from_numpy(ids), torch.from_numpy(valid),
        torch.tensor(1, dtype=torch.int32), torch.ones((), dtype=torch.bool),
        damping=0.0, stability=0.1)[0].numpy()
    for entry, ref, counter, near in (
            (lane_v2f_update, lane_v2f_update_reference, V2F, cand),
            (lane_send_update, lane_send_update_reference, SEND, f2v)):
        _, prev, count = _state(rng, d, a, f, valid_e, tiny, near=near)
        cpu = [torch.from_numpy(x) for x in (f2v, prev, count, ids, valid)]
        cpu.append(cpu_cycle)
        card = [x.cuda() for x in cpu]
        lead = [torch.from_numpy(table)] if entry is lane_v2f_update else []
        stable_cpu = torch.tensor(cycle != 0)
        stable_card = stable_cpu.cuda()
        want = ref(*lead, *cpu, stable_cpu, damping=damping, stability=0.1)
        before = _build.launch_counts[counter]
        got = entry(*[x.cuda() for x in lead], *card, stable_card,
                    damping=damping, stability=0.1,
                    var_ids32=card[3].to(torch.int32),
                    edge_valid=None if bits is None
                    else torch.from_numpy(bits).cuda())
        assert _build.launch_counts[counter] == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        assert bool(stable_card) == bool(stable_cpu)


@pytest.mark.gpu
def test_lane_var_entries_refuse_missing_placement():
    _need_card()
    d, a, f, n_rows = 3, 2, 5, 9
    z = torch.zeros((d, a, f), device="cuda")
    args = (z, z, torch.zeros((a, f), dtype=torch.int8, device="cuda"),
            torch.zeros((a, f), dtype=torch.int64, device="cuda"),
            torch.ones((d, n_rows), dtype=torch.bool, device="cuda"),
            torch.zeros((), dtype=torch.int32, device="cuda"),
            torch.ones((), dtype=torch.bool, device="cuda"))
    table = torch.zeros((n_rows, 2 * d), device="cuda")
    with pytest.raises(ValueError, match="edge_valid"):
        lane_send_update(*args, damping=0.5, stability=0.1)
    with pytest.raises(ValueError, match="var_ids32"):
        lane_v2f_update(table, *args, damping=0.5, stability=0.1)


def _same_state(a, b):
    assert int(a.cycle) == int(b.cycle)
    assert bool(a.stable) == bool(b.stable)
    for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
        for x, y in zip(getattr(a, field), getattr(b, field)):
            assert torch.equal(x.cpu(), y.cpu()), field


@pytest.mark.gpu
@pytest.mark.parametrize("damping", [0.5, 0.7, 0.0])
@pytest.mark.parametrize("stop", [True, False])
def test_lane_runs_card_equal_cpu(stop, damping):
    _need_card()
    dcop = ring(400, 3, 1, chords=60)
    runs = [lane_ops.run_maxsum(_lane_graph(dcop, dev), 60, damping=damping,
                                stop_on_convergence=stop)
            for dev in ("cuda", "cpu")]
    (cs, cv), (ps, pv) = runs
    assert torch.equal(cv.cpu(), pv)
    _same_state(cs, ps)
    card = lane_ops.run_maxsum_trace(_lane_graph(dcop, "cuda"), 25,
                                     damping=damping)
    cpu = lane_ops.run_maxsum_trace(_lane_graph(dcop, "cpu"), 25,
                                    damping=damping)
    assert torch.equal(card[1].cpu(), cpu[1])
    assert np.array_equal(card[2].cpu().numpy().view(np.uint32),
                          cpu[2].numpy().view(np.uint32))


@pytest.mark.gpu
def test_lane_superstep_launches_each_kernel_once_a_bucket():
    _need_card()
    graph = _lane_graph(ring(200, 3, 2, chords=10), "cuda")
    state = lane_ops.init_state(graph)
    kw = dict(damping=0.5, damp_vars=True, damp_factors=True, stability=0.1)
    state = lane_ops.superstep(state, graph, **kw)
    before = dict(_build.launch_counts)
    lane_ops.superstep(state, graph, **kw)
    n = len(graph.buckets)
    for name, want in ((LANE_SUM, 1), (V2F, n), (SEND, n)):
        assert _build.launch_counts[name] - before.get(name, 0) == want


@pytest.mark.gpu
def test_lane_domain_wider_than_the_kernel_raises():
    _need_card()
    d = 257
    z = torch.zeros((d, 1, 2), device="cuda")
    with pytest.raises(ValueError, match="D <= 256"):
        lane_send_update(
            z, z, torch.zeros((1, 2), dtype=torch.int8, device="cuda"),
            torch.zeros((1, 2), dtype=torch.int64, device="cuda"),
            torch.ones((d, 3), dtype=torch.bool, device="cuda"),
            torch.zeros((), dtype=torch.int32, device="cuda"),
            torch.ones((), dtype=torch.bool, device="cuda"), damping=0.5,
            stability=0.1,
            var_ids32=torch.zeros((1, 2), dtype=torch.int32, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("n_vars", [40, 1100])
def test_unit_domain_trace_with_base_costs_card_equals_cpu(n_vars):
    """At D = 1 both layouts' traces add the folded variable-side sum
    (one value: ``window_sum.folded_sum``) to the buckets' total."""
    _need_card()
    from pydcop_tpu_torch.device import to_device_graph
    from pydcop_tpu_torch.engine.compile import compile_dcop
    from pydcop_tpu_torch.ops import maxsum as edge_ops

    dcop = ring(n_vars, 1, 3, chords=5)
    g, meta = compile_dcop(dcop, noise_level=0.01)
    base = torch.from_numpy(_costs(np.random.default_rng(n_vars),
                                   (n_vars, 1), 6))
    runs = []
    for dev in ("cuda", "cpu"):
        lane = lane_ops.run_maxsum_trace(_lane_graph(dcop, dev), 6,
                                         var_base_costs=base.to(dev))
        edge = edge_ops.run_maxsum_trace(to_device_graph(g, dev), 6,
                                         var_base_costs=base.to(dev))
        runs.append([lane[2].cpu(), edge[2].cpu()])
    for card, cpu in zip(*runs):
        assert np.array_equal(card.numpy().view(np.uint32),
                              cpu.numpy().view(np.uint32))
