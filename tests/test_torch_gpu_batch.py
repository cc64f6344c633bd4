"""On the card: the lane layout's kernels and the batched solve.

This file imports neither JAX nor the JAX package.  Every test is
marked ``gpu`` and decides inside itself whether a card is present;
without one it skips.  Where JAX is missing run:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu_batch.py

- The lane entry of ``csrc/binary_factor_update.cu`` equals its plain
  version bit for bit at every D = 1..8 and two generic D, on a ragged
  F and on views off a 16-byte boundary; it raises rather than fall
  back.
- ``csrc/lane_sum.cu`` equals its plain version bit for bit, on one to
  three buckets with one-edge buckets and a hub, with subnormal
  messages.
- A lane solve, ``run_stacked`` (plain and envelope-padded),
  ``run_lane_packed`` and ``launch_*``/``collect_*`` give on the card
  what they give on the CPU: values, cycles, flags, every message.
"""

import numpy as np
import pytest
import torch

import pydcop_tpu_torch.dcop.dcop as dcop_mod
import pydcop_tpu_torch.dcop.objects as objects
import pydcop_tpu_torch.dcop.relations as relations
from pydcop_tpu_torch.device import to_lane_device_graph
from pydcop_tpu_torch.engine import batch
from pydcop_tpu_torch.engine.compile import compile_dcop
from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops import maxsum_lane as lane_ops
from pydcop_tpu_torch.ops.binary_factor import (
    LANE,
    binary_factor_update_lane,
    binary_factor_update_lane_reference,
)
from pydcop_tpu_torch.ops.lane_sum import (
    KERNEL as LANE_SUM,
    lane_order,
    lane_sum,
    lane_sum_reference,
)
from pydcop_tpu_torch.serving import binning


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


def _costs(rng, shape, decades=3):
    return (rng.standard_normal(shape)
            * 10.0 ** rng.uniform(-decades, decades, shape)).astype(
                np.float32)


def ring(n, d, seed, chords=0):
    rng = np.random.default_rng(seed)
    dom = objects.Domain("c", "", list(range(d)))
    dcop = dcop_mod.DCOP(f"ring{n}_{d}_{seed}", objective="min")
    vs = [objects.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    edges = [(i, (i + 1) % n) for i in range(n)]
    edges += [(i, (i + n // 2) % n) for i in range(chords)]
    for k, (i, j) in enumerate(edges):
        table = rng.integers(0, 10, size=(d, d)).astype(float)
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[i], vs[j]], table, f"c{k}"))
    for k in range(0, n - 2, 5):
        table = rng.integers(0, 10, size=(d, d, d)).astype(float)
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[k], vs[k + 1], vs[k + 2]], table, f"t{k}"))
    return dcop


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6, 7, 8, 9, 33])
@pytest.mark.parametrize("f,offset", [(1, 0), (257, 0), (1000, 1),
                                      (33, 3)])
def test_binary_lane_entry_equals_plain(d, f, offset):
    _need_card()
    rng = np.random.default_rng(d * 1000 + f)
    c = torch.from_numpy(_costs(rng, (d, d, f + offset))).cuda()
    m = torch.from_numpy(_costs(rng, (d, 2, f + offset))).cuda()
    # A view at an odd float offset (not 16-byte aligned) when offset > 0.
    c = c[..., offset:].contiguous() if offset == 0 else \
        c.reshape(-1)[offset:offset + d * d * f].view(d, d, f)
    m = m[..., offset:].contiguous() if offset == 0 else \
        m.reshape(-1)[offset:offset + d * 2 * f].view(d, 2, f)
    before = _build.launch_counts[LANE]
    out = binary_factor_update_lane(c, m)
    assert _build.launch_counts[LANE] == before + 1
    ref = binary_factor_update_lane_reference(c.cpu(), m.cpu())
    assert torch.equal(out.cpu(), ref)


@pytest.mark.gpu
def test_binary_lane_entry_refuses_bad_input():
    _need_card()
    c = torch.zeros((3, 3, 5), device="cuda")
    with pytest.raises(ValueError):
        binary_factor_update_lane(c, torch.zeros((3, 2, 4), device="cuda"))
    with pytest.raises(ValueError):
        binary_factor_update_lane(c.transpose(0, 2),
                                  torch.zeros((5, 2, 3), device="cuda"))


def _lane_parts(rng, d, buckets, n_rows, tiny):
    ids, msgs = [], []
    for a, f in buckets:
        v = rng.integers(0, n_rows, size=(a, f))
        if f > 4:
            v[0, :f // 2] = 0            # a hub
        ids.append(v)
        m = _costs(rng, (d, a, f))
        if tiny:
            t = rng.random(m.shape) < 0.5
            m[t] = (np.sign(m[t]) * 10.0 ** rng.uniform(-37.9, -36, t.sum())
                    ).astype(np.float32)
        msgs.append(m)
    return ids, msgs


@pytest.mark.gpu
@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("d,buckets", [
    (3, [(2, 1500)]), (1, [(1, 1), (2, 40)]), (5, [(2, 1), (3, 60)]),
    (8, [(1, 3), (2, 200), (3, 1)]), (33, [(2, 70)]), (2, [(4, 9)]),
])
def test_lane_sum_equals_plain(d, buckets, tiny):
    _need_card()
    rng = np.random.default_rng(d)
    n_rows = 301
    ids, msgs = _lane_parts(rng, d, buckets, n_rows, tiny)
    perm, offsets, starts = lane_order(ids, n_rows)
    var_costs = _costs(rng, (d, n_rows))
    cpu = [torch.from_numpy(x) for x in (perm, offsets, starts)]
    ref = lane_sum_reference([torch.from_numpy(m) for m in msgs], *cpu,
                             torch.from_numpy(var_costs))
    before = _build.launch_counts[LANE_SUM]
    got = lane_sum([torch.from_numpy(m).cuda() for m in msgs],
                   *(t.cuda() for t in cpu),
                   torch.from_numpy(var_costs).cuda())
    assert _build.launch_counts[LANE_SUM] == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


def _lane_graph(dcop, device):
    g, _ = compile_dcop(dcop, noise_level=0.01)
    return to_lane_device_graph(lane_ops.to_lane_graph(g), device)


@pytest.mark.gpu
@pytest.mark.parametrize("stop", [True, False])
def test_lane_solve_card_equals_cpu(stop):
    _need_card()
    dcop = ring(300, 3, 0, chords=40)
    runs = []
    for device in ("cuda", "cpu"):
        state, values = lane_ops.run_maxsum(_lane_graph(dcop, device), 80,
                                            stop_on_convergence=stop)
        runs.append((state, values))
    (cs, cv), (ps, pv) = runs
    assert torch.equal(cv.cpu(), pv)
    assert int(cs.cycle) == int(ps.cycle)
    assert bool(cs.stable) == bool(ps.stable)
    for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
        for a, b in zip(getattr(cs, field), getattr(ps, field)):
            assert torch.equal(a.cpu(), b), field
    graph = _lane_graph(dcop, "cuda")
    _, _, card = lane_ops.run_maxsum_trace(graph, 30)
    _, _, cpu = lane_ops.run_maxsum_trace(_lane_graph(dcop, "cpu"), 30)
    assert np.array_equal(card.cpu().numpy().view(np.uint32),
                          cpu.numpy().view(np.uint32))


def _same(a, b):
    va, ca, ra = a
    vb, cb, rb = b
    assert all(np.array_equal(x, y) for x, y in zip(va, vb))
    assert np.array_equal(ca, cb)
    assert ra.metrics["converged_lanes"] == rb.metrics["converged_lanes"]


@pytest.mark.gpu
def test_stacked_and_packed_card_equal_cpu():
    _need_card()
    same = [compile_dcop(ring(60, 3, s, chords=7), noise_level=0.01)[0]
            for s in range(5)]
    mixed = [compile_dcop(ring(n, 3, s, chords=s % 3), noise_level=0.01)[0]
             for s, n in enumerate((14, 17, 20, 23))]
    envs = [binning.envelope_key(g) for g in mixed]
    env = binning.Envelope(
        max(e.v_env for e in envs), max(e.d_env for e in envs),
        tuple((a, max(dict(e.rows)[a] for e in envs))
              for a in sorted(dict(envs[0].rows))))
    for fn, graphs, kw in (
            (batch.run_stacked, same, {}),
            (batch.run_stacked, same, {"pad_to_bins": (8,)}),
            (batch.run_stacked, mixed, {"envelope": env}),
            (batch.run_lane_packed, mixed, {})):
        card = fn(graphs, max_cycles=50, device="cuda", **kw)
        cpu = fn(graphs, max_cycles=50, device="cpu", **kw)
        _same(card, cpu)


@pytest.mark.gpu
def test_launch_collect_do_not_synchronise():
    _need_card()
    graphs = [compile_dcop(ring(60, 3, s, chords=7), noise_level=0.01)[0]
              for s in range(4)]
    kw = dict(max_cycles=30, device="cuda")
    run = batch.run_stacked(graphs, **kw)
    lane = batch.run_lane_packed(graphs, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = batch.launch_stacked(graphs, **kw)
        pending_lane = batch.launch_lane_packed(graphs, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _same(batch.collect_stacked(pending), run)
    _same(batch.collect_lane_packed(pending_lane), lane)
