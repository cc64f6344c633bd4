"""On the card: the one-launch whole-graph total (``csrc/window_sum.cu``
through ``ops/window_sum.py::window_total``) equals its plain version,
bit for bit (uint32 views; any two NaNs agree: an invalid add makes
0x7FFFFFFF on the card and 0xFFC00000 on an x86 CPU).

This file imports neither JAX nor the JAX package.  Every test is
marked ``gpu`` and decides inside itself whether a card is present;
without one it skips.  Where JAX is missing run:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu_window_sum.py

- every operand kind: a cost gather with ids (arity 1-6, sentinel ids
  past the values), a gather with implicit ids (the variable costs),
  int32 and int64 values, a plain array of one to three axes (a direct
  sum, windows of 32 along axis 0 only, boxes over two axes);
- every head form of ``gather_stages``, the residual's row lanes
  (``residual_lanes``) and rows in lanes (``residual_rows``);
- the chain: one operand, up to 16, from the first part or from +0.0,
  a -0.0 first part, empty operands, one-value operands (a copy);
- the output slot (``out=costs[n]``), one launch a total, and the
  refusals (CPU and CUDA operands mixed, too many operands);
- totals on two streams at once, a total replayed from a CUDA graph,
  and a cached descriptor refused to a view with other strides or
  another dtype;
- the six sites' totals through the port's entry points on graphs
  with unary to 5-ary buckets, and the traced run's cost curve.
"""

import numpy as np
import pytest
import torch

from pydcop_tpu_torch.engine.convert import graph_from_numpy
from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops import localsearch as ls
from pydcop_tpu_torch.ops import maxsum as ms
from pydcop_tpu_torch.ops import window_sum as ws


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


def wide(rng, shape, decades=4):
    return (rng.standard_normal(shape)
            * 10.0 ** rng.uniform(-decades, decades, shape)).astype(
                np.float32)


def spoil(rng, x, kind):
    flat = x.reshape(-1)
    if kind == "subnormal":
        flat[rng.random(flat.size) < 0.3] = np.float32(-1e-39)
        flat[rng.random(flat.size) < 0.1] = np.float32(1.3e-38)
    elif kind == "inf":
        flat[rng.integers(0, flat.size)] = np.inf
        flat[rng.integers(0, flat.size)] = -np.inf
    elif kind == "zeros":
        flat[rng.random(flat.size) < 0.5] = -0.0
    return x


def same_bits(a, b) -> bool:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return bool((np.isnan(a) and np.isnan(b))
                or a.view(np.uint32) == b.view(np.uint32))


def on_cpu(op):
    if isinstance(op, ws.Gather):
        return op._replace(table=op.table.cpu(), ids=None if op.ids is None
                           else op.ids.cpu())
    return op._replace(x=op.x.cpu())


def assert_card_equals_plain(operands, values=None, from_zero=False):
    before = _build.launch_counts[ws.COUNTER]
    card = ws.window_total(operands, values, from_zero)
    torch.cuda.synchronize()
    assert _build.launch_counts[ws.COUNTER] == before + 1
    plain = ws.window_total_plain([on_cpu(o) for o in operands],
                                  None if values is None else values.cpu(),
                                  from_zero)
    assert card.device.type == "cuda" and card.shape == ()
    assert same_bits(card.cpu().numpy(), plain.numpy()), (
        float(card), float(plain))


def gather(rng, f, arity, d, n_values, kind="signed"):
    """A cost gather of ``f`` factors of ``arity`` over ``n_values``
    variables (ids up to ``n_values``: the sentinel past the values)."""
    table = spoil(rng, wide(rng, (f, d ** arity)), kind)
    ids = rng.integers(0, n_values + 1, (f, arity)).astype(np.int32)
    return ws.Gather(torch.from_numpy(table).cuda(),
                     torch.from_numpy(ids).cuda(), f, d,
                     ws.gather_stages("maxsum", arity, d, f))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["signed", "subnormal", "inf", "zeros"])
@pytest.mark.parametrize("f,arity,d", [
    (1, 2, 3), (4, 6, 2), (8, 3, 3), (21, 2, 3), (32, 5, 2), (33, 2, 3),
    (1_000, 3, 2), (1_024, 2, 3), (1_025, 1, 4), (40_000, 2, 3),
    (100_000, 4, 2)])
def test_gather_operands(f, arity, d, kind):
    _need_card()
    rng = np.random.default_rng(f + arity + d)
    n_values = 300
    op = gather(rng, f, arity, d, n_values, kind)
    values = torch.from_numpy(rng.integers(0, d, n_values).astype(
        np.int32)).cuda()
    assert_card_equals_plain([op], values)
    assert_card_equals_plain([op], values.long())
    var = ws.Gather(torch.from_numpy(wide(rng, (n_values + 1, d))).cuda(),
                    None, n_values, d, ws.gather_stages("maxsum", 0, d,
                                                        n_values))
    assert_card_equals_plain([var, op], values)
    assert_card_equals_plain([op, var], values, from_zero=True)


HEADS = sorted({ws.gather_stages(site, arity, d, n, widest)
                for site in ("localsearch", "maxsum", "probe")
                for arity in range(9) for d in range(1, 6)
                for n in range(2, 33) for widest in (2, 3)})


@pytest.mark.gpu
@pytest.mark.parametrize("head", HEADS)
def test_head_forms(head):
    _need_card()
    rng = np.random.default_rng(len(head))
    for n in (2, 4, 8, 16, 20, 23, 24, 31, 32):
        x = torch.from_numpy(wide(rng, (n,))).cuda()
        assert_card_equals_plain([ws.Plain(x, head)])


RESIDUALS = [(17, 2, 3), (100, 2, 3), (14_999, 2, 3), (1_500_000, 2, 3),
             (17, 4, 3), (20, 4, 9), (17, 8, 12), (100, 8, 3), (4, 1, 3),
             (8, 12, 1), (23, 1, 2), (30, 1, 5), (64, 1, 3), (1_024, 1, 8),
             (63, 2, 1), (95, 1, 7), (100, 1, 3), (70, 3, 5), (10, 2, 128),
             (300, 2, 128), (5, 40, 50), (40, 16, 2), (33, 1, 1),
             (17, 16, 8), (40, 16, 7)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", RESIDUALS)
def test_residual_forms(shape):
    _need_card()
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(np.abs(wide(rng, shape))).cuda()
    op = ws.Plain(x, (), ws.residual_lanes(shape), ws.residual_rows(shape))
    assert_card_equals_plain([op], from_zero=True)
    assert_card_equals_plain([ws.Plain(x)])
    other = torch.from_numpy(np.abs(wide(rng, (20, 2, 3)))).cuda()
    assert_card_equals_plain([op, ws.Plain(other, (), 1, ws.NO_ROWS)],
                             from_zero=True)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(0,), (1,), (2,), (33,), (5, 7),
                                   (40, 40), (3, 50, 60), (2_000, 33),
                                   (1_100_000,), (33, 33, 33)])
def test_plain_shapes(shape):
    _need_card()
    rng = np.random.default_rng(len(shape))
    x = torch.from_numpy(wide(rng, shape)).cuda()
    assert_card_equals_plain([ws.Plain(x)])
    assert_card_equals_plain([ws.Plain(x)], from_zero=True)


@pytest.mark.gpu
def test_chains():
    """No operand (+0.0), a -0.0 copy first (kept; +0.0 from zero), 16
    operands of every path."""
    _need_card()
    rng = np.random.default_rng(3)
    out = ws.window_total([], torch.zeros(3, dtype=torch.int32).cuda())
    assert same_bits(out.cpu().numpy(), np.float32(0.0))
    neg = ws.Plain(torch.tensor([-0.0]).cuda())
    x = ws.Plain(torch.from_numpy(wide(rng, (5_000,))).cuda())
    assert_card_equals_plain([neg])
    assert_card_equals_plain([neg], from_zero=True)
    assert_card_equals_plain([neg, x])
    values = torch.from_numpy(rng.integers(0, 3, 500).astype(
        np.int32)).cuda()
    ops = [gather(rng, f, 2, 3, 500) for f in (1, 8, 30, 2_000)] * 3
    ops += [x, neg, ws.Plain(torch.from_numpy(wide(rng, (40, 2, 128))).cuda()),
            ws.Plain(torch.from_numpy(wide(rng, (64, 1, 3))).cuda(), (), 1,
                     (8, 32))]
    assert len(ops) == ws.MAX_OPERANDS
    assert_card_equals_plain(ops, values)
    with pytest.raises(ValueError):
        ws.window_total(ops + [x], values)


@pytest.mark.gpu
def test_output_slot_and_refusals():
    _need_card()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(wide(rng, (3_000,))).cuda()
    costs = torch.full((5,), 9.0, device="cuda")
    got = ws.window_total([ws.Plain(x)], out=costs[3])
    assert got.data_ptr() == costs[3].data_ptr()
    assert same_bits(costs[3].cpu().numpy(),
                     ws.window_tree_sum_plain(x.cpu()).numpy())
    assert costs[[0, 1, 2, 4]].tolist() == [9.0] * 4
    with pytest.raises(ValueError):
        ws.window_total([ws.Plain(x), ws.Plain(x.cpu())])
    with pytest.raises(ValueError):
        ws.window_total([ws.Plain(x)], out=torch.zeros(2, device="cuda"))



@pytest.mark.gpu
def test_streams_graphs_and_cached_descriptors():
    """Totals on two streams at once each get their own scratch and
    ticket; a total captured in a CUDA graph (after a call on its
    stream) replays right, also after that stream's scratch has grown;
    a cached descriptor is not reused for a view of the same address
    and shape with other strides or another dtype."""
    _need_card()
    rng = np.random.default_rng(6)
    big = torch.from_numpy(wide(rng, (1_100_000,))).cuda()
    small = torch.from_numpy(wide(rng, (40_000,))).cuda()
    want = {n: ws.window_tree_sum_plain(x.cpu()).numpy()
            for n, x in (("big", big), ("small", small))}
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    got = {"big": [], "small": []}
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(20):
        with torch.cuda.stream(streams[0]):
            got["big"].append(ws.window_total([ws.Plain(big)]))
        with torch.cuda.stream(streams[1]):
            got["small"].append(ws.window_total([ws.Plain(small)]))
    torch.cuda.synchronize()
    for name, totals in got.items():
        for t in totals:
            assert same_bits(t.cpu().numpy(), want[name]), name

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    slot = torch.zeros((1,), device="cuda")
    with torch.cuda.stream(side):
        ws.window_total([ws.Plain(small)], out=slot[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        ws.window_total([ws.Plain(small)], out=slot[0])
    with torch.cuda.stream(side):
        ws.window_total([ws.Plain(big)])        # grows side's scratch
    torch.cuda.synchronize()
    for _ in range(3):
        slot.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert same_bits(slot[0].cpu().numpy(), want["small"])

    x = torch.from_numpy(wide(rng, (64, 64))).cuda()
    ws.window_total([ws.Plain(x)])
    with pytest.raises(ValueError):
        ws.window_total([ws.Plain(x.t())])
    values = torch.zeros(64, dtype=torch.int32, device="cuda")
    ids = torch.zeros((64, 1), dtype=torch.int32, device="cuda")
    ws.window_total([ws.Gather(x, ids, 64, 64, ())], values)
    with pytest.raises(TypeError):
        ws.window_total([ws.Gather(x.view(torch.int32), ids, 64, 64, ())],
                        values)

def mixed(rng, n_vars, d, counts):
    var_costs = wide(rng, (n_vars + 1, d))
    buckets = []
    for arity, count in enumerate(counts, start=1):
        if count:
            ids = np.stack([rng.choice(n_vars, arity, replace=False)
                            for _ in range(count)]).astype(np.int32)
            buckets.append((wide(rng, (count,) + (d,) * arity), ids))
    return var_costs, np.ones((n_vars + 1, d), bool), buckets


@pytest.mark.gpu
@pytest.mark.parametrize("n_vars,d,counts", [
    (300, 3, (40, 500, 60, 20, 9)), (200, 3, (0, 300, 1)),
    (120, 1, (0, 22, 17, 30, 8)), (60, 2, (23, 20, 24, 32, 16)),
    (20_000, 4, (1_000, 30_000, 3_000))])
def test_sites_on_the_card_equal_the_cpu(n_vars, d, counts):
    _need_card()
    rng = np.random.default_rng(n_vars)
    arrays = mixed(rng, n_vars, d, counts)
    cpu = graph_from_numpy(*arrays, device="cpu")
    card = graph_from_numpy(*arrays, device="cuda")
    vals = torch.from_numpy(rng.integers(0, d, n_vars + 1).astype(np.int32))
    base = torch.from_numpy(wide(rng, (n_vars, d)))
    pairs = [(ls.assignment_cost(cpu, vals),
              ls.assignment_cost(card, vals.cuda()))]
    for site in ("maxsum", "probe"):
        pairs.append((ms.assignment_total(cpu, vals[:-1], base, site),
                      ms.assignment_total(card, vals[:-1].cuda(),
                                          base.cuda(), site)))
        pairs.append((ms.assignment_constraint_cost(cpu, vals[:-1], site),
                      ms.assignment_constraint_cost(card, vals[:-1].cuda(),
                                                    site)))
    for plain, on_card in pairs:
        assert same_bits(on_card.cpu().numpy(), plain.numpy())


@pytest.mark.gpu
def test_traced_run_on_the_card_equals_the_cpu():
    """run_maxsum_trace writes each cycle's total into its slot: one
    launch a cycle, the CPU's curve bit for bit."""
    _need_card()
    rng = np.random.default_rng(8)
    arrays = mixed(rng, 500, 3, (30, 800, 40))
    base = torch.from_numpy(wide(rng, (500, 3), 1))
    out = {}
    for device in ("cpu", "cuda"):
        graph = graph_from_numpy(*arrays, device=device)
        before = _build.launch_counts[ws.COUNTER]
        out[device] = ms.run_maxsum_trace(
            graph, 20, var_base_costs=base.to(device),
            stop_on_convergence=False)[2].cpu().numpy()
        if device == "cuda":
            assert _build.launch_counts[ws.COUNTER] == before + 20
    assert out["cpu"].tobytes() == out["cuda"].tobytes()
