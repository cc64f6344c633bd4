"""On the card: the port's MaxSum run is deterministic and equals its CPU
run bit for bit.

This file imports neither JAX nor the JAX package, so it also runs where
only the port is installed.  Every test is marked ``gpu`` and decides
inside itself whether a card is present; without one it skips.  The
repository's root conftest imports JAX, so where JAX is missing run:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu_determinism.py

- Two fixed 200-cycle runs on the card of a 2,000-variable instance
  built like bench.py's flagship, and the CPU run, give the same values
  and ``np.array_equal`` final states (``engine.convert.state_to_numpy``).
- Both kernels equal their plain versions bit for bit at awkward shapes:
  ``segment_sum`` on a four-bucket graph with sentinel padding, on a
  hub, and on a three-bucket power-law graph whose hub spans several
  shared-memory passes and bucket boundaries (each bucket's messages
  read in place), ``binary_factor_update`` at every templated D, a
  generic D, a ragged F and an unaligned view.
- ``aggregate_beliefs`` with one-edge buckets (ROADMAP Queue C's
  belief-sum fault) equals the CPU's bit for bit under ``scatter`` and
  ``sorted``, and 40 supersteps on such a graph equal the CPU's.
- ``aggregate_beliefs`` on the card concatenates nothing (``torch.cat``
  is made to raise during the call) and equals the CPU's result; the
  wrapper refuses one [E, D] tensor for several buckets and a call
  without the placement plan.
- ``segment_sum``'s one-running-sum mode (the ``sorted`` aggregation)
  equals its plain version bit for bit on the multi-bucket graphs, at a
  templated D and at a generic D.
- Solves with the ``sorted`` and ``ell`` aggregations on the card equal
  the CPU's bit for bit; a ``boundary`` run on the card equals its own
  second run.
- A pruned run of the time-to-cost recipe (D = 128) on the card equals
  the dense run on the card and the pruned run on the CPU, values and
  every final message, with the binary kernel launched once per dense
  cycle.
- ``var_update.cu`` (both entry points) equals its plain version bit
  for bit on messages half of which lie in 1.2e-38 .. 1e-36 (ROADMAP
  Queue C's state), on a four-bucket arity 1-4 graph and on the D = 30
  graph whose domain mean is vectorised, at damping 0, 0.5 and 0.7 and
  cycles 0 and 3; also with random valid slots at every D = 1..8, on
  buckets whose edge counts are no multiple of any tile size (each
  size run), and on views whose base is off a 16-byte boundary.  One
  unmatched edge clears ``stable``, none leaves it set, and a call on
  the card without the bucket's ``var_ids32``/``edge_valid`` raises.
  60 cycles on the card from the Queue C state equal 60 on the CPU,
  every message and count.
- An observed solve's profiler entry on the card lists the three hand
  kernels by name (``torch.profiler``).
"""

import numpy as np
import pytest
import torch

import pydcop_tpu_torch.dcop.dcop as dcop_mod
import pydcop_tpu_torch.dcop.objects as objects
import pydcop_tpu_torch.dcop.relations as relations
from pydcop_tpu_torch.algorithms import AlgorithmDef
from pydcop_tpu_torch.algorithms.maxsum import build_engine
from pydcop_tpu_torch.engine.convert import graph_from_numpy, state_to_numpy
from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops import maxsum as ops
from pydcop_tpu_torch.ops.binary_factor import (
    binary_factor_update,
    binary_factor_update_reference,
)
from pydcop_tpu_torch.ops.segment_sum import (
    pass_edges,
    segment_sum,
    segment_sum_reference,
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


CYCLES = 200


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def coloring(n_vars: int, seed: int = 0, n_colors: int = 3):
    """bench.py's build_dcop: cost-1 equality penalty per edge, ~1.5
    edges per variable, duplicates skipped."""
    rng = np.random.default_rng(seed)
    dom = objects.Domain("colors", "color", list(range(n_colors)))
    dcop = dcop_mod.DCOP(f"gc_{n_vars}", objective="min")
    variables = [objects.Variable(f"v{i}", dom) for i in range(n_vars)]
    for v in variables:
        dcop.add_variable(v)
    eq = np.eye(n_colors, dtype=np.float64)
    seen = set()
    for _ in range(int(n_vars * 1.5)):
        i, j = rng.choice(n_vars, size=2, replace=False)
        key = (min(i, j), max(i, j))
        if key in seen:
            continue
        seen.add(key)
        dcop.add_constraint(relations.NAryMatrixRelation(
            [variables[i], variables[j]], eq, f"c{len(seen)}"))
    dcop.add_agents([objects.AgentDef("a0")])
    return dcop


def _final(engine):
    state, values = ops.run_maxsum(
        engine.graph, CYCLES, damping=engine.damping,
        damp_vars=engine.damp_vars, damp_factors=engine.damp_factors,
        stability=engine.stability, stop_on_convergence=False)
    return state_to_numpy(state), values.cpu().numpy()


@pytest.mark.gpu
def test_card_runs_equal_cpu_run_bit_for_bit():
    _need_card()
    dcop = coloring(2_000)
    params = AlgorithmDef.build_with_default_param("maxsum").params
    card = build_engine(dcop, params, device="cuda")
    cpu = build_engine(dcop, params, device="cpu")
    before = dict(_build.launch_counts)
    runs = [_final(card), _final(card), _final(cpu)]
    grew = {k: _build.launch_counts[k] - before.get(k, 0)
            for k in ("binary_factor_update", "segment_sum")}
    assert grew == {"binary_factor_update": 2 * CYCLES,
                    "segment_sum": 2 * (CYCLES + 1)}
    (s0, v0) = runs[0]
    for state, values in runs[1:]:
        np.testing.assert_array_equal(values, v0)
        for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
            for a, b in zip(state[field], s0[field]):
                np.testing.assert_array_equal(a, b, err_msg=field)
        assert (state["stable"], state["cycle"]) == (s0["stable"],
                                                     s0["cycle"])


def _graphs():
    rng = np.random.default_rng(1)
    n_vars, d = 300, 4
    var_costs = rng.normal(size=(n_vars + 1, d)).astype(np.float32)
    buckets = []
    for arity, f in ((1, 100), (2, 400), (3, 150), (4, 60)):
        ids = rng.integers(0, n_vars, size=(f, arity)).astype(np.int32)
        ids[-f // 10:] = n_vars
        buckets.append((np.zeros((f,) + (d,) * arity, np.float32), ids))
    yield graph_from_numpy(var_costs, np.ones_like(var_costs, bool),
                           buckets, device="cuda")
    ids = rng.integers(1, 1_000, size=(2_000, 2)).astype(np.int32)
    ids[:, 0] = 0
    var_costs = rng.normal(size=(1_001, 3)).astype(np.float32)
    yield graph_from_numpy(
        var_costs, np.ones_like(var_costs, bool),
        [(np.zeros((2_000, 3, 3), np.float32), ids)], device="cuda")


def powerlaw_hub_graph(device, n_vars=30_000, d=3, seed=3):
    """Buckets of arity 1, 2 and 3 with endpoints drawn with weight
    (i + 1) ** -0.5; variable 0 sits in 1,500 / 4,000 / 2,000 factors of
    them, so its ~7,500 edges span four passes at D = 3 and both bucket
    boundaries fall inside passes; a tenth of each bucket's rows are
    padding (the sentinel row is heavy too)."""
    rng = np.random.default_rng(seed)
    weight = (np.arange(n_vars) + 1.0) ** -0.5
    weight /= weight.sum()
    buckets = []
    for arity, f_hub, f_rest in ((1, 1_500, 2_000), (2, 4_000, 20_000),
                                 (3, 2_000, 8_000)):
        f = f_hub + f_rest
        ids = rng.choice(n_vars, size=(f, arity), p=weight).astype(np.int32)
        ids[:f_hub, arity - 1] = 0
        ids = ids[rng.permutation(f)]
        ids[-(f // 10):] = n_vars
        buckets.append((np.zeros((f,) + (d,) * arity, np.float32), ids))
    var_costs = rng.normal(size=(n_vars + 1, d)).astype(np.float32)
    return graph_from_numpy(var_costs, np.ones_like(var_costs, bool),
                            buckets, device=device)


def _bucket_messages(graph, seed):
    """Per-bucket f2v tensors [F, arity, D] on the graph's device,
    spread over seven decades, so another add order changes the bits."""
    rng = np.random.default_rng(seed)
    d = graph.var_costs.shape[1]
    out = []
    for b in graph.buckets:
        shape = tuple(b.var_ids.shape) + (d,)
        out.append(torch.tensor(
            (rng.normal(size=shape)
             * 10.0 ** rng.integers(-3, 4, size=shape)).astype(np.float32),
            device=graph.var_costs.device))
    return tuple(out)


def _check_kernel(graph, f2v):
    args = (graph.agg_perm, graph.agg_offsets, graph.agg_buckets,
            graph.var_costs)
    before = _build.launch_counts["segment_sum"]
    beliefs, sums = segment_sum(f2v, *args, graph.agg_tiles)
    torch.cuda.synchronize()
    assert _build.launch_counts["segment_sum"] == before + 1
    d = graph.var_costs.shape[1]
    flat = torch.cat([m.reshape(-1, d) for m in f2v]).cpu()
    ref_b, ref_s = segment_sum_reference(flat, *(t.cpu() for t in args))
    assert torch.equal(sums.cpu(), ref_s)
    assert torch.equal(beliefs.cpu(), ref_b)


@pytest.mark.gpu
def test_segment_sum_kernel_equals_plain_version():
    _need_card()
    for i, graph in enumerate(_graphs()):
        _check_kernel(graph, _bucket_messages(graph, 2 + i))


@pytest.mark.gpu
def test_segment_sum_kernel_on_power_law_hub_across_passes():
    _need_card()
    graph = powerlaw_hub_graph("cuda")
    tiles = graph.agg_tiles.cpu().numpy()
    perm = graph.agg_perm.cpu().numpy()
    starts = graph.agg_buckets.cpu().numpy()
    chunk = pass_edges(3)
    # The hub and the sentinel row are heavy tiles of their own; each
    # spans more than three passes, both bucket boundaries of its edges
    # fall inside a pass, and its odd-bucket run crosses passes.
    for v in (0, graph.var_costs.shape[0] - 1):
        row = tiles[tiles[:, 0] == v][0]
        assert row[1] == v + 1 and row[3] - row[2] > 3 * chunk
        bkt = np.searchsorted(starts, perm[row[2]:row[3]], side="right") - 1
        bounds = np.flatnonzero(np.diff(bkt)) + 1
        assert len(bounds) == 2 and (bounds % chunk != 0).all()
        assert bounds[0] // chunk != bounds[1] // chunk
    _check_kernel(graph, _bucket_messages(graph, 9))


@pytest.mark.gpu
def test_aggregate_beliefs_reads_buckets_in_place(monkeypatch):
    _need_card()
    card, cpu = powerlaw_hub_graph("cuda"), powerlaw_hub_graph("cpu")
    f2v = _bucket_messages(card, 10)
    want = ops.aggregate_beliefs(cpu, tuple(m.cpu() for m in f2v))

    def no_cat(*args, **kwargs):
        raise AssertionError("torch.cat called on the card's path")

    monkeypatch.setattr(torch, "cat", no_cat)
    got = ops.aggregate_beliefs(card, f2v)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


# One-factor arity-1 buckets (one edge each) among buckets of more and
# of fewer than V + 1 edges, (arity, F) per bucket: XLA moves their
# one-row updates (segment_sum.positional_fold; ROADMAP Queue C).
ONE_EDGE_LAYOUTS = [
    [(1, 1), (2, 30)], [(2, 30), (1, 1), (2, 25)], [(2, 30), (1, 1)],
    [(2, 30), (1, 1), (1, 1), (2, 30)], [(2, 2), (1, 1), (2, 30)],
    [(1, 60), (1, 1), (1, 50)],
]


def one_edge_arrays(layout, n_rows, d, seed):
    """(var_costs, var_valid, buckets) of a layout over real variables,
    the cost tables spread over seven decades."""
    rng = np.random.default_rng(seed)
    buckets = []
    for arity, f in layout:
        ids = np.stack([rng.choice(n_rows - 1, size=arity, replace=False)
                        for _ in range(f)]).astype(np.int32)
        shape = (f,) + (d,) * arity
        buckets.append(((rng.normal(size=shape)
                         * 10.0 ** rng.integers(-3, 4, size=shape))
                        .astype(np.float32), ids))
    var_costs = (rng.normal(size=(n_rows, d)) * 10).astype(np.float32)
    return var_costs, np.ones_like(var_costs, bool), buckets


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 3, 5])
def test_one_edge_buckets_card_equals_cpu(d):
    """The belief sum with one-edge buckets, under scatter and sorted:
    the card equals the CPU bit for bit (beliefs and sums) at V + 1 in
    {5, 21, 41}; 40 supersteps on the card equal 40 on the CPU."""
    _need_card()
    for i, layout in enumerate(ONE_EDGE_LAYOUTS):
        for n_rows in (5, 21, 41):
            arrays = one_edge_arrays(layout, n_rows, d, seed=i + n_rows)
            for strategy in ("scatter", "sorted"):
                card, cpu = (graph_from_numpy(*arrays, device=dev,
                                              aggregation=strategy)
                             for dev in ("cuda", "cpu"))
                f2v = _bucket_messages(card, 30 + i)
                got = ops.aggregate_beliefs(card, f2v)
                want = ops.aggregate_beliefs(cpu, tuple(m.cpu()
                                                        for m in f2v))
                for g, w in zip(got, want):
                    assert torch.equal(g.cpu(), w), (layout, n_rows, strategy)
    arrays = one_edge_arrays(ONE_EDGE_LAYOUTS[3], 21, d, seed=8)
    card, cpu = (graph_from_numpy(*arrays, device=dev)
                 for dev in ("cuda", "cpu"))
    runs = [ops.run_maxsum(g, 40, stop_on_convergence=False)
            for g in (card, cpu)]
    (s0, v0), (s1, v1) = ((state_to_numpy(s), v.cpu().numpy())
                          for s, v in runs)
    np.testing.assert_array_equal(v0, v1)
    for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
        for a, b in zip(s0[field], s1[field]):
            np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.gpu
def test_segment_sum_on_card_refuses_flat_buckets_and_no_plan():
    _need_card()
    graph = powerlaw_hub_graph("cuda", n_vars=2_000)
    f2v = _bucket_messages(graph, 11)
    d = graph.var_costs.shape[1]
    args = (graph.agg_perm, graph.agg_offsets, graph.agg_buckets,
            graph.var_costs)
    flat = torch.cat([m.reshape(-1, d) for m in f2v])
    with pytest.raises(ValueError):
        segment_sum(flat, *args, graph.agg_tiles)
    with pytest.raises(ValueError):
        segment_sum(f2v, *args)


@pytest.mark.gpu
@pytest.mark.parametrize("f,d,view", [
    (1, 3, False), (1_000, 3, False), (129, 2, False), (200, 4, False),
    (130, 6, False), (257, 7, False), (333, 8, False), (77, 11, False),
    (129, 3, True), (100, 8, True),
])
def test_binary_kernel_equals_plain_version(f, d, view):
    _need_card()
    rng = np.random.default_rng(f * 16 + d)
    costs = torch.tensor(rng.normal(size=(f + view, d, d)).astype(
        np.float32), device="cuda")
    v2f = torch.tensor(rng.normal(size=(f + view, 2, d)).astype(
        np.float32), device="cuda")
    if view:
        costs, v2f = costs[1:], v2f[1:]
    out = binary_factor_update(costs, v2f)
    torch.cuda.synchronize()
    assert torch.equal(out, binary_factor_update_reference(costs, v2f))


@pytest.mark.gpu
def test_segment_sum_sorted_mode_equals_plain_version():
    _need_card()
    graphs = list(_graphs()) + [powerlaw_hub_graph("cuda")]
    rng = np.random.default_rng(12)
    n_vars, d = 400, 11            # D > 8: the generic kernel
    buckets = []
    for arity, f in ((1, 150), (2, 300), (3, 100)):
        ids = rng.integers(0, n_vars, size=(f, arity)).astype(np.int32)
        ids[-f // 10:] = n_vars
        buckets.append((np.zeros((f,) + (d,) * arity, np.float32), ids))
    var_costs = rng.normal(size=(n_vars + 1, d)).astype(np.float32)
    graphs.append(graph_from_numpy(var_costs, np.ones_like(var_costs, bool),
                                   buckets, device="cuda"))
    for i, graph in enumerate(graphs):
        f2v = _bucket_messages(graph, 20 + i)
        args = (graph.agg_perm, graph.agg_offsets, graph.agg_buckets,
                graph.var_costs)
        before = _build.launch_counts["segment_sum"]
        beliefs, sums = segment_sum(f2v, *args, graph.agg_tiles,
                                    one_sum=True)
        torch.cuda.synchronize()
        assert _build.launch_counts["segment_sum"] == before + 1
        d = graph.var_costs.shape[1]
        flat = torch.cat([m.reshape(-1, d) for m in f2v]).cpu()
        cpu_args = tuple(t.cpu() for t in args)
        ref_b, ref_s = segment_sum_reference(flat, *cpu_args, one_sum=True)
        assert torch.equal(sums.cpu(), ref_s), i
        assert torch.equal(beliefs.cpu(), ref_b), i
        if len(f2v) > 1:
            split = segment_sum_reference(flat, *cpu_args)[1]
            assert not torch.equal(split, ref_s), i


def _strategy_engines(aggregation):
    params = dict(AlgorithmDef.build_with_default_param("maxsum").params,
                  aggregation=aggregation)
    dcop = coloring(2_000)
    return (build_engine(dcop, params, device="cuda"),
            build_engine(dcop, params, device="cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("aggregation", ["sorted", "ell"])
def test_aggregation_options_card_equals_cpu(aggregation):
    _need_card()
    card, cpu = _strategy_engines(aggregation)
    assert card.graph.agg_strategy == aggregation
    (s0, v0), (s1, v1) = _final(card), _final(cpu)
    np.testing.assert_array_equal(v0, v1)
    for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
        for a, b in zip(s0[field], s1[field]):
            np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.gpu
def test_boundary_run_on_card_repeats_itself():
    _need_card()
    card, _ = _strategy_engines("boundary")
    (s0, v0), (s1, v1) = _final(card), _final(card)
    np.testing.assert_array_equal(v0, v1)
    for a, b in zip(s0["f2v"], s1["f2v"]):
        np.testing.assert_array_equal(a, b)


def ttc_like(device, n_vars=120, d=128, seed=11):
    """bench.py build_ttc_graph's recipe at ``n_vars`` variables."""
    rng = np.random.default_rng(seed)
    n_factors = int(n_vars * 1.5)
    ids = rng.integers(0, n_vars, size=(n_factors, 2)).astype(np.int32)
    loop = ids[:, 0] == ids[:, 1]
    ids[loop, 1] = (ids[loop, 0] + 1) % n_vars
    costs = np.ascontiguousarray(np.broadcast_to(
        np.eye(d, dtype=np.float32), (n_factors, d, d)))
    var_costs = np.full((n_vars + 1, d), 1e9, np.float32)
    var_costs[:-1] = rng.integers(0, 400, size=(n_vars, d))
    var_valid = np.zeros((n_vars + 1, d), bool)
    var_valid[:-1] = True
    return graph_from_numpy(var_costs, var_valid, [(costs, ids)],
                            device=device)


@pytest.mark.gpu
def test_pruned_run_on_card_equals_dense_and_cpu():
    _need_card()
    card, cpu = ttc_like("cuda"), ttc_like("cpu")
    runs, stats = [], []
    for graph, prune in ((card, True), (card, False), (cpu, True)):
        st = {}
        before = _build.launch_counts["binary_factor_update"]
        state, values = ops.run_maxsum(graph, CYCLES,
                                       stop_on_convergence=False,
                                       prune=prune, stats=st)
        launched = _build.launch_counts["binary_factor_update"] - before
        runs.append((state_to_numpy(state), values.cpu().numpy()))
        stats.append((st["prune_fast_cycles"], launched))
    fast = stats[0][0]
    assert 0 < fast < CYCLES and stats[2][0] == fast
    assert stats[0][1] == CYCLES - fast and stats[1] == (0, CYCLES)
    (s0, v0) = runs[0]
    for state, values in runs[1:]:
        np.testing.assert_array_equal(values, v0)
        for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
            for a, b in zip(state[field], s0[field]):
                np.testing.assert_array_equal(a, b, err_msg=field)


FLT_MIN = float(np.finfo(np.float32).tiny)


def tiny_state(graph, seed):
    """A cycle-3 state of ``graph`` as numpy, about half of all message
    slots of magnitude 1.2e-38 .. 1e-36 (ROADMAP Queue C)."""
    rng = np.random.default_rng(seed)
    valid = graph.var_valid.cpu().numpy()
    d = valid.shape[1]
    out = {"v2f": [], "f2v": [], "v2f_count": [], "f2v_count": []}
    for b in graph.buckets:
        ids = b.var_ids.cpu().numpy()
        shape = ids.shape + (d,)
        for field in ("v2f", "f2v"):
            m = rng.normal(size=shape)
            tiny = rng.random(shape) < 0.5
            m[tiny] = np.sign(m[tiny]) * 10.0 ** rng.uniform(
                np.log10(FLT_MIN), -36, int(tiny.sum()))
            out[field].append(np.where(valid[ids], m.astype(np.float32),
                                       np.float32(1e9)))
        for field in ("v2f_count", "f2v_count"):
            out[field].append(rng.integers(0, 6, size=ids.shape)
                              .astype(np.int8))
    return dict(out, stable=False, cycle=3)


def fold_arrays(d, n_vars=120, seed=17):
    """A unary and a binary bucket, the binary one with more edges than
    V + 1 (its belief sum taken on its own: the fused domain mean)."""
    rng = np.random.default_rng(seed)
    unary = rng.integers(0, 40, size=(n_vars, d)).astype(np.float32)
    ids2 = rng.integers(0, n_vars, size=(2 * n_vars, 2)).astype(np.int32)
    same = ids2[:, 0] == ids2[:, 1]
    ids2[same, 1] = (ids2[same, 0] + 1) % n_vars
    eye = np.ascontiguousarray(np.broadcast_to(
        np.eye(d, dtype=np.float32), (2 * n_vars, d, d)))
    var_costs = np.zeros((n_vars + 1, d), np.float32)
    var_valid = np.ones((n_vars + 1, d), bool)
    var_valid[-1] = False
    return var_costs, var_valid, [
        (unary, np.arange(n_vars, dtype=np.int32)[:, None]), (eye, ids2)]


PARAMS = AlgorithmDef.build_with_default_param("maxsum").params


def multi_bucket_arrays(rng, n_vars=500, d=4):
    """Buckets of arity 1-4 over ``n_vars`` variables, D = 4, a tenth
    of each bucket's rows padding (the sentinel row)."""
    var_costs = rng.normal(size=(n_vars + 1, d)).astype(np.float32)
    buckets = []
    for arity, f in ((1, 300), (2, 800), (3, 400), (4, 200)):
        ids = rng.integers(0, n_vars, size=(f, arity)).astype(np.int32)
        ids[-f // 10:] = n_vars
        buckets.append((np.zeros((f,) + (d,) * arity, np.float32), ids))
    return var_costs, np.ones_like(var_costs, bool), buckets


def _subnormal_graphs():
    yield "multi_bucket", multi_bucket_arrays(np.random.default_rng(11))
    yield "fold_D30", fold_arrays(30)


def _bits(a):
    return a.view(np.int32) if a.dtype == np.float32 else a


def _views(tensors, lead):
    """Copies of the tensors as contiguous views ``lead`` elements into
    larger buffers: each base off a 16-byte boundary for lead = 1, 3."""
    out = []
    for t in tensors:
        buf = torch.zeros(t.numel() + lead, dtype=t.dtype, device=t.device)
        view = buf[lead:].view(t.shape)
        view.copy_(t)
        out.append(view)
    return out


def _var_update_matches_plain(graph, seed, lead=0):
    """Both entry points against their plain versions on ``graph``'s
    buckets from :func:`tiny_state`, at cycles 0 and 3 and damping 0,
    0.5 and 0.7: messages as int32 bit patterns, counts, the stable
    flag, one launch a call.  With ``lead`` the per-edge inputs and the
    bucket arrays are views that many elements into larger buffers."""
    from pydcop_tpu_torch.ops import var_update as vu

    s = tiny_state(graph, seed)
    f2v = [torch.tensor(m, device="cuda") for m in s["f2v"]]
    v2f = [torch.tensor(m, device="cuda") for m in s["v2f"]]
    cnt = [torch.tensor(c, device="cuda") for c in s["v2f_count"]]
    beliefs, sums = ops.aggregate_beliefs(graph, tuple(f2v))
    fused = ops._sums_fused(graph)
    calls = 0
    for i, b in enumerate(graph.buckets):
        ids32, mask = b.var_ids32, b.edge_valid
        m, o, c = f2v[i], v2f[i], cnt[i]
        if lead:
            m, o, c, ids32 = _views([m, o, c, ids32], lead)
            if mask is not None:
                (mask,) = _views([mask], lead)
            assert all(t.data_ptr() % 16 for t in (m, o, c, ids32))
        arrays = dict(var_ids32=ids32, edge_valid=mask)
        for cycle in (0, 3):
            cyc = torch.tensor(cycle, dtype=torch.int32, device="cuda")
            for damping in (0.0, 0.5, 0.7):
                for side in ("v2f", "send"):
                    if side == "v2f":
                        args = (beliefs, sums, m, o, c, b.var_ids,
                                graph.var_valid, cyc)
                        pair = (vu.v2f_update, vu.v2f_update_reference)
                        kw = dict(damping=damping, stability=0.1,
                                  fused=fused)
                    else:
                        args = (m, o, c, b.var_ids, graph.var_valid, cyc)
                        pair = (vu.send_update, vu.send_update_reference)
                        kw = dict(damping=damping, stability=0.1)
                    flags = [cyc != 0, cyc != 0]
                    before = _build.launch_counts[vu.KERNEL]
                    got = pair[0](*args, flags[0], **kw, **arrays)
                    want = pair[1](*args, flags[1], **kw)
                    assert _build.launch_counts[vu.KERNEL] == before + 1
                    where = (side, cycle, damping, i, lead)
                    assert torch.equal(got[0].view(torch.int32),
                                       want[0].view(torch.int32)), where
                    assert torch.equal(got[1], want[1]), where
                    assert bool(flags[0]) == bool(flags[1]), where
                    calls += 1
    return calls


@pytest.mark.gpu
def test_var_update_kernel_equals_plain_version():
    _need_card()
    for label, arrays in _subnormal_graphs():
        graph = graph_from_numpy(*arrays, device="cuda")
        assert _var_update_matches_plain(graph, 3) > 0, label


def random_validity_arrays(d, seed, n_vars=700, binary=1_501):
    """Buckets of arity 1-3 whose edge counts (333, 2 * ``binary`` and
    771) are no multiple of any tile, over variables with random valid
    slots (any subset), a tenth of each bucket padding (the sentinel
    row)."""
    rng = np.random.default_rng(seed)
    var_valid = rng.random((n_vars + 1, d)) < 0.7
    var_valid[-1] = False
    var_costs = rng.normal(size=(n_vars + 1, d)).astype(np.float32)
    buckets = []
    for arity, f in ((1, 333), (2, binary), (3, 257)):
        ids = rng.integers(0, n_vars, size=(f, arity)).astype(np.int32)
        ids[-f // 10:] = n_vars
        buckets.append((np.zeros((f,) + (d,) * arity, np.float32), ids))
    return var_costs, var_valid, buckets


@pytest.mark.gpu
@pytest.mark.parametrize("items", [1, 2, 4, 8])
def test_var_update_kernel_on_ragged_tiles(items, monkeypatch):
    """Every tile size the kernel has, on buckets whose edge counts are
    no multiple of it (the last tile ragged); the binary bucket is
    large enough (300,002 edges) for the size to be taken on a card of
    up to 146 SMs, the small ones take one edge a thread."""
    _need_card()
    from pydcop_tpu_torch.ops import var_update as vu

    monkeypatch.setitem(vu.TILE_ITEMS, 3, items)
    graph = graph_from_numpy(
        *random_validity_arrays(3, 20 + items, binary=150_001),
        device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert vu.tile_items(graph.buckets[1].var_ids.numel(), 3, sms) == items
    assert all(b.var_ids.numel() % (256 * items) for b in graph.buckets)
    assert _var_update_matches_plain(graph, items) == 36


@pytest.mark.gpu
@pytest.mark.parametrize("lead", [1, 3])
def test_var_update_kernel_on_unaligned_views(lead):
    """Messages, counts and bucket arrays that start off a 16-byte
    boundary (views into larger buffers), while the sent rows land in
    fresh, aligned tensors."""
    _need_card()
    graph = graph_from_numpy(*random_validity_arrays(3, 30 + lead),
                             device="cuda")
    assert _var_update_matches_plain(graph, 40 + lead, lead=lead) == 36


@pytest.mark.gpu
@pytest.mark.parametrize("d", range(1, 9))
def test_var_update_kernel_at_every_small_domain(d):
    _need_card()
    graph = graph_from_numpy(*random_validity_arrays(d, 50 + d),
                             device="cuda")
    assert _var_update_matches_plain(graph, d) == 36
    assert _var_update_matches_plain(graph, 60 + d, lead=1) == 36


@pytest.mark.gpu
def test_var_update_stable_is_cleared_by_one_unmatched_edge():
    """``stable`` stays set when every live edge matches, and one
    unmatched edge in the ragged last tile clears it (each block
    writes it at most once)."""
    _need_card()
    from pydcop_tpu_torch.ops import var_update as vu

    graph = graph_from_numpy(*random_validity_arrays(3, 70), device="cuda")
    b = graph.buckets[1]
    prev = torch.randn(tuple(b.var_ids.shape) + (3,), device="cuda")
    count = torch.zeros(b.var_ids.shape, dtype=torch.int8, device="cuda")
    cyc = torch.tensor(3, dtype=torch.int32, device="cuda")
    live = torch.nonzero(b.edge_valid.reshape(-1)).reshape(-1)
    for change in (None, int(live[-1])):
        cand = prev.clone()
        if change is not None:
            cand.reshape(-1, 3)[change] += 1.0
        args = (cand, prev, count, b.var_ids, graph.var_valid, cyc)
        kw = dict(damping=0.0, stability=0.1)
        flags = [torch.ones((), dtype=torch.bool, device="cuda")
                 for _ in range(2)]
        vu.send_update(*args, flags[0], var_ids32=b.var_ids32,
                       edge_valid=b.edge_valid, **kw)
        vu.send_update_reference(*args, flags[1], **kw)
        assert [bool(f) for f in flags] == [change is None] * 2, change


@pytest.mark.gpu
def test_var_update_on_card_refuses_missing_bucket_arrays():
    _need_card()
    from pydcop_tpu_torch.ops import var_update as vu

    graph = graph_from_numpy(*random_validity_arrays(3, 80), device="cuda")
    b = graph.buckets[1]
    msgs = torch.zeros(tuple(b.var_ids.shape) + (3,), device="cuda")
    count = torch.zeros(b.var_ids.shape, dtype=torch.int8, device="cuda")
    cyc = torch.tensor(3, dtype=torch.int32, device="cuda")
    flag = torch.ones((), dtype=torch.bool, device="cuda")
    before = _build.launch_counts[vu.KERNEL]
    with pytest.raises(ValueError, match="edge_valid"):
        vu.send_update(msgs, msgs, count, b.var_ids, graph.var_valid, cyc,
                       flag, damping=0.5, stability=0.1)
    with pytest.raises(ValueError, match="var_ids32"):
        vu.v2f_update(graph.var_costs, graph.var_costs, msgs, msgs, count,
                      b.var_ids, graph.var_valid, cyc, flag, damping=0.5,
                      stability=0.1, edge_valid=b.edge_valid)
    assert _build.launch_counts[vu.KERNEL] == before


@pytest.mark.gpu
def test_card_equals_cpu_on_the_subnormal_state():
    _need_card()
    from pydcop_tpu_torch.engine.convert import state_from_numpy

    cases = [("colouring", build_engine(coloring(300), PARAMS).graph,
              build_engine(coloring(300), PARAMS, device="cpu").graph)]
    for label, arrays in _subnormal_graphs():
        cases.append((label, graph_from_numpy(*arrays, device="cuda"),
                      graph_from_numpy(*arrays, device="cpu")))
    for label, card, cpu in cases:
        s = tiny_state(cpu, 1)
        for damping in (0.5, 0.7):
            runs = []
            for graph, dev in ((card, "cuda"), (cpu, "cpu")):
                state, values = ops.run_maxsum_from(
                    graph, state_from_numpy(**s, device=dev), 60,
                    damping=damping, stop_on_convergence=False)
                runs.append((state_to_numpy(state), values.cpu().numpy()))
            (a, va), (b, vb) = runs
            np.testing.assert_array_equal(va, vb)
            for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
                for x, y in zip(a[field], b[field]):
                    np.testing.assert_array_equal(
                        _bits(x), _bits(y), err_msg=f"{label} {field}")


@pytest.mark.gpu
def test_profiler_on_the_card_lists_the_hand_kernels(tmp_path):
    """The first segment of an observed solve is profiled on the card:
    the three hand kernels appear by name, and the entry says its
    source."""
    _need_card()
    from pydcop_tpu_torch.api import solve

    res = solve(coloring(300), "maxsum", max_cycles=20, metrics_every=10,
                metrics_file=str(tmp_path / "m.jsonl"))
    (entry,) = res["metrics"]["xla_cost"].values()
    assert entry["available"] is True
    assert entry["source"] == "torch.profiler"
    names = " ".join(entry["kernels"])
    for kernel in ("binary_factor_update", "segment_sum", "var_update"):
        assert kernel in names, names
    assert entry["kernels_per_cycle"] > 0
