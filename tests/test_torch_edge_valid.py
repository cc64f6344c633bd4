"""The placement arrays the per-edge kernel reads (``device.py``):
``var_ids32`` and ``edge_valid``, on the CPU.

- ``var_ids32`` holds ``var_ids``'s values as int32, and bit k of
  ``edge_valid[f, p]`` is the reference's ``var_valid[var_ids[f, p], k]``
  (``pydcop_tpu`` compiles the same problem): on the 300-variable
  colouring, the four-bucket arity 1-4 graph with sentinel padding,
  the mixed-domain YAML problem, random validity at every D = 1..8,
  and the fold graphs, where D > 8 and the mask is ``None``.
- Every path that rebuilds or replaces a placed graph keeps them true:
  the converted graph (``graph_from_numpy``), the autotuned graph
  (``aggregation="auto"``) and a decimated run, which replaces
  ``var_costs`` at every clamp: each superstep's ``v2f_update`` and
  ``send_update`` receive arrays equal to what they replace.
- The wrappers refuse a wrong dtype, shape or device for them, and a
  mask at D > 8; on a CPU tensor the arrays are only checked, so the
  result equals the call without them.

Tolerance: none (integer arrays, float32 bit patterns).
"""

import jax  # noqa: F401  (imported first: JAX stays on the CPU)
import numpy as np
import pytest
import torch

from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu_torch.algorithms.maxsum import build_engine
from pydcop_tpu_torch.device import (
    EDGE_VALID_MAX_D,
    TorchFactorBucket,
    to_device_graph,
)
from pydcop_tpu_torch.engine.compile import compile_dcop as torch_compile
from pydcop_tpu_torch.engine.convert import graph_from_numpy, state_from_numpy
from pydcop_tpu_torch.engine.runner import DecimationPlan
from pydcop_tpu_torch.ops import maxsum as T
from pydcop_tpu_torch.ops import var_update as V
from test_torch_aggregation_options import strategy_graphs
from test_torch_checkpoint import coloring_both, engines
from test_torch_compile import MIXED_YAML, build_coloring_both, load_both
from test_torch_prune import loopy_graphs
from test_torch_var_update import coloring_graphs, tiny_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def unpacked(edge_valid, d):
    """[F, a, D] bool of the kernel's reading: bit k of each byte."""
    bits = edge_valid.numpy().astype(np.int32)
    return ((bits[..., None] >> np.arange(d)) & 1).astype(bool)


def assert_arrays_match(var_valid, var_ids, bucket):
    """``bucket``'s int32 ids equal ``var_ids`` and its mask the bits
    of ``var_valid[var_ids]`` (numpy, the reference's layout)."""
    var_ids = np.asarray(var_ids)
    assert bucket.var_ids32.dtype == torch.int32
    np.testing.assert_array_equal(bucket.var_ids32.numpy(), var_ids)
    np.testing.assert_array_equal(bucket.var_ids.numpy(), var_ids)
    d = np.asarray(var_valid).shape[1]
    if d > EDGE_VALID_MAX_D:
        assert bucket.edge_valid is None
        return
    assert bucket.edge_valid.dtype == torch.uint8
    assert bucket.edge_valid.shape == bucket.var_ids.shape
    np.testing.assert_array_equal(unpacked(bucket.edge_valid, d),
                                  np.asarray(var_valid)[var_ids])
    # No bit above D is set.
    assert int(bucket.edge_valid.max()) < 2 ** d


def assert_graph_matches(jax_graph, port_graph):
    assert len(jax_graph.buckets) == len(port_graph.buckets)
    for jb, tb in zip(jax_graph.buckets, port_graph.buckets):
        assert_arrays_match(np.asarray(jax_graph.var_valid),
                            np.asarray(jb.var_ids), tb)


def test_colouring_masks_equal_the_reference():
    g, tg = coloring_graphs("scatter")
    assert g.var_valid.shape[1] == 3
    assert_graph_matches(g, tg)


@pytest.mark.parametrize("aggregation", ["scatter", "sorted", "ell"])
def test_padded_arity_one_to_four_masks_equal_the_reference(aggregation):
    g, tg = strategy_graphs(4, aggregation, seed=5)
    assert [b.var_ids.shape[1] for b in g.buckets] == [1, 2, 3, 4]
    # Sentinel padding: the invalid row V gives an empty mask.
    n_vars = g.var_valid.shape[0] - 1
    for jb, tb in zip(g.buckets, tg.buckets):
        pad = np.asarray(jb.var_ids) == n_vars
        assert pad.any()
        assert (tb.edge_valid.numpy()[pad] == 0).all()
    assert_graph_matches(g, tg)


@pytest.mark.parametrize("pad_to", [1, 4])
def test_mixed_domain_masks_equal_the_reference(pad_to):
    jax_dcop, torch_dcop = load_both(MIXED_YAML)
    g, _ = jax_compile(jax_dcop, noise_level=0.0, use_cache=False,
                       pad_to=pad_to)
    tg, _ = torch_compile(torch_dcop, noise_level=0.0, use_cache=False,
                          pad_to=pad_to)
    valid = np.asarray(g.var_valid)
    # Rows with 2 and with 3 valid slots, and the padded slots invalid.
    assert {2, 3} <= set(valid[:-1].sum(axis=1).tolist())
    assert_graph_matches(g, to_device_graph(tg, "cpu"))


@pytest.mark.parametrize("d", range(1, EDGE_VALID_MAX_D + 2))
def test_random_validity_at_every_domain(d):
    """Any subset of slots valid (not only a prefix), every D to 9."""
    rng = np.random.default_rng(d)
    n_vars = 60
    var_valid = rng.random((n_vars + 1, d)) < 0.6
    var_valid[-1] = False
    var_costs = rng.normal(size=(n_vars + 1, d)).astype(np.float32)
    buckets = []
    for arity, f in ((1, 30), (2, 70)):
        ids = rng.integers(0, n_vars + 1, size=(f, arity)).astype(np.int32)
        buckets.append((np.zeros((f,) + (d,) * arity, np.float32), ids))
    tg = graph_from_numpy(var_costs, var_valid, buckets, device="cpu")
    for (_, ids), tb in zip(buckets, tg.buckets):
        assert_arrays_match(var_valid, ids, tb)


@pytest.mark.parametrize("d", [28, 30, 32, 33])
def test_fold_graphs_have_no_mask(d):
    g, tg = loopy_graphs(aggregation="scatter", d=d, seed=0,
                         unary="factors")
    assert all(b.edge_valid is None for b in tg.buckets)
    assert_graph_matches(g, tg)


def test_autotuned_graph_keeps_the_arrays(tmp_path, monkeypatch):
    monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE",
                       str(tmp_path / "agg_autotune.json"))
    jax_dcop, dcop = build_coloring_both(150)
    engine = build_engine(dcop, {"aggregation": "auto"}, device="cpu")
    assert engine.extra_metrics["aggregation_source"] == "measured"
    g, _ = jax_compile(jax_dcop, noise_level=0.01, use_cache=False)
    assert_graph_matches(g, engine.graph)


def _recording(monkeypatch, name, seen):
    """Replace ``ops.maxsum``'s ``name`` by a call that checks the
    arrays it receives against ``var_ids``/``var_valid``, then runs."""
    real = getattr(T, name)

    def check(*args, var_ids32=None, edge_valid=None, **kw):
        ids, valid = args[-4:-2]
        bucket = TorchFactorBucket(None, ids, var_ids32, edge_valid)
        assert_arrays_match(valid.numpy(), ids.numpy(), bucket)
        seen[name] += 1
        return real(*args, var_ids32=var_ids32, edge_valid=edge_valid, **kw)

    monkeypatch.setattr(T, name, check)


def test_decimated_run_passes_true_arrays(monkeypatch):
    _, teng = engines(coloring_both(seed=2))
    seen = {"v2f_update": 0, "send_update": 0}
    for name in seen:
        _recording(monkeypatch, name, seen)
    res = teng.run_checkpointed(
        max_cycles=300, segment_cycles=20,
        decimation=DecimationPlan(frac_per_round=0.5, cycles_per_round=20))
    assert res.metrics["decimation_rounds"] >= 2
    n = len(teng.graph.buckets) * res.cycles
    assert seen == {"v2f_update": n, "send_update": n}


def test_converted_graph_and_superstep_pass_the_bucket_arrays(monkeypatch):
    g, tg = strategy_graphs(4, "scatter", seed=6)
    seen = {"v2f_update": 0, "send_update": 0}
    for name in seen:
        _recording(monkeypatch, name, seen)
    state = state_from_numpy(**tiny_state(g, 13), device="cpu")
    T.run_maxsum_from(tg, state, 3, stop_on_convergence=False)
    assert seen == {"v2f_update": 12, "send_update": 12}


def _bucket_call(side):
    """(function, args, kwargs) of one wrapper call on the colouring's
    first bucket, with the bucket's arrays."""
    g, tg = coloring_graphs("scatter")
    ts = state_from_numpy(**tiny_state(g, 12), device="cpu")
    b = tg.buckets[0]
    if side == "v2f":
        tb, tsum = T.aggregate_beliefs(tg, ts.f2v)
        args = (tb, tsum, ts.f2v[0], ts.v2f[0], ts.v2f_count[0], b.var_ids,
                tg.var_valid, ts.cycle)
        return V.v2f_update, args, dict(var_ids32=b.var_ids32,
                                        edge_valid=b.edge_valid)
    args = (ts.f2v[0], ts.v2f[0], ts.f2v_count[0], b.var_ids, tg.var_valid,
            ts.cycle)
    return V.send_update, args, dict(var_ids32=b.var_ids32,
                                     edge_valid=b.edge_valid)


@pytest.mark.parametrize("side", ["v2f", "send"])
@pytest.mark.parametrize("damping", [0.5, 0.7])
def test_cpu_wrapper_with_the_arrays_equals_without(side, damping):
    fn, args, arrays = _bucket_call(side)
    flags = [torch.tensor(True), torch.tensor(True)]
    got = fn(*args, flags[0], damping=damping, stability=0.1, **arrays)
    want = fn(*args, flags[1], damping=damping, stability=0.1)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert bool(flags[0]) == bool(flags[1])


@pytest.mark.parametrize("side", ["v2f", "send"])
@pytest.mark.parametrize("bad,err", [
    ("ids_dtype", TypeError), ("ids_shape", ValueError),
    ("ids_device", ValueError), ("ids_non_contiguous", ValueError),
    ("valid_dtype", TypeError), ("valid_shape", ValueError),
    ("valid_device", ValueError), ("valid_non_contiguous", ValueError),
])
def test_wrapper_refuses_bad_bucket_arrays(side, bad, err):
    fn, args, arrays = _bucket_call(side)
    key = "var_ids32" if bad.startswith("ids") else "edge_valid"
    t = arrays[key]
    if bad.endswith("dtype"):
        t = t.to(torch.int64 if key == "var_ids32" else torch.bool)
    elif bad.endswith("shape"):
        t = t[:-1]
    elif bad.endswith("device"):
        t = torch.empty(t.shape, dtype=t.dtype, device="meta")
    else:
        t = torch.cat([t, t], dim=1)[:, ::2]
        assert not t.is_contiguous()
    arrays[key] = t
    with pytest.raises(err):
        fn(*args, torch.tensor(True), damping=0.5, stability=0.1, **arrays)


def test_wrapper_refuses_a_mask_above_eight_slots():
    g, tg = loopy_graphs(aggregation="scatter", d=33, seed=2,
                         unary="factors")
    ts = state_from_numpy(**tiny_state(g, 7), device="cpu")
    b = tg.buckets[0]
    mask = torch.zeros(b.var_ids.shape, dtype=torch.uint8)
    with pytest.raises(ValueError, match="edge_valid"):
        V.send_update(ts.f2v[0], ts.v2f[0], ts.f2v_count[0], b.var_ids,
                      tg.var_valid, ts.cycle, torch.tensor(True),
                      damping=0.5, stability=0.1, var_ids32=b.var_ids32,
                      edge_valid=mask)


@pytest.mark.parametrize("n_edges,d,n_sms,want", [
    (3_000_000, 3, 132, 4),   # the scale bucket: the table's size
    (29_998, 3, 132, 1),      # the flagship: 118 blocks of one edge each
    (135_168, 3, 132, 4),     # exactly one 1,024-edge tile per SM
    (134_144, 3, 132, 2),     # 131 such tiles: two edges a thread
    (70_000, 8, 132, 2),
    (60_000, 8, 132, 1),
    (0, 2, 132, 1),
    (10 ** 7, 20, 132, 1),    # above D = 8: the generic kernel
])
def test_tile_items_gives_every_sm_a_block(n_edges, d, n_sms, want):
    assert V.tile_items(n_edges, d, n_sms) == want
