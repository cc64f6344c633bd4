"""The port's aggregation autotuner (pydcop_tpu_torch/engine/autotune.py)
and ``aggregation="auto"`` (algorithms/maxsum.py), on the CPU.

- The shape keys equal the reference's for the same backend string, from
  the compiled graph and from the DCOP before compiling.
- A decision is measured once, stored in the JSON file named by
  ``PYDCOP_AGG_AUTOTUNE_CACHE`` (a temporary file here, never under the
  home directory) and replayed: by the autotuner, and by ``build_engine``
  before it compiles.  An invalid or unreadable entry is measured again.
- The ell hub guard's refusal drops ell from the candidates; any other
  error while a strategy is timed (a kernel that fails to build or
  launch) propagates.
- Mesh and edge-free graphs resolve to scatter without measuring.
"""

import json

import jax  # noqa: F401  (imported first: JAX stays on the CPU)
import numpy as np
import pytest
import torch

import pydcop_tpu.engine.autotune as JA
import pydcop_tpu_torch.engine.autotune as TA
from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu_torch.algorithms.maxsum import build_engine
from pydcop_tpu_torch.engine.compile import compile_dcop as torch_compile
from test_torch_compile import MIXED_YAML, build_coloring_both, load_both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cache_file(tmp_path, monkeypatch):
    path = tmp_path / "agg_autotune.json"
    monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE", str(path))
    return path


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
@pytest.mark.parametrize("problem", ["coloring_12_3.yml", MIXED_YAML,
                                     "coloring300"])
def test_shape_keys_equal_reference(problem, backend):
    if problem == "coloring300":
        jax_dcop, torch_dcop = build_coloring_both(300)
    else:
        jax_dcop, torch_dcop = load_both(problem)
    g, _ = jax_compile(jax_dcop)
    tg, _ = torch_compile(torch_dcop)
    key = TA.graph_shape_key(tg, backend)
    assert key == JA.graph_shape_key(g, backend)
    assert TA.dcop_shape_key(torch_dcop, backend) == key
    assert JA.dcop_shape_key(jax_dcop, backend) == key
    assert TA.graph_max_degree(tg) == JA.graph_max_degree(g)
    assert f"|{backend}|" in key


def test_cache_path_default_and_override(monkeypatch, tmp_path):
    monkeypatch.delenv("PYDCOP_AGG_AUTOTUNE_CACHE", raising=False)
    assert TA.cache_path().endswith(
        "/.cache/pydcop_tpu_torch/agg_autotune.json")
    monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE", str(tmp_path / "x"))
    assert TA.cache_path() == str(tmp_path / "x")


def test_measured_then_replayed(cache_file):
    _, dcop = build_coloring_both(200)
    graph, _ = torch_compile(dcop)
    first = TA.autotune_aggregation(graph, device="cpu")
    assert first["aggregation_source"] == "measured"
    assert first["aggregation"] in TA.SELECTABLE
    timings = first["aggregation_timings_ms"]
    assert set(timings) == {"scatter", "sorted", "boundary", "ell"}
    assert all(t is not None and t > 0 for t in timings.values())
    stored = json.loads(cache_file.read_text())[first["aggregation_key"]]
    assert stored["backend"] == "cpu"
    second = TA.autotune_aggregation(graph, device="cpu")
    assert second["aggregation_source"] == "cache"
    assert second["aggregation"] == first["aggregation"]
    assert second["aggregation_timings_ms"] == timings


def test_build_engine_measures_then_replays_before_compiling(cache_file):
    _, dcop = build_coloring_both(150)
    first = build_engine(dcop, {"aggregation": "auto"}, device="cpu")
    info = first.extra_metrics
    assert info["aggregation_source"] == "measured"
    assert first.graph.agg_strategy == info["aggregation"]
    # Replay: the stored winner is the aggregation compiled with.
    data = json.loads(cache_file.read_text())
    data[info["aggregation_key"]]["aggregation"] = "ell"
    cache_file.write_text(json.dumps(data))
    again = build_engine(dcop, {"aggregation": "auto"}, device="cpu")
    assert again.extra_metrics == {"aggregation": "ell",
                                   "aggregation_source": "cache",
                                   "aggregation_key": info["aggregation_key"]}
    assert again.graph.agg_strategy == "ell"
    res = again.run(max_cycles=20)
    assert res.metrics["aggregation"] == "ell"


@pytest.mark.parametrize("entry", [
    {"aggregation": "boundary"}, {"aggregation": "nope"}, "scatter", None,
])
def test_invalid_entry_is_measured_again(cache_file, entry):
    _, dcop = build_coloring_both(80)
    graph, _ = torch_compile(dcop)
    key = TA.graph_shape_key(graph, "cpu")
    cache_file.write_text(json.dumps({key: entry}))
    assert TA.cached_choice(key) is None
    info = TA.autotune_aggregation(graph, device="cpu")
    assert info["aggregation_source"] == "measured"
    assert TA.cached_choice(key) == info["aggregation"]


def test_unreadable_cache_is_measured(cache_file):
    cache_file.write_text("{not json")
    _, dcop = build_coloring_both(80)
    graph, _ = torch_compile(dcop)
    info = TA.autotune_aggregation(graph, device="cpu")
    assert info["aggregation_source"] == "measured"


def test_hub_guard_drops_ell(cache_file, monkeypatch):
    real = TA.build_aggregation_arrays

    def guarded(buckets, n_segments, aggregation):
        if aggregation == "ell":
            raise ValueError("aggregation='ell' would allocate a hub: x")
        return real(buckets, n_segments, aggregation)

    monkeypatch.setattr(TA, "build_aggregation_arrays", guarded)
    _, dcop = build_coloring_both(80)
    graph, _ = torch_compile(dcop)
    info = TA.autotune_aggregation(graph, device="cpu", use_cache=False)
    assert info["aggregation_timings_ms"]["ell"] is None
    assert info["aggregation_notes"] == {
        "ell": "aggregation='ell' would allocate a hub"}
    assert info["aggregation"] in ("scatter", "sorted")
    assert not cache_file.exists()


def test_error_while_timing_propagates(cache_file, monkeypatch):
    """A failure to build or launch a kernel while a strategy is timed
    fails the tuning: it is not taken for a refusal."""
    import pydcop_tpu_torch.ops.maxsum as ops

    real = ops.aggregate_beliefs

    def failing(graph, f2v):
        if graph.agg_strategy == "sorted":
            raise RuntimeError("segment_sum launch failed: CUDA error 98")
        return real(graph, f2v)

    monkeypatch.setattr(ops, "aggregate_beliefs", failing)
    _, dcop = build_coloring_both(80)
    graph, _ = torch_compile(dcop)
    with pytest.raises(RuntimeError, match="launch failed"):
        TA.autotune_aggregation(graph, device="cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        build_engine(dcop, {"aggregation": "auto"}, device="cpu")
    assert not cache_file.exists()


def test_mesh_and_edge_free_graphs_resolve_to_scatter(cache_file):
    _, dcop = build_coloring_both(40)
    graph, _ = torch_compile(dcop)
    info = TA.autotune_aggregation(graph, pad_to=4, device="cpu")
    assert (info["aggregation"], info["aggregation_source"]) == (
        "scatter", "mesh")
    assert all(t is None for t in info["aggregation_timings_ms"].values())
    empty = graph._replace(buckets=())
    info = TA.autotune_aggregation(empty, device="cpu")
    assert (info["aggregation"], info["aggregation_source"]) == (
        "scatter", "empty")
    assert not cache_file.exists()


def test_apply_aggregation_equals_compiling_with_it():
    _, dcop = build_coloring_both(60)
    scatter, _ = torch_compile(dcop, use_cache=False)
    for strategy in ("sorted", "boundary", "ell"):
        direct, _ = torch_compile(dcop, aggregation=strategy,
                                  use_cache=False)
        applied = TA.apply_aggregation(scatter, strategy)
        for field in ("agg_perm", "agg_sorted_seg", "agg_starts",
                      "agg_ends", "agg_ell"):
            a, b = getattr(direct, field), getattr(applied, field)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
