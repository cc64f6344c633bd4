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
  ``segment_sum`` on a four-bucket graph with sentinel padding and on a
  hub, ``binary_factor_update`` at every templated D, a generic D, a
  ragged F and an unaligned view.
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
    segment_sum,
    segment_sum_reference,
)

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


@pytest.mark.gpu
def test_segment_sum_kernel_equals_plain_version():
    _need_card()
    rng = np.random.default_rng(2)
    for graph in _graphs():
        n_edges, d = graph.agg_perm.shape[0], graph.var_costs.shape[1]
        msgs = torch.tensor(
            (rng.normal(size=(n_edges, d))
             * 10.0 ** rng.integers(-3, 4, size=(n_edges, d))
             ).astype(np.float32), device="cuda")
        args = (msgs, graph.agg_perm, graph.agg_offsets, graph.agg_buckets,
                graph.var_costs)
        before = _build.launch_counts["segment_sum"]
        beliefs, sums = segment_sum(*args)
        torch.cuda.synchronize()
        assert _build.launch_counts["segment_sum"] == before + 1
        ref_b, ref_s = segment_sum_reference(*(t.cpu() for t in args))
        assert torch.equal(sums.cpu(), ref_s)
        assert torch.equal(beliefs.cpu(), ref_b)


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
