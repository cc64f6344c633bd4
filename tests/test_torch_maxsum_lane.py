"""The lane layout (pydcop_tpu_torch/ops/maxsum_lane.py) against the JAX
package's (pydcop_tpu/ops/maxsum_lane.py), on the CPU, after
``tests/unit/test_maxsum_lane.py``.

Tolerance: none.  Every comparison is bit-equality (``uint32`` views of
float32): each lane op against the reference's jitted with the graph as
an argument (as its engine runs it), whole runs (values, cycle,
``stable`` and every message and count, stop on and off, damping 0.5
and 0.7, domains up to 40), a state with subnormal messages compared
after every cycle, the cost trace and the standalone constraint cost
(the lane site of ``window_sum.gather_stages``), the engine, ``api.solve``
and the CLI's ``-p layout:lane``.  The reference's own tests hold lane
against edge only to a tolerance (the layouts add a variable's edges in
different orders); the port follows the lane reference's order, so it
needs none.  The host half (relayout, packing, per-member convergence)
is held ``np.array_equal`` to the reference's, and the refusals raise
the reference's error types.
"""

import json
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.api import solve as jax_solve
from pydcop_tpu.dcop.dcop import DCOP as JDCOP
from pydcop_tpu.dcop.objects import Domain as JDomain
from pydcop_tpu.dcop.objects import Variable as JVariable
from pydcop_tpu.dcop.relations import NAryMatrixRelation as JRel
from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu.engine.runner import MaxSumEngine as JEngine
from pydcop_tpu.ops import maxsum_lane as JL
from pydcop_tpu_torch.algorithms.maxsum import build_engine
from pydcop_tpu_torch.api import solve as torch_solve
from pydcop_tpu_torch.dcop.dcop import DCOP as TDCOP
from pydcop_tpu_torch.dcop.objects import Domain as TDomain
from pydcop_tpu_torch.dcop.objects import Variable as TVariable
from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation as TRel
from pydcop_tpu_torch.device import to_lane_device_graph
from pydcop_tpu_torch.engine import roofline as TR
from pydcop_tpu_torch.engine.compile import CompiledFactorGraph, FactorBucket
from pydcop_tpu_torch.engine.compile import compile_dcop as torch_compile
from pydcop_tpu_torch.engine.convert import (
    lane_graph_from_numpy,
    lane_state_from_numpy,
    state_to_numpy,
)
from pydcop_tpu_torch.engine.runner import MaxSumEngine as TEngine
from pydcop_tpu_torch.ops import maxsum_lane as TL
from pydcop_tpu_torch.ops.binary_factor import (
    binary_factor_update_lane,
    binary_factor_update_reference,
)
from test_torch_compile import INSTANCES, load_both
from test_torch_var_update import tiny_state
from test_torch_window_sum_open_shapes import costs, skeleton


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_dcop(mods, n_vars=12, n_edges=18, d=3, seed=0, ternary=False):
    """The reference test's ``_random_dcop``, built with either
    package's classes."""
    dcop_cls, dom_cls, var_cls, rel_cls = mods
    rng = np.random.default_rng(seed)
    dom = dom_cls("d", "", list(range(d)))
    dcop = dcop_cls("rand", objective="min")
    variables = [var_cls(f"v{i}", dom) for i in range(n_vars)]
    for v in variables:
        dcop.add_variable(v)
    seen = set()
    k = 0
    while k < n_edges:
        i, j = rng.choice(n_vars, size=2, replace=False)
        key = (min(i, j), max(i, j))
        if key in seen:
            continue
        seen.add(key)
        table = rng.integers(0, 10, size=(d, d)).astype(np.float64)
        dcop.add_constraint(rel_cls([variables[i], variables[j]], table,
                                    f"c{k}"))
        k += 1
    if ternary:
        i, j, l = rng.choice(n_vars, size=3, replace=False)
        table = rng.integers(0, 10, size=(d, d, d)).astype(np.float64)
        dcop.add_constraint(rel_cls(
            [variables[i], variables[j], variables[l]], table, "t0"))
    return dcop


JMODS = (JDCOP, JDomain, JVariable, JRel)
TMODS = (TDCOP, TDomain, TVariable, TRel)


def random_both(**kw):
    return _random_dcop(JMODS, **kw), _random_dcop(TMODS, **kw)


def port_lane(lane):
    """The port's placed copy (CPU) of a reference lane graph."""
    return lane_graph_from_numpy(
        lane.var_costs, lane.var_valid,
        [(b.costs, b.var_ids) for b in lane.buckets], "cpu")


def port_graph(g):
    return CompiledFactorGraph(
        np.asarray(g.var_costs), np.asarray(g.var_valid),
        tuple(FactorBucket(np.asarray(b.costs), np.asarray(b.var_ids))
              for b in g.buckets))


def drawn_lane(v, buckets, d, seed, decades=3):
    """A reference lane graph of random factors (``skeleton``) with
    costs drawn over ``decades``."""
    rng = np.random.default_rng(seed)
    lane = JL.to_lane_graph(skeleton(v, buckets, d, seed))
    return lane._replace(
        var_costs=costs(rng, lane.var_costs.shape, decades),
        buckets=tuple(b._replace(costs=np.abs(costs(rng, b.costs.shape,
                                                    decades)))
                      for b in lane.buckets))


def bits_equal(a, b):
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(b)
    assert a.shape == b.shape
    if a.dtype == np.float32:
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    else:
        np.testing.assert_array_equal(a, b)


def msgs(lane, seed, tiny=False):
    """Random lane messages per bucket: order 1 (or with subnormals),
    BIG on invalid slots."""
    rng = np.random.default_rng(seed)
    out = []
    for b in lane.buckets:
        ids = np.asarray(b.var_ids)
        shape = (lane.var_costs.shape[0],) + ids.shape
        m = rng.normal(size=shape)
        if tiny:
            t = rng.random(shape) < 0.5
            m[t] = np.sign(m[t]) * 10.0 ** rng.uniform(-37.9, -36, t.sum())
        valid = np.asarray(lane.var_valid)[:, ids]
        out.append(np.where(valid, m.astype(np.float32), np.float32(1e9)))
    return out


def t(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


GRAPHS = [
    (12, [(2, 20)], 3),
    (12, [(1, 3), (2, 15), (3, 4)], 3),
    (40, [(1, 1), (2, 30)], 2),
    (40, [(2, 1), (3, 6), (4, 2)], 5),
    (12, [(2, 23), (3, 8)], 1),
    (40, [(2, 40), (3, 30)], 8),
    (9, [(2, 12)], 33),
]


# ------------------------------------------------------------------ #
# Host half.


@pytest.mark.parametrize("ternary", [False, True])
def test_to_lane_graph_equals_reference(ternary):
    jd, td = random_both(ternary=ternary)
    g, _ = jax_compile(jd)
    tg, _ = torch_compile(td)
    ref, got = JL.to_lane_graph(g), TL.to_lane_graph(tg)
    bits_equal(ref.var_costs, got.var_costs)
    bits_equal(ref.var_valid, got.var_valid)
    assert got.n_vars == ref.n_vars and got.dmax == ref.dmax
    for rb, pb in zip(ref.buckets, got.buckets):
        bits_equal(rb.costs, pb.costs)
        bits_equal(rb.var_ids, pb.var_ids)
        assert (pb.arity, pb.n_factors) == (rb.arity, rb.n_factors)


@pytest.mark.parametrize("d_env", [None, 5])
def test_pack_graphs_equals_reference(d_env):
    members = [skeleton(12, [(2, 9)], 3, 1),
               skeleton(7, [(1, 2), (3, 4)], 2, 2),
               skeleton(20, [(2, 5), (3, 1)], 4, 3)]
    ref_u, ref_l = JL.pack_graphs(members, d_env=d_env)
    got_u, got_l = TL.pack_graphs([port_graph(g) for g in members],
                                  d_env=d_env)
    assert got_l == ref_l
    bits_equal(ref_u.var_costs, got_u.var_costs)
    bits_equal(ref_u.var_valid, got_u.var_valid)
    for rb, pb in zip(ref_u.buckets, got_u.buckets):
        bits_equal(rb.costs, pb.costs)
        bits_equal(rb.var_ids, pb.var_ids)
    rng = np.random.default_rng(0)
    counts = [rng.integers(1, 4, size=b.var_ids.shape[::-1]).astype(np.int8)
              for b in ref_u.buckets]
    other = [np.full_like(c, 3) for c in counts]
    assert (TL.converged_per_graph(counts, other, got_l)
            == JL.converged_per_graph(counts, other, ref_l))
    assert (TL.converged_per_graph(other, other, got_l)
            == JL.converged_per_graph(other, other, ref_l))


def test_pack_graphs_refusals():
    with pytest.raises(ValueError, match="at least one"):
        TL.pack_graphs([])
    with pytest.raises(ValueError, match="d_env"):
        TL.pack_graphs([port_graph(skeleton(6, [(2, 3)], 4, 0))], d_env=2)


# ------------------------------------------------------------------ #
# Device half, op by op.


@pytest.mark.parametrize("spec", GRAPHS)
def test_factor_to_var(spec):
    lane = drawn_lane(*spec, 1)
    v2f = msgs(lane, 2)
    ref = jax.jit(JL.factor_to_var)(lane, tuple(v2f))
    got = TL.factor_to_var(port_lane(lane), t(v2f))
    for r, p in zip(ref, got):
        bits_equal(r, p)


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("spec", GRAPHS)
def test_aggregate_and_var_to_factor(spec, tiny):
    lane = drawn_lane(*spec, 3)
    f2v = msgs(lane, 4, tiny)

    def ref_fn(g, m):
        beliefs, sums = JL.aggregate_beliefs(g, m)
        return beliefs, sums, JL.var_to_factor(g, m, beliefs, sums)

    rb, rs, rv = jax.jit(ref_fn)(lane, tuple(f2v))
    pg = port_lane(lane)
    pb, ps = TL.aggregate_beliefs(pg, t(f2v))
    bits_equal(rb, pb)
    bits_equal(rs, ps)
    for r, p in zip(rv, TL.var_to_factor(pg, t(f2v), pb, ps)):
        bits_equal(r, p)
    bits_equal(jax.jit(JL.select_values)(lane, rb),
               TL.select_values(pg, pb))


@pytest.mark.parametrize("damping", [0.5, 0.7])
@pytest.mark.parametrize("spec", GRAPHS[:4])
def test_superstep_on_a_subnormal_state_every_cycle(spec, damping):
    """A mid-run state with messages of 1.2e-38..1e-36 (the edge
    layout's ``tiny_state``, transposed), stepped five times; every
    field compared after every cycle."""
    lane = drawn_lane(*spec, 5)
    edge = skeleton(*spec, 5)
    s = tiny_state(edge._replace(var_valid=np.asarray(lane.var_valid).T),
                   6)
    kw = dict(damping=damping, damp_vars=True, damp_factors=True,
              stability=0.1)
    rstate = JL.LaneState(
        v2f=tuple(jnp.asarray(np.transpose(m, (2, 1, 0))) for m in s["v2f"]),
        f2v=tuple(jnp.asarray(np.transpose(m, (2, 1, 0))) for m in s["f2v"]),
        v2f_count=tuple(jnp.asarray(c.T) for c in s["v2f_count"]),
        f2v_count=tuple(jnp.asarray(c.T) for c in s["f2v_count"]),
        stable=jnp.asarray(False), cycle=jnp.asarray(3, jnp.int32))
    pstate = lane_state_from_numpy(*rstate[:4], stable=False, cycle=3,
                                   device="cpu")
    step = jax.jit(partial(JL.superstep, **kw))
    pg = port_lane(lane)
    for _ in range(5):
        rstate = step(rstate, lane)
        pstate = TL.superstep(pstate, pg, **kw)
        for rf, pf in zip(rstate[:4], pstate[:4]):
            for r, p in zip(rf, pf):
                bits_equal(r, p)
        assert bool(rstate.stable) == bool(pstate.stable)
        assert int(rstate.cycle) == int(pstate.cycle)


# ------------------------------------------------------------------ #
# Whole runs.


def _assert_same_run(rs, rv, ps, pv):
    bits_equal(rv, pv)
    got = state_to_numpy(ps)
    assert (got["cycle"], got["stable"]) == (int(rs.cycle), bool(rs.stable))
    for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
        for r, p in zip(getattr(rs, field), got[field]):
            bits_equal(r, p)


@pytest.mark.parametrize("stop,damping", [(True, 0.5), (False, 0.7)])
@pytest.mark.parametrize("spec", GRAPHS)
def test_whole_run(spec, stop, damping):
    lane = drawn_lane(*spec, 7, decades=1)
    rs, rv = jax.jit(partial(JL.run_maxsum, max_cycles=30, damping=damping,
                             stop_on_convergence=stop))(lane)
    ps, pv = TL.run_maxsum(port_lane(lane), 30, damping=damping,
                           stop_on_convergence=stop)
    _assert_same_run(rs, rv, ps, pv)


@pytest.mark.parametrize("seed,ternary", [(0, False), (1, False),
                                          (2, True)])
@pytest.mark.parametrize("stop", [True, False])
def test_reference_instances_run(seed, ternary, stop):
    jd, _ = random_both(seed=seed, ternary=ternary)
    g, _ = jax_compile(jd, noise_level=0.01)
    lane = JL.to_lane_graph(g)
    rs, rv = jax.jit(lambda x: JL.run_maxsum(
        x, 60, stop_on_convergence=stop))(lane)
    ps, pv = TL.run_maxsum(port_lane(lane), 60, stop_on_convergence=stop)
    _assert_same_run(rs, rv, ps, pv)


def test_run_from_a_state_in_segments():
    lane = drawn_lane(12, [(1, 3), (2, 15), (3, 4)], 3, 8)
    pg = port_lane(lane)
    state, _ = TL.run_maxsum(pg, 7, stop_on_convergence=False)
    state, pv = TL.run_maxsum_from(pg, state, 13, stop_on_convergence=False)
    rs, rv = jax.jit(lambda x: JL.run_maxsum(
        x, 20, stop_on_convergence=False))(lane)
    _assert_same_run(rs, rv, state, pv)


# ------------------------------------------------------------------ #
# Totals: the standalone constraint cost and the trace.


COST_SHAPES = [
    (40, [(2, 16)], 3), (40, [(2, 20)], 4), (40, [(3, 16)], 2),
    (40, [(1, 20)], 3), (40, [(3, 23)], 5), (40, [(2, 24), (3, 8)], 3),
    (40, [(4, 31)], 2), (40, [(2, 32)], 8), (40, [(2, 33)], 3),
    (40, [(1, 24), (2, 20), (3, 17)], 3), (40, [(3, 20)], 1),
    (40, [(3, 28)], 1), (40, [(5, 22)], 1), (40, [(7, 16)], 1),
    (40, [(2, 17)], 9), (40, [(2, 500), (3, 21)], 2),
]


@pytest.mark.parametrize("spec", COST_SHAPES)
def test_constraint_cost(spec):
    v, buckets, d = spec
    cost = jax.jit(JL.assignment_constraint_cost)
    for seed in range(6):
        lane = drawn_lane(v, buckets, d, seed, decades=(1, 3, 6)[seed % 3])
        lane = lane._replace(buckets=tuple(
            b._replace(costs=costs(np.random.default_rng(seed),
                                   b.costs.shape, 3))
            for b in lane.buckets))
        vals = np.random.default_rng(seed + 9).integers(0, d, v).astype(
            np.int32)
        bits_equal(cost(lane, vals),
                   TL.assignment_constraint_cost(port_lane(lane),
                                                 torch.from_numpy(vals)))


TRACE_SHAPES = [
    (12, [(2, 20)], 3), (40, [(2, 30), (3, 12)], 3), (22, [(2, 40)], 3),
    (28, [(2, 40)], 2), (24, [(2, 16), (3, 20)], 5), (12, [(1, 24)], 4),
    (300, [(2, 450)], 3),
]


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("spec", TRACE_SHAPES)
def test_trace_costs(spec, with_base):
    v, buckets, d = spec
    for seed in range(3):
        lane = drawn_lane(v, buckets, d, seed, decades=(1, 3, 6)[seed])
        base = costs(np.random.default_rng(seed), (v, d), 3) \
            if with_base else None
        rs, rv, rc = jax.jit(lambda x: JL.run_maxsum_trace(
            x, 15, var_base_costs=None if base is None
            else jnp.asarray(base)))(lane)
        ps, pv, pc = TL.run_maxsum_trace(
            port_lane(lane), 15, var_base_costs=None if base is None
            else torch.from_numpy(base))
        bits_equal(rc, pc)
        _assert_same_run(rs, rv, ps, pv)


# ------------------------------------------------------------------ #
# Engine, api and CLI.


@pytest.mark.parametrize("fixture,cycles", [
    ("coloring_12_3.yml", 60), ("loft_scene.yml", 100),
    ("pref_ring_max.yaml", 100), ("coloring_ring_hard.yaml", 100),
])
def test_engine_run_and_trace(fixture, cycles):
    jd, td = load_both(fixture)
    g, meta = jax_compile(jd, noise_level=0.01)
    tg, tmeta = torch_compile(td, noise_level=0.01)
    ref = JEngine(g, meta, layout="lane")
    got = TEngine(tg, tmeta, layout="lane", device="cpu")
    r, p = ref.run(max_cycles=cycles), got.run(max_cycles=cycles)
    assert p.assignment == r.assignment
    assert (p.cycles, p.converged) == (r.cycles, r.converged)
    assert p.metrics["msg_count"] == 2 * sum(
        b.var_ids.size for b in g.buckets) * r.cycles
    r, p = ref.run_trace(max_cycles=40), got.run_trace(max_cycles=40)
    assert p.assignment == r.assignment
    bits_equal(r.metrics["cost_trace"].astype(np.float32),
               p.metrics["cost_trace"].astype(np.float32))


def test_engine_segmented_run_equals_one_run():
    _, td = load_both("coloring_12_3.yml")
    tg, tmeta = torch_compile(td, noise_level=0.01)
    eng = TEngine(tg, tmeta, layout="lane", device="cpu")
    whole = eng.run(max_cycles=60, stop_on_convergence=False)
    seg = eng.run_checkpointed(max_cycles=60, segment_cycles=7,
                               stop_on_convergence=False)
    assert seg.assignment == whole.assignment
    assert seg.cycles == whole.cycles == 60


@pytest.mark.parametrize("fixture", ["coloring_12_3.yml", "loft_scene.yml"])
def test_api_solve_with_layout_param(fixture):
    jd, td = load_both(fixture)
    ref = jax_solve(jd, "maxsum", max_cycles=80,
                    algo_params={"layout": "lane"})
    out = torch_solve(td, "maxsum", max_cycles=80,
                      algo_params={"layout": "lane"}, device="cpu")
    for key in ("assignment", "cost", "violations", "cycles", "status"):
        assert out[key] == ref[key], key


def test_auto_aggregation_with_lane_records_its_source():
    _, td = load_both("coloring_12_3.yml")
    eng = build_engine(td, {"layout": "lane", "aggregation": "auto"},
                       device="cpu")
    assert eng.extra_metrics == {"aggregation": "scatter",
                                 "aggregation_source": "lane"}


def test_cli_layout_lane():
    env = dict(os.environ, PYTHONPATH=REPO)
    path = os.path.join(INSTANCES, "coloring_12_3.yml")
    proc = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", "--algo",
         "maxsum", "-c", "60", "-p", "layout:lane", "--device", "cpu",
         path], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout)
    ref = jax_solve(load_both("coloring_12_3.yml")[0], "maxsum",
                    max_cycles=60, algo_params={"layout": "lane"})
    assert result["assignment"] == ref["assignment"]
    assert result["cost"] == ref["cost"]
    assert result["cycle"] == ref["cycles"]


def test_lane_checkpoints_resume_across_packages(tmp_path):
    """The lane layout's snapshots are the reference's NPZ: each package
    resumes the other's, and the segmented, recovered and observed
    solves give the reference's assignment."""
    from pydcop_tpu.resilience.recovery import RecoveryPolicy as JPolicy
    from pydcop_tpu_torch.resilience.recovery import RecoveryPolicy

    jd, td = load_both("coloring_12_3.yml")
    lane = {"layout": "lane"}
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = jax_solve(jd, "maxsum", max_cycles=90, algo_params=lane,
                    checkpoint_dir=ref_dir, checkpoint_every=20)
    out = torch_solve(td, "maxsum", max_cycles=90, algo_params=lane,
                      checkpoint_dir=port_dir, checkpoint_every=20,
                      device="cpu")
    assert (out["assignment"], out["cycles"]) == (ref["assignment"],
                                                  ref["cycles"])
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))
    ref = jax_solve(jd, "maxsum", max_cycles=120, algo_params=lane,
                    checkpoint_dir=port_dir, checkpoint_every=20,
                    resume=True)
    out = torch_solve(td, "maxsum", max_cycles=120, algo_params=lane,
                      checkpoint_dir=ref_dir, checkpoint_every=20,
                      resume=True, device="cpu")
    assert (out["assignment"], out["cycles"]) == (ref["assignment"],
                                                  ref["cycles"])
    ref = jax_solve(jd, "maxsum", max_cycles=60, algo_params=lane,
                    recovery=JPolicy())
    out = torch_solve(td, "maxsum", max_cycles=60, algo_params=lane,
                      recovery=RecoveryPolicy(), device="cpu",
                      metrics_file=str(tmp_path / "m.jsonl"),
                      metrics_every=20)
    assert (out["assignment"], out["cycles"]) == (ref["assignment"],
                                                  ref["cycles"])
    # The probe prices no lane chunk, as the reference's does not.
    snapshots = [json.loads(line) for line in
                 (tmp_path / "m.jsonl").read_text().splitlines()]
    assert snapshots and all(s["cost"] is None for s in snapshots)


# ------------------------------------------------------------------ #
# Refusals (the reference's, with its error types).


def _engine_args(**kw):
    _, td = random_both()
    return torch_compile(td, **kw)


def test_lane_requires_scatter():
    g, meta = _engine_args(aggregation="sorted")
    with pytest.raises(ValueError, match="scatter"):
        TEngine(g, meta, layout="lane", device="cpu")


def test_lane_is_single_device():
    g, meta = _engine_args(pad_to=8)
    with pytest.raises(ValueError, match="single-device"):
        TEngine(g, meta, layout="lane", n_devices=8, device="cpu")


def test_bad_layout_rejected():
    g, meta = _engine_args()
    with pytest.raises(ValueError, match="layout"):
        TEngine(g, meta, layout="columns", device="cpu")


def test_lane_refuses_prune():
    g, meta = _engine_args()
    with pytest.raises(ValueError, match="edge"):
        TEngine(g, meta, layout="lane", prune=True, device="cpu")
    with pytest.raises(NotImplementedError):
        TL.run_maxsum(port_lane(JL.to_lane_graph(jax_compile(
            random_both()[0])[0])), 3, prune=True)


def test_engine_lane_rejects_decimation():
    g, meta = _engine_args()
    eng = TEngine(g, meta, layout="lane", device="cpu")
    with pytest.raises(ValueError, match="edge"):
        eng.run_decimated(max_cycles=10)
    from pydcop_tpu_torch.engine.runner import DecimationPlan
    with pytest.raises(ValueError, match="edge"):
        eng.run_checkpointed(max_cycles=10, decimation=DecimationPlan())


def test_lane_with_shards_refused():
    _, td = random_both()
    with pytest.raises(ValueError, match="single-device"):
        build_engine(td, {"layout": "lane"}, shards=2, device="cpu")


def test_roofline_rejects_lane_graphs():
    g, _ = _engine_args()
    lane = TL.to_lane_graph(g)
    for graph in (lane, to_lane_device_graph(lane, "cpu")):
        with pytest.raises(TypeError, match="edge-major"):
            TR.roofline_report(graph, cycles_per_s=1000.0, platform="cpu")


# ------------------------------------------------------------------ #
# The kernel entry's plain version.


@pytest.mark.parametrize("d,f", [(1, 7), (3, 130), (8, 33), (11, 5)])
def test_binary_lane_entry_equals_the_edge_entry(d, f):
    rng = np.random.default_rng(d)
    c = torch.from_numpy(costs(rng, (f, d, d), 3))
    m = torch.from_numpy(costs(rng, (f, 2, d), 3))
    edge = binary_factor_update_reference(c, m)
    lane = binary_factor_update_lane(c.permute(1, 2, 0).contiguous(),
                                     m.permute(2, 1, 0).contiguous())
    bits_equal(edge.permute(2, 1, 0).contiguous().numpy(), lane)


def test_unit_domain_trace_with_base_costs_is_open():
    """One-value domains (D = 1) in the lane layout's traced run with
    variable base costs: every value is 0 and the engine closes the
    costs over, so XLA sums them while compiling
    (``window_sum.folded_sum``)."""
    lane = drawn_lane(32, [(1, 2)], 1, 2, decades=6)
    base = costs(np.random.default_rng(2), (32, 1), 6)
    _, _, rc = jax.jit(lambda x: JL.run_maxsum_trace(
        x, 4, var_base_costs=jnp.asarray(base)))(lane)
    _, _, pc = TL.run_maxsum_trace(port_lane(lane), 4,
                                   var_base_costs=torch.from_numpy(base))
    bits_equal(rc, pc)
