"""The reference's ``tests/unit/test_envelope_battery.py``, case for
case, against the port (``pydcop_tpu_torch``) on the CPU: every
service, engine and front end runs with ``device="cpu"``.  The
reference's text:

Battery for heterogeneous-structure envelope batching:
envelope-key ladder properties (covering, monotone), mask-padding
bit-identity against solo dispatches across topologies / arities /
domains, lane-packed disjoint unions (values, honest per-member
convergence), pad-accounting honesty (``envelope_waste`` sums), the
pack-vs-solo cost model and its portfolio-cache prior replay, the
scheduler's flush planning, the ``normalize_params`` ``prune=-1``
fall-through regression, and the ``serve_mixed`` sentinel family."""

import json

import numpy as np
import pytest

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
from pydcop_tpu_torch.dcop.relations import (
    NAryMatrixRelation,
    constraint_from_str,
)
from pydcop_tpu_torch.engine import batch as engine_batch
from pydcop_tpu_torch.engine.compile import compile_dcop
from pydcop_tpu_torch.ops import maxsum_lane as lane_ops
from pydcop_tpu_torch.serving import binning
from pydcop_tpu_torch.serving.service import SolveService

import torch_serving_common as common


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _cold_dispatch_caches(monkeypatch, tmp_path):
    """Both packages' dispatch caches empty, a private autotune cache,
    and the pack model's online fit isolated
    (``torch_serving_common.isolated``)."""
    with common.isolated(monkeypatch, tmp_path):
        yield


MAX_CYCLES = 40
PARAMS = {"max_cycles": MAX_CYCLES}


def _ring(n: int, d: int, seed: int, chords: int = 0) -> DCOP:
    rng = np.random.default_rng(seed)
    dom = Domain("c", "", list(range(d)))
    dcop = DCOP(f"ring{n}_{d}_{seed}_{chords}", objective="min")
    vs = [Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    edges = [(i, (i + 1) % n) for i in range(n)]
    edges += [(i, (i + n // 2) % n) for i in range(chords)]
    for k, (i, j) in enumerate(edges):
        table = rng.integers(0, 10, size=(d, d)).astype(float)
        dcop.add_constraint(
            NAryMatrixRelation([vs[i], vs[j]], table, f"c{k}"))
    dcop.add_agents([AgentDef("a0")])
    return dcop


def _mixed_arity(n: int, seed: int) -> DCOP:
    """Unary + binary + ternary factors — exercises multi-bucket
    envelope padding."""
    rng = np.random.default_rng(seed)
    dom = Domain("c", "", [0, 1, 2])
    dcop = DCOP(f"mix{n}_{seed}", objective="min")
    vs = [Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for k in range(n):
        i, j = k, (k + 1) % n
        table = rng.integers(0, 10, size=(3, 3)).astype(float)
        dcop.add_constraint(
            NAryMatrixRelation([vs[i], vs[j]], table, f"b{k}"))
    for k in range(0, n, 3):
        dcop.add_constraint(constraint_from_str(
            f"u{k}", f"v{k} * {1 + k % 3}", [vs[k]]))
    for k in range(0, n - 2, 4):
        dcop.add_constraint(constraint_from_str(
            f"t{k}", f"v{k} + v{k + 1} * v{k + 2}",
            [vs[k], vs[k + 1], vs[k + 2]]))
    dcop.add_agents([AgentDef("a0")])
    return dcop


def _graph(dcop):
    return compile_dcop(dcop, noise_level=0.01)[0]


def _solo_values(graph, max_cycles=MAX_CYCLES):
    values, _cycles, _res = engine_batch.run_stacked(
        [graph], max_cycles=max_cycles, device="cpu")
    return values[0]


def _covering_envelope(graphs, ladder=binning.DEFAULT_LADDER):
    envs = [binning.envelope_key(g, ladder) for g in graphs]
    arities = sorted({a for e in envs for a, _ in e.rows})
    rows = tuple(
        (a, max(dict(e.rows).get(a, ladder.rows[0]) for e in envs))
        for a in arities
    )
    return binning.Envelope(
        v_env=max(e.v_env for e in envs),
        d_env=max(e.d_env for e in envs),
        rows=rows,
    )


# ------------------------------------------------------------------ #
# envelope keys and the ladder


class TestEnvelopeKey:
    def test_envelope_covers_graph(self):
        for dcop in (_ring(9, 3, 0), _ring(23, 5, 1, chords=4),
                     _mixed_arity(12, 2)):
            g = _graph(dcop)
            env = binning.envelope_key(g)
            assert env.v_env >= g.n_vars
            assert env.d_env >= g.dmax
            rows = dict(env.rows)
            assert set(rows) == {b.arity for b in g.buckets}
            for b in g.buckets:
                assert rows[b.arity] >= b.n_factors

    def test_ladder_monotone(self):
        """A graph that grows in any dimension never gets a SMALLER
        envelope — the property that makes the key a proper tier."""
        sizes = [6, 9, 14, 22, 35, 70, 140]
        envs = [binning.envelope_key(_graph(_ring(n, 3, 0)))
                for n in sizes]
        for small, big in zip(envs, envs[1:]):
            assert big.v_env >= small.v_env
            assert big.d_env >= small.d_env
            assert dict(big.rows)[2] >= dict(small.rows)[2]

    def test_nearby_sizes_share_an_envelope(self):
        """The point of the tier: different structures with nearby
        shapes land on the SAME envelope (they'd never share a bin)."""
        g1, g2 = _graph(_ring(12, 3, 0)), _graph(_ring(15, 3, 1))
        assert binning.structure_signature(g1) != \
            binning.structure_signature(g2)
        assert binning.envelope_key(g1) == binning.envelope_key(g2)

    def test_ladder_round_past_top_rung(self):
        assert binning.ladder_round(5000, (8, 16)) == 8192

    def test_cells_accounting(self):
        g = _graph(_ring(10, 3, 0))
        # var table (11 rows incl. sentinel) * 3 + 10 binary factors
        # * 9.
        assert binning.graph_cells(g) == 11 * 3 + 10 * 9
        env = binning.Envelope(16, 4, ((2, 16),))
        assert binning.envelope_cells(env) == 17 * 4 + 16 * 16
        assert binning.lane_cells(g, 4) == 11 * 4 + 10 * 16


# ------------------------------------------------------------------ #
# mask-padding bit-identity


class TestEnvelopePadding:
    def test_padded_stack_bit_identical_across_topologies(self):
        """The envelope claim: different-structure graphs padded to
        one envelope and dispatched together produce BIT-IDENTICAL
        per-instance values to their solo dispatches."""
        dcops = [_ring(12, 3, 0), _ring(9, 3, 1),
                 _ring(17, 4, 2, chords=3), _ring(25, 3, 3)]
        graphs = [_graph(d) for d in dcops]
        env = _covering_envelope(graphs)
        values, cycles, res = engine_batch.run_stacked(
            graphs, max_cycles=MAX_CYCLES, envelope=env, device="cpu")
        for i, g in enumerate(graphs):
            solo = _solo_values(g)
            assert np.array_equal(values[i][:g.n_vars],
                                  solo[:g.n_vars]), f"lane {i}"
        assert res.metrics["packing"] == "envelope"

    def test_padded_stack_bit_identical_mixed_arities(self):
        graphs = [_graph(_mixed_arity(9, 0)),
                  _graph(_mixed_arity(13, 1))]
        env = _covering_envelope(graphs)
        values, _cycles, _res = engine_batch.run_stacked(
            graphs, max_cycles=MAX_CYCLES, envelope=env, device="cpu")
        for i, g in enumerate(graphs):
            solo = _solo_values(g)
            assert np.array_equal(values[i][:g.n_vars],
                                  solo[:g.n_vars])

    def test_padded_stack_bit_identical_mixed_domains(self):
        """Domain padding regression: a d=2 instance padded into a
        d=5 envelope must keep its exact solo answer (BIG-masked
        slots must never win a reduction or shift the
        normalization)."""
        graphs = [_graph(_ring(10, 2, 0)), _graph(_ring(14, 5, 1))]
        env = _covering_envelope(graphs)
        assert env.d_env >= 5
        values, _cycles, _res = engine_batch.run_stacked(
            graphs, max_cycles=MAX_CYCLES, envelope=env, device="cpu")
        for i, g in enumerate(graphs):
            assert np.array_equal(values[i][:g.n_vars],
                                  _solo_values(g)[:g.n_vars])

    def test_exact_fit_returns_same_graph(self):
        g = _graph(_ring(10, 3, 0))
        env = binning.Envelope(
            v_env=g.n_vars, d_env=g.dmax,
            rows=tuple((b.arity, b.n_factors) for b in g.buckets))
        assert engine_batch.pad_graph_to_envelope(g, env) is g

    def test_exact_fit_drops_aggregation_arrays(self):
        """Even an exact-fit member must honor the drop-agg contract:
        stacked next to padded members (agg fields None) the pytrees
        must match, and agg shapes like ell's [V+1, K] are not
        envelope-determined."""
        from pydcop_tpu_torch.engine.autotune import apply_aggregation

        g = apply_aggregation(_graph(_ring(10, 3, 0)), "ell")
        assert g.agg_ell is not None
        env = binning.Envelope(
            v_env=g.n_vars, d_env=g.dmax,
            rows=tuple((b.arity, b.n_factors) for b in g.buckets))
        padded = engine_batch.pad_graph_to_envelope(g, env)
        assert padded is not g
        assert padded.agg_ell is None and padded.agg_perm is None
        assert padded.var_costs is g.var_costs

    def test_envelope_must_cover(self):
        g = _graph(_ring(10, 3, 0))
        with pytest.raises(ValueError, match="does not cover"):
            engine_batch.pad_graph_to_envelope(
                g, binning.Envelope(4, 3, ((2, 16),)))
        with pytest.raises(ValueError, match="arities"):
            engine_batch.pad_graph_to_envelope(
                g, binning.Envelope(16, 3, ((3, 16),)))
        with pytest.raises(ValueError, match="rows"):
            engine_batch.pad_graph_to_envelope(
                g, binning.Envelope(16, 3, ((2, 4),)))

    def test_sentinel_remap(self):
        """A graph compiled with pad_to>1 has bucket rows pointing at
        ITS sentinel; envelope padding must re-point them at the
        envelope's sentinel, not leave them aimed at a now-real row."""
        g = compile_dcop(_ring(10, 3, 0), noise_level=0.01,
                         pad_to=8)[0]
        assert (np.asarray(g.buckets[0].var_ids) == g.n_vars).any()
        env = binning.Envelope(16, 4, ((2, 32),))
        padded = engine_batch.pad_graph_to_envelope(g, env)
        ids = np.asarray(padded.buckets[0].var_ids)
        assert not (ids == g.n_vars).any()
        assert (ids == 16).any()
        assert np.array_equal(
            engine_batch.run_stacked([padded], max_cycles=MAX_CYCLES,
                                     device="cpu")[0][0][:g.n_vars],
            _solo_values(g)[:g.n_vars])

    def test_pad_accounting_honest(self):
        """``envelope_waste`` honesty: per-lane waste must equal
        1 - real_cells/envelope_cells exactly, and the dispatch-level
        figure must be their mean."""
        graphs = [_graph(_ring(12, 3, 0)), _graph(_ring(20, 3, 1))]
        env = _covering_envelope(graphs)
        _values, _cycles, res = engine_batch.run_stacked(
            graphs, max_cycles=MAX_CYCLES, envelope=env, device="cpu")
        lanes = res.metrics["envelope_waste_lanes"]
        env_cells = binning.envelope_cells(env)
        for g, waste in zip(graphs, lanes):
            expected = 1.0 - binning.graph_cells(g) / env_cells
            assert waste == pytest.approx(expected, abs=1e-4)
        assert res.metrics["envelope_waste"] == pytest.approx(
            sum(lanes) / len(lanes), abs=1e-4)


# ------------------------------------------------------------------ #
# lane-packed disjoint unions


class TestLanePacking:
    def test_lane_pack_bit_identical(self):
        dcops = [_ring(12, 3, 0), _ring(9, 3, 1), _ring(21, 3, 2),
                 _ring(15, 4, 3, chords=2)]
        graphs = [_graph(d) for d in dcops]
        values, cycles, res = engine_batch.run_lane_packed(
            graphs, max_cycles=MAX_CYCLES,
            ladder=binning.UNION_LADDER, device="cpu")
        for i, g in enumerate(graphs):
            assert np.array_equal(values[i],
                                  _solo_values(g)[:g.n_vars]), i
        assert res.metrics["packing"] == "lane"
        assert (cycles == MAX_CYCLES).all()

    def test_lane_pack_heterogeneous_arity_sets(self):
        """The union accepts members with entirely different arity
        sets — a binary-only ring next to a unary+binary+ternary
        graph."""
        graphs = [_graph(_ring(10, 3, 0)), _graph(_mixed_arity(9, 1))]
        values, _cycles, _res = engine_batch.run_lane_packed(
            graphs, max_cycles=MAX_CYCLES, device="cpu")
        for i, g in enumerate(graphs):
            assert np.array_equal(values[i],
                                  _solo_values(g)[:g.n_vars])

    def test_lane_converged_flags_match_solo(self):
        """Honest per-member convergence: the flags recovered from
        the union's suppression counters must equal each member's
        solo verdict — including a mixed converged/not-converged
        batch."""
        fast = _graph(_ring(6, 3, 0))         # converges quickly
        slow = _graph(_ring(30, 3, 1, chords=10))
        for budget in (4, MAX_CYCLES):
            solos = [
                engine_batch.run_stacked(
                    [g], max_cycles=budget, device="cpu")[2]
                .metrics["converged_lanes"][0]
                for g in (fast, slow)
            ]
            _v, _c, res = engine_batch.run_lane_packed(
                [fast, slow], max_cycles=budget, device="cpu")
            assert res.metrics["converged_lanes"] == solos, budget

    def test_pack_graphs_layout(self):
        graphs = [_graph(_ring(8, 3, 0)), _graph(_ring(11, 3, 1))]
        union, layout = lane_ops.pack_graphs(graphs)
        assert union.n_vars == 19
        assert layout.var_slices == ((0, 8), (8, 11))
        ids = np.asarray(union.buckets[0].var_ids)
        # Second member's rows reference offset indices only.
        for bi, start, n_rows in layout.row_slices[1]:
            block = ids[start:start + n_rows]
            real = block[block != union.n_vars]
            assert (real >= 8).all()


# ------------------------------------------------------------------ #
# the pack-vs-solo cost model


class TestPackDecision:
    def test_big_group_packs_small_pair_of_tiny_does_not(self):
        cells = 150  # tiny ring
        prior = binning.modeled_solve_ms(cells, MAX_CYCLES)
        pair = binning.pack_decision(
            [cells] * 2, [prior] * 2,
            packed_cells_total=binning.envelope_cells(
                binning.Envelope(256, 8, ((2, 256),))),
            max_cycles=MAX_CYCLES)
        assert not pair["packed"]  # giant envelope for two tiny rings
        group = binning.pack_decision(
            [cells] * 8, [prior] * 8,
            packed_cells_total=8 * cells + 200,
            max_cycles=MAX_CYCLES)
        assert group["packed"]

    def test_singleton_never_packs(self):
        d = binning.pack_decision(
            [100], [1.0], packed_cells_total=100,
            max_cycles=MAX_CYCLES)
        assert not d["packed"]

    def test_waste_reported(self):
        d = binning.pack_decision(
            [100, 100], [1.0, 1.0], packed_cells_total=400,
            max_cycles=MAX_CYCLES)
        assert d["waste"] == pytest.approx(0.5)

    def test_lane_union_cells_matches_run(self):
        """The decision model's union-cell prediction must equal what
        run_lane_packed actually builds (same ladder rounding)."""
        graphs = [_graph(_ring(12, 3, 0)), _graph(_ring(19, 3, 1))]
        predicted = binning.lane_union_cells(
            graphs, 3, binning.UNION_LADDER)
        union, _ = lane_ops.pack_graphs(graphs, d_env=3)
        padded = engine_batch.pad_graph_to_envelope(
            union,
            binning.envelope_key(
                union, binning.UNION_LADDER)._replace(
                    d_env=union.dmax))
        actual = padded.var_costs.size + sum(
            b.costs.size for b in padded.buckets)
        assert predicted == actual

    def test_portfolio_prior_replayed(self, tmp_path, monkeypatch):
        """Scheduler decision replay from the portfolio cache: a
        persisted portfolio race time for a structure becomes that
        structure's solo prior (source 'portfolio'), scaled to the
        request's cycle budget — zero measurement on the serving
        path."""
        from pydcop_tpu_torch.engine.autotune import (
            PORTFOLIO_RACE_CYCLES,
            cached_portfolio_timing_ms,
            graph_shape_key,
            portfolio_key,
        )

        g = _graph(_ring(12, 3, 0))
        key = portfolio_key(graph_shape_key(g, "cpu"))
        cache = tmp_path / "autotune.json"
        # The port replays only entries it wrote (engine/autotune.py's
        # writer mark).
        cache.write_text(json.dumps({key: {
            "writer": "pydcop_tpu_torch",
            "algo": "maxsum_prune",
            "portfolio_timings_ms": {"maxsum": 9.0,
                                     "maxsum_prune": 6.0},
            "backend": "cpu",
        }}))
        monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE", str(cache))
        assert cached_portfolio_timing_ms(key) == 6.0
        ms, source = binning.solve_prior_ms(
            binning.graph_cells(g), MAX_CYCLES,
            cached_portfolio_timing_ms(key),
            race_cycles=PORTFOLIO_RACE_CYCLES)
        assert source == "portfolio"
        assert ms == pytest.approx(
            6.0 * MAX_CYCLES / PORTFOLIO_RACE_CYCLES)
        # End-to-end: the service's decision record says so too.
        svc = SolveService(batch_window_s=0.2, envelope_packing=True,
                           device="cpu")
        svc.start()
        try:
            ids = [svc.submit(_ring(12, 3, 7), params=PARAMS),
                   svc.submit(_ring(15, 3, 8), params=PARAMS)]
            for rid in ids:
                assert svc.result(rid, wait=60)["status"] == \
                    "FINISHED"
            decisions = list(svc.envelope_decisions)
        finally:
            svc.stop(drain=False)
        assert decisions, "no pack decision recorded"
        assert "portfolio" in decisions[-1]["prior_sources"]

    def test_invalid_portfolio_cache_ignored(self, tmp_path,
                                             monkeypatch):
        from pydcop_tpu_torch.engine.autotune import (
            cached_portfolio_timing_ms,
        )

        cache = tmp_path / "autotune.json"
        cache.write_text(json.dumps({"k": {"algo": "bogus"}}))
        monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE", str(cache))
        assert cached_portfolio_timing_ms("k") is None


# ------------------------------------------------------------------ #
# flush planning + service end-to-end


class TestFlushPlanning:
    def _reqs(self, svc, dcops):
        """Submit without a running scheduler: start() then stop the
        scheduler thread is heavyweight here, so build the request
        objects through the service's own compile path."""
        svc.start()
        reqs = []
        try:
            for d in dcops:
                rid = svc.submit(d, params=PARAMS)
                with svc._lock:
                    reqs.append(svc._requests[rid])
        finally:
            svc.stop(drain=False)
        return reqs

    def test_multi_bins_stay_exact(self):
        svc = SolveService(envelope_packing=True, device="cpu")
        reqs = self._reqs(svc, [_ring(10, 3, s) for s in range(3)])
        bins = {reqs[0].bin: reqs}
        plans = svc.plan_flush(bins)
        assert len(plans) == 1
        assert plans[0].envelope is None and plans[0].lane_d is None

    def test_singletons_group_and_pack(self):
        svc = SolveService(envelope_packing=True, device="cpu")
        dcops = [_ring(n, 3, n) for n in (9, 12, 15, 18, 21, 24)]
        reqs = self._reqs(svc, dcops)
        bins = {r.bin: [r] for r in reqs}
        plans = svc.plan_flush(bins)
        packed = [p for p in plans if p.lane_d or p.envelope]
        assert len(packed) == 1
        assert len(packed[0].reqs) == len(dcops)
        assert packed[0].lane_d == 3  # tiny domain routes lane
        assert list(svc.envelope_decisions)[-1]["packed"]

    def test_groups_chunk_at_max_batch(self):
        """The cost model must price the dispatches that actually
        execute: a group past max_batch splits into chunks BEFORE the
        decision, one verdict per chunk, and no plan ever exceeds the
        dispatch cap."""
        svc = SolveService(envelope_packing=True, max_batch=4, device="cpu")
        dcops = [_ring(8 + 2 * i, 3, i) for i in range(6)]
        reqs = self._reqs(svc, dcops)
        # The live scheduler recorded decisions while _reqs drained;
        # count only this explicit flush's.
        svc.envelope_decisions.clear()
        plans = svc.plan_flush({r.bin: [r] for r in reqs})
        assert all(len(p.reqs) <= 4 for p in plans)
        assert sum(len(p.reqs) for p in plans) == 6
        # Two multi-request chunks (4 + 2) -> two recorded decisions.
        assert len(list(svc.envelope_decisions)) == 2

    def test_prune_routes_off_the_lane_path(self):
        """prune is an edge-major-only kernel: pruned singletons must
        take the stacked-envelope route, never the lane union."""
        svc = SolveService(envelope_packing=True, device="cpu")
        dcops = [_ring(n, 3, n) for n in (9, 12, 15, 18)]
        svc.start()
        reqs = []
        try:
            for d in dcops:
                rid = svc.submit(d, params={"max_cycles": MAX_CYCLES,
                                            "prune": 1})
                with svc._lock:
                    reqs.append(svc._requests[rid])
        finally:
            svc.stop(drain=False)
        plans = svc.plan_flush({r.bin: [r] for r in reqs})
        assert all(p.lane_d is None for p in plans)

    def test_envelope_packing_off_dispatches_solo(self):
        svc = SolveService(envelope_packing=False, device="cpu")
        reqs = self._reqs(svc, [_ring(n, 3, n) for n in (9, 12, 15)])
        plans = svc.plan_flush({r.bin: [r] for r in reqs})
        assert len(plans) == 3
        assert all(p.envelope is None and p.lane_d is None
                   for p in plans)
        assert not svc.envelope_decisions

    def test_losing_group_falls_back_to_solo(self):
        """A group the cost model prices out must dispatch solo —
        packing is an optimization, never a forced path."""
        svc = SolveService(envelope_packing=True,
                           envelope_overhead_ms=0.0, device="cpu")
        reqs = self._reqs(svc, [_ring(n, 3, n) for n in (6, 7)])
        plans = svc.plan_flush({r.bin: [r] for r in reqs})
        assert len(plans) == 2
        decision = list(svc.envelope_decisions)[-1]
        assert not decision["packed"]

    def test_end_to_end_mixed_structures(self):
        """Through the real scheduler: distinct structures complete
        in fewer dispatches than requests, every answer equals the
        solo api.solve answer, and the per-request batch accounting
        says how it was packed."""
        from pydcop_tpu_torch import api

        dcops = [_ring(n, 3, 100 + n) for n in (9, 11, 14, 17, 20)]
        svc = SolveService(batch_window_s=0.25, device="cpu").start()
        try:
            ids = [svc.submit(d, params=PARAMS) for d in dcops]
            results = [svc.result(i, wait=60) for i in ids]
            stats = svc.stats()
        finally:
            svc.stop(drain=False)
        assert all(r["status"] == "FINISHED" for r in results)
        assert stats["dispatches"] < len(dcops)
        assert stats["envelope_dispatches"] >= 1
        assert stats["envelope_packed_requests"] >= 2
        for dcop, res in zip(dcops, results):
            solo = api.solve(dcop, "maxsum", max_cycles=MAX_CYCLES,
                             device="cpu")
            assert res["assignment"] == solo["assignment"]
            assert res["cost"] == solo["cost"]
            assert res["batch"]["packing"] in ("envelope", "lane",
                                               "structure")


# ------------------------------------------------------------------ #
# satellites: normalize_params prune fall-through + sentinel family


class TestParamValidation:
    def test_prune_minus_one_rejected(self):
        """Regression: an out-of-range int must 400 (ValueError), not
        fall through into the bin key."""
        with pytest.raises(ValueError, match="prune"):
            binning.normalize_params({"prune": -1})

    def test_prune_unparseable_rejected(self):
        with pytest.raises(ValueError, match="prune"):
            binning.normalize_params({"prune": "sometimes"})
        with pytest.raises(ValueError, match="prune"):
            binning.normalize_params({"prune": 7})

    def test_prune_valid_values_pass(self):
        assert binning.normalize_params({"prune": 1})["prune"] == 1
        assert binning.normalize_params(
            {"prune": "auto"})["prune"] == "auto"
