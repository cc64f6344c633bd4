"""The port's solve service (``pydcop_tpu_torch/serving``) against the
JAX package's, on the CPU: the same seeded request streams through the
reference's ``SolveService`` (JAX on the CPU) and the port's
``SolveService(device="cpu")``.

Tolerance: none.  Every result's status, assignment, cost, cycles,
violations and convergence flag are equal, and so is its dispatch
record (batch size, real members, padding, packing), for
same-structure bins padded up the bin ladder from 1 to 16 members,
envelope-padded and lane-packed flushes of ``bench.py``'s 24 mixed
structures at 60 cycles, a zipf-drawn mixed stream, ``algo: "dpop"``
requests (and the over-width problem's ``rejected_width`` verdict),
and the HTTP front end's response bodies apart from ids and timings.

Two pinned points of the port: a pruned stack (``prune: 1`` or
``"auto"``) runs synchronously — the port's ``launch_stacked`` returns
``None`` for it, where the reference queues a warm pruned stack — with
the same answers; and ``aggregation`` is no serving parameter in
either package, so ``engine/batch.py``'s ``ell``/``boundary`` stacking
cannot be reached from a request.
"""

import numpy as np
import pytest
import torch

import torch_serving_common as common

MIXED_CYCLES = 60
PARAMS = {"max_cycles": 40}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _cold_dispatch_caches(tmp_path, monkeypatch):
    """Both packages' dispatch caches empty, a private portfolio cache
    (the pack decision reads its priors there), and the pack model on
    its compiled-in constants: the online fit (``PYDCOP_PACK_FIT``)
    learns from each package's own measured dispatch times, kept in
    the process across tests, so with it the two planners may decide
    differently."""
    import pydcop_tpu.engine.batch as reference_batch
    import pydcop_tpu_torch.engine.batch as port_batch

    reference_batch._warm.clear()
    port_batch._warm.clear()
    monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.setenv("PYDCOP_PACK_FIT", "0")


def _both(yamls, **kw):
    out = {pkg: common.serve_stream(pkg, yamls, **kw)
           for pkg in common.PACKAGES}
    return out["jax"], out["torch"]


def _assert_results_equal(ref, port):
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a is not None and b is not None, i
        assert common.key_fields(a) == common.key_fields(b), (
            i, common.key_fields(a), common.key_fields(b))
        assert a.get("batch") == b.get("batch"), (i, a.get("batch"),
                                                  b.get("batch"))


def test_same_structure_bins_padded_1_to_16_equal_reference():
    """Seven structures, binned 1, 2, 3, 5, 8, 13 and 16 deep: each
    bin one stacked dispatch padded up the ladder (1, 2, 4, 8, 8, 16,
    16 lanes)."""
    sizes = (1, 2, 3, 5, 8, 13, 16)
    yamls = [common.ring_yaml(9 + k, 100 * k + s, chords=k % 3)
             for k in sizes for s in range(k)]
    (ref, ref_stats), (port, port_stats) = _both(yamls, params=PARAMS)
    _assert_results_equal(ref, port)
    assert all(r["status"] == "FINISHED" for r in port)
    assert {r["batch"]["size"] for r in port} == {1, 2, 4, 8, 16}
    for key in ("dispatches", "batched_dispatches", "batched_requests"):
        assert ref_stats[key] == port_stats[key], key
    assert port_stats["batched_dispatches"] == len(sizes) - 1


@pytest.mark.parametrize("lane_pack", [False, True])
def test_mixed_flush_equal_reference(lane_pack):
    """bench.py's 24 mixed structures in one flush: with the pack
    model forced on, envelope-padded stacks (``lane_pack`` off: one
    group per shape envelope, a lone member of its envelope solo) or
    lane-packed unions (on: one domain rung, 16 + 8 members)."""
    yamls = [common.mixed_yaml(s, 100 + s) for s in range(24)]
    (ref, ref_stats), (port, port_stats) = _both(
        yamls, params={"max_cycles": MIXED_CYCLES},
        envelope_overhead_ms=1e6, lane_pack=lane_pack)
    _assert_results_equal(ref, port)
    kind = "lane" if lane_pack else "envelope"
    kinds = [r["batch"]["packing"] for r in port]
    assert kinds.count(kind) >= 16, kinds
    for key in ("dispatches", "envelope_dispatches", "lane_dispatches",
                "envelope_packed_requests"):
        assert port_stats[key] == ref_stats[key], key


def test_zipf_mixed_stream_equal_reference():
    """The bench's serving mix: 40 requests drawn zipf(1.05) over the
    24 structures (seeded), so the head repeats into exact bins and the
    tail packs; the pack model decides as it would in service."""
    rng = np.random.default_rng(965)
    ranks = np.arange(1, 25, dtype=float)
    probs = ranks ** -1.05
    probs /= probs.sum()
    draws = rng.choice(24, size=40, p=probs)
    yamls = [common.mixed_yaml(int(s), int(rng.integers(4)))
             for s in draws]
    (ref, ref_stats), (port, port_stats) = _both(
        yamls, params={"max_cycles": MIXED_CYCLES})
    _assert_results_equal(ref, port)
    for key in ("dispatches", "batched_dispatches",
                "envelope_dispatches", "lane_dispatches"):
        assert ref_stats[key] == port_stats[key], key


def test_dpop_requests_equal_reference():
    """``algo: "dpop"`` bins: each request one exact solve, optimal,
    equal to the reference's; the over-width clique is refused at
    submit with the same ``rejected_width`` figures."""
    yamls = [common.ring_yaml(8, s, chords=2) for s in range(3)]
    yamls += [common.ring_yaml(11, 7, chords=4, d=4)]
    (ref, _), (port, port_stats) = _both(
        yamls, params={"algo": "dpop"})
    _assert_results_equal(ref, port)
    assert all(r.get("optimal") for r in port)
    assert port_stats["dpop_dispatches"] >= 1
    verdicts = {}
    for pkg in common.PACKAGES:
        svc = common.make_service(pkg, batch_window_s=0.01).start()
        try:
            with pytest.raises(ValueError) as err:
                svc.submit(common.load(pkg, _wide_clique_yaml()),
                           params={"algo": "dpop"})
            verdicts[pkg] = (type(err.value).__name__, err.value.status,
                             err.value.max_elements, err.value.cap,
                             str(err.value))
        finally:
            svc.stop(drain=False)
    assert verdicts["jax"] == verdicts["torch"]
    assert verdicts["torch"][1] == "rejected_width"


def _wide_clique_yaml(n=12, d=10):
    """The exact-inference battery's over-width clique."""
    import itertools

    lines = ["name: wide", "objective: min", "domains:",
             "  d: {values: [" + ", ".join(map(str, range(d))) + "]}",
             "variables:"]
    for i in range(n):
        lines.append(f"  x{i}: {{domain: d}}")
    lines.append("constraints:")
    for i, j in itertools.combinations(range(n), 2):
        lines.append(f"  c{i}_{j}: {{type: intention, function: "
                     f"\"1 if x{i} == x{j} else 0\"}}")
    lines.append("agents: [a0]")
    return "\n".join(lines)


def _front_end(pkg, svc):
    if pkg == "jax":
        from pydcop_tpu.serving.http import ServeFrontEnd
    else:
        from pydcop_tpu_torch.serving.http import ServeFrontEnd
    return ServeFrontEnd(svc, port=0).start()


def test_http_bodies_equal_reference():
    """The same wire exchange against both front ends: every status
    code and every body equal apart from ids and timings."""
    exchanges = {}
    for pkg in common.PACKAGES:
        svc = common.make_service(pkg, batch_window_s=0.05,
                                  speculate=False).start()
        fe = _front_end(pkg, svc)
        url = fe.url
        log = []
        try:
            for body in (
                    {"dcop": common.ring_yaml(10, 1), "wait": True,
                     "params": PARAMS},
                    {"dcop": common.ring_yaml(10, 2), "wait": True,
                     "params": {"max_cycles": 30, "damping": 0.7}},
                    {"dcop": common.ring_yaml(8, 3), "wait": True,
                     "params": {"algo": "dpop"}},
                    {"dcop": _wide_clique_yaml(), "wait": True,
                     "params": {"algo": "dpop"}},
                    {"dcop": common.ring_yaml(8, 4),
                     "params": {"bogus": 1}},
                    {"dcop": common.ring_yaml(8, 4), "timeout": "soon"},
                    {"nodcop": 1}):
                log.append(common.http(url + "/solve", "POST", body))
            code, ack = common.http(url + "/solve", "POST", {
                "dcop": common.ring_yaml(10, 5), "params": PARAMS})
            log.append((code, ack))
            done = svc.result(ack["id"], wait=120)
            assert done is not None
            log.append(common.http(url + "/result/" + ack["id"]))
            log.append(common.http(url + "/result/nope"))
            log.append(common.http(url + "/session/nope"))
        finally:
            fe.stop()
            svc.stop(drain=False)
        exchanges[pkg] = [(code, common.stable_body(body))
                          for code, body in log]
    for i, (a, b) in enumerate(zip(exchanges["jax"],
                                   exchanges["torch"])):
        assert a == b, (i, a, b)
    codes = [c for c, _ in exchanges["torch"]]
    assert codes == [200, 200, 200, 400, 400, 400, 400, 202, 200, 404,
                     404]


@pytest.mark.parametrize("prune", [1, "auto"])
def test_pruned_stacks_run_synchronously_with_equal_answers(prune):
    """The pinned divergence: a warm pruned stack is queued on the
    reference's pipelined path but runs synchronously in the port
    (``launch_stacked(prune=True)`` is ``None``: the pruned phase
    predicate is read on the host every cycle).  The answers are the
    reference's, and equal to the unpruned solve's.  With ``"auto"``
    and the portfolio cache holding a pruned decision for the
    structure (each package replays only what it wrote), both resolve
    to the pruned solve."""
    yamls = [common.ring_yaml(12, s, chords=3, d=6) for s in range(4)]
    params = {"max_cycles": 40, "prune": prune}
    if prune == "auto":
        _store_pruned_decision(yamls[0])
    out = {}
    for pkg in common.PACKAGES:
        # The bin fills max_batch as its fourth request arrives: one
        # flush a round, however fast the host submits.
        svc = common.make_service(pkg, batch_window_s=3600.0,
                                  max_batch=len(yamls),
                                  speculate=False).start()
        try:
            rounds = []
            dcops = [common.load(pkg, y) for y in yamls]
            for _ in range(2):     # cold, then warm
                ids = [svc.submit(d, params=params) for d in dcops]
                rounds.append([svc.result(i, wait=300) for i in ids])
            out[pkg] = (rounds, svc.stats())
        finally:
            svc.stop(drain=False)
    (ref_rounds, ref_stats), (port_rounds, port_stats) = (
        out["jax"], out["torch"])
    for a, b in zip(ref_rounds, port_rounds):
        _assert_results_equal(a, b)
    assert ref_stats["pipeline"]["pipelined_dispatches"] >= 1
    assert port_stats["pipeline"]["pipelined_dispatches"] == 0
    if prune == "auto":
        assert port_stats["portfolio_resolved"] == 8
    dense, _ = common.serve_stream("torch", yamls,
                                   params={"max_cycles": 40})
    assert [common.key_fields(r) for r in dense] == \
        [common.key_fields(r) for r in port_rounds[1]]


def _store_pruned_decision(yaml_src):
    """Write a ``maxsum_prune`` portfolio decision for this structure
    into the (private) cache, one entry per package."""
    import json
    import os

    from pydcop_tpu.engine import autotune as reference_autotune
    from pydcop_tpu.engine.compile import compile_dcop as reference_compile
    from pydcop_tpu_torch.engine import autotune as port_autotune
    from pydcop_tpu_torch.engine.compile import compile_dcop

    path = os.environ["PYDCOP_AGG_AUTOTUNE_CACHE"]
    entry = {"algo": "maxsum_prune",
             "portfolio_timings_ms": {"maxsum": 9.0, "maxsum_prune": 6.0}}
    ref_graph, _ = reference_compile(common.load("jax", yaml_src),
                                     noise_level=0.01)
    port_graph, _ = compile_dcop(common.load("torch", yaml_src),
                                 noise_level=0.01)
    doc = {
        reference_autotune.portfolio_key(reference_autotune.graph_shape_key(
            ref_graph, "cpu")): dict(entry, backend="cpu"),
        port_autotune.portfolio_key(port_autotune.graph_shape_key(
            port_graph, "cpu")): dict(entry, backend="cpu",
                                      writer="pydcop_tpu_torch"),
    }
    with open(path, "w") as f:
        json.dump(doc, f)


@pytest.mark.parametrize("agg", ["ell", "boundary", "sorted"])
def test_aggregation_is_no_serving_parameter(agg):
    """``binning.DEFAULT_PARAMS`` has no ``aggregation`` key and
    ``normalize_params`` refuses unknown keys, in both packages: a
    request cannot reach ``engine/batch.py``'s ``ell``/``boundary``
    stacking, and the submit is a 400-class ``ValueError``."""
    import pydcop_tpu.serving.binning as reference_binning
    import pydcop_tpu_torch.serving.binning as port_binning

    for binning in (reference_binning, port_binning):
        assert "aggregation" not in binning.DEFAULT_PARAMS
        with pytest.raises(ValueError, match="unknown solver"):
            binning.normalize_params({"aggregation": agg})
    svc = common.make_service("torch", batch_window_s=0.01).start()
    try:
        with pytest.raises(ValueError, match="unknown solver"):
            svc.submit(common.load("torch", common.ring_yaml(8, 0)),
                       params={"aggregation": agg})
    finally:
        svc.stop(drain=False)


def test_service_without_card_raises():
    """The device rule: ``SolveService()`` defaults to ``"cuda"`` and
    raises where no card is present; so does ``api.serve()``."""
    from pydcop_tpu_torch import api
    from pydcop_tpu_torch.serving.service import SolveService

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolveService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.serve(port=0)
