"""On the card: the serving plane (``pydcop_tpu_torch/serving``).

This file imports neither JAX nor the JAX package.  Every test is
marked ``gpu`` and decides inside itself whether a card is present;
without one it skips.  Where JAX is missing run:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu_serve.py

- A served flush on the card — a same-structure bin, the 24 mixed
  structures lane-packed and envelope-padded, a pruned bin, ``dpop`` —
  gives the CPU service's answers (assignment, cost, cycles, flags),
  cold and warm; the warm pass goes through the pipelined
  launch/collect path on the card's side stream.
- A session on the card streams the CPU session's segments and closes
  with its final result, after the same event batches.
- A journal left by a stop without drain on the card is replayed by a
  card service to the CPU's answers.
- ``api.serve()`` with no ``device`` serves on the card.
"""

import pytest
import torch

import torch_serving_common as common
from pydcop_tpu_torch.ops import _build

PARAMS = {"max_cycles": 60}


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
    """The port's dispatch cache empty, a private portfolio cache."""
    import pydcop_tpu_torch.engine.batch as port_batch

    port_batch._warm.clear()
    monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _service(device, **kw):
    from pydcop_tpu_torch.serving.service import SolveService

    kw.setdefault("batch_window_s", 2.0)
    kw.setdefault("max_batch", 16)
    kw.setdefault("speculate", False)
    return SolveService(device=device, **kw)


def _load(yaml_src):
    return common.load("torch", yaml_src)


def _stream(device, yamls, rounds=2, params=PARAMS, **kw):
    """Submit the stream ``rounds`` times (cold, then warm) to one
    service; every round's results and the stats."""
    dcops = [_load(y) for y in yamls]
    svc = _service(device, **kw).start()
    try:
        out = []
        for _ in range(rounds):
            ids = [svc.submit(d, params=params) for d in dcops]
            out.append([svc.result(i, wait=600) for i in ids])
        return out, svc.stats()
    finally:
        svc.stop(drain=False)


def _assert_equal(card_rounds, cpu_rounds):
    """The answers (not the flush records: how a round splits into
    flushes follows the host's submit speed)."""
    for card, cpu in zip(card_rounds, cpu_rounds):
        for a, b in zip(card, cpu):
            assert a["status"] == "FINISHED", a
            assert common.key_fields(a) == common.key_fields(b)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bin", "lane", "envelope"])
def test_served_flush_card_equals_cpu(kind):
    _need_card()
    if kind == "bin":
        yamls = [common.small_yaml(500, s) for s in range(8)]
        kw = {}
    else:
        yamls = [common.mixed_yaml(s, 100 + s) for s in range(24)]
        kw = {"envelope_overhead_ms": 1e6,
              "lane_pack": kind == "lane"}
    _build.launch_counts.clear()
    card, card_stats = _stream("cuda", yamls, **kw)
    launches = dict(_build.launch_counts)
    cpu, _ = _stream("cpu", yamls, **kw)
    _assert_equal(card, cpu)
    assert card_stats["pipeline"]["pipelined_dispatches"] >= 1
    assert launches.get("binary_factor_update" if kind != "lane"
                        else "binary_factor_update:lane", 0) > 0
    if kind == "lane":
        assert card_stats["lane_dispatches"] >= 1
        assert launches.get("lane_sum", 0) > 0
    elif kind == "envelope":
        assert card_stats["envelope_dispatches"] >= 1
        assert launches.get("segment_sum", 0) > 0


@pytest.mark.gpu
def test_pruned_and_dpop_requests_card_equal_cpu():
    """A pruned bin (synchronous on the card: ``launch_stacked``
    returns None for it) and exact ``dpop`` requests."""
    _need_card()
    yamls = [common.ring_yaml(40, s, chords=8, d=8) for s in range(4)]
    card, stats = _stream("cuda", yamls, params={"max_cycles": 40,
                                                 "prune": 1})
    cpu, _ = _stream("cpu", yamls, params={"max_cycles": 40,
                                           "prune": 1})
    _assert_equal(card, cpu)
    assert stats["pipeline"]["pipelined_dispatches"] == 0
    yamls = [common.ring_yaml(10, s, chords=3) for s in range(3)]
    card, _ = _stream("cuda", yamls, rounds=1,
                      params={"algo": "dpop"})
    cpu, _ = _stream("cpu", yamls, rounds=1, params={"algo": "dpop"})
    _assert_equal(card, cpu)
    assert all(r.get("optimal") for r in card[0])


def _session(device, yaml_src, batches):
    svc = _service(device, batch_window_s=0.01).start()
    try:
        sess = svc.sessions.open(
            _load(yaml_src),
            params={"max_cycles": 50, "segment_cycles": 50,
                    "noise": 0.0})
        q = svc.sessions.subscribe(sess.id)
        outs = [svc.sessions.apply_events(sess.id, b, wait=300)
                for b in batches]
        final = svc.sessions.close(sess.id, wait=300)
        events = []
        while not q.empty():
            events.append(q.get_nowait())
        return outs, final, events
    finally:
        svc.stop(drain=False)


def _batches(yaml_src, n=8, seed=1306):
    import numpy as np

    names = sorted(_load(yaml_src).constraints)
    rng = np.random.default_rng(seed)
    return [[{"type": "change_factor",
              "name": names[int(rng.integers(len(names)))],
              "table": rng.integers(0, 10, size=(3, 3))
              .astype(float).tolist()}] for _ in range(n)]


@pytest.mark.gpu
def test_session_card_equals_cpu():
    _need_card()
    yaml_src = common.small_yaml(48, 0)
    batches = _batches(yaml_src)
    _build.launch_counts.clear()
    card = _session("cuda", yaml_src, batches)
    assert _build.launch_counts.get("binary_factor_update", 0) > 0
    cpu = _session("cpu", yaml_src, batches)
    for a, b in zip(card[0], cpu[0]):
        assert a["applied"] and b["applied"]
        assert common.stable_body(a["result"]) == \
            common.stable_body(b["result"])
    assert common.stable_body(card[1]) == common.stable_body(cpu[1])
    keys = ("phase", "cycle", "cost", "converged", "assignment")
    assert [tuple(e.get(k) for k in keys) for e in card[2]] == \
        [tuple(e.get(k) for k in keys) for e in cpu[2]]


@pytest.mark.gpu
def test_journal_replay_on_the_card(tmp_path):
    """Requests accepted and left unfinished by a stop without drain
    on the card replay on a card service, to the CPU's answers."""
    _need_card()
    import threading

    yamls = {f"r{i}": common.small_yaml(500, i) for i in range(3)}
    d = str(tmp_path / "journal")
    svc = _service("cuda", batch_window_s=0.01, journal_dir=d)
    gate, entered = threading.Event(), threading.Event()
    real = svc._run_batch

    def blocked(reqs, params, **kw):
        entered.set()
        gate.wait(120)
        return real(reqs, params, **kw)

    svc._run_batch = blocked
    svc.start()
    scheduler = svc._scheduler._thread
    try:
        svc.submit(_load(yamls["r0"]), params=PARAMS, request_id="r0")
        assert entered.wait(120)
        for rid in ("r1", "r2"):
            svc.submit(_load(yamls[rid]), params=PARAMS, request_id=rid)
        assert svc.stop(drain=False, timeout=0.5)["replayable"] == 3
    finally:
        gate.set()
        scheduler.join(120)
    svc = _service("cuda", batch_window_s=0.05, journal_dir=d,
                   recover=True).start()
    try:
        got = {rid: svc.result(rid, wait=600) for rid in yamls}
    finally:
        svc.stop(drain=False)
    cpu, _ = _stream("cpu", [yamls[r] for r in sorted(yamls)], rounds=1,
                     batch_window_s=0.01, max_batch=1)
    for rid, ref in zip(sorted(yamls), cpu[0]):
        assert common.key_fields(got[rid]) == common.key_fields(ref)


@pytest.mark.gpu
def test_api_serve_defaults_to_the_card():
    _need_card()
    from pydcop_tpu_torch import api

    with api.serve(port=0, batch_window_s=0.01) as handle:
        assert handle.service.device.type == "cuda"
        code, body = common.http(handle.url + "/solve", "POST", {
            "dcop": common.ring_yaml(12, 0), "wait": True,
            "params": PARAMS})
    assert code == 200 and body["status"] == "FINISHED", body
    cpu, _ = _stream("cpu", [common.ring_yaml(12, 0)], rounds=1)
    assert common.key_fields(body) == common.key_fields(cpu[0][0])
