"""The port's ``algo="auto"`` solve (``api.solve``, ``solve -a auto``)
against ``pydcop_tpu`` on the CPU, and the portfolio racer's two
deliberate divergences from the reference.

- ``api.solve(dcop, "auto", device="cpu")`` and ``python -m
  pydcop_tpu_torch solve -a auto`` end in the reference's winner,
  assignment, cost and keys under the same leg times (the fake clock of
  ``tests/test_torch_portfolio.py``), and replay the decision from the
  cache without racing; the domino chain resolves to DPOP at cost 1.0;
  parameters the winner does not take are dropped with a warning.
- A leg that raises anything but a leg's refusal (DPOP's
  ``UtilTooLargeError``) fails the race and the solve (the reference
  drops it); a refusal drops the leg.
- The port never replays a cache entry the reference wrote (both read
  ``PYDCOP_AGG_AUTOTUNE_CACHE`` with equal CPU keys; the port's entries
  carry ``autotune.WRITER``), for portfolio and aggregation entries.
"""

import contextlib
import io
import json
import os

import pytest
import torch

import pydcop_tpu.api as japi
import pydcop_tpu.engine.autotune as JA
import pydcop_tpu_torch.api as tapi
import pydcop_tpu_torch.engine.autotune as TA
from pydcop_tpu import dcop_cli as jcli
from pydcop_tpu_torch import dcop_cli as tcli
from test_torch_portfolio import (
    FIXTURES,
    both,
    coloring_dcop,
    compiled,
    domino_chain,
    fake_clock,
    ring_instance,
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


@pytest.mark.parametrize("name", ["ring"])
def test_api_auto_equals_the_reference(name, tmp_path, monkeypatch):
    jdcop, tdcop = both(name)
    with fake_clock(monkeypatch):
        monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE",
                           str(tmp_path / "j.json"))
        ref = japi.solve(jdcop, "auto", max_cycles=120)
        monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE",
                           str(tmp_path / "t.json"))
        out = tapi.solve(tdcop, "auto", max_cycles=120, device="cpu")
        again = tapi.solve(FIXTURES[name]("torch"), "auto",
                           max_cycles=120, device="cpu")
    info, ref_info = out["metrics"]["portfolio"], ref["metrics"]["portfolio"]
    assert info == ref_info
    assert info["portfolio_source"] == "measured"
    for key in ("assignment", "cost", "violations", "cycles", "status"):
        assert out[key] == ref[key], key
    assert set(out) == set(ref)
    assert again["metrics"]["portfolio"] == {
        "algo": info["algo"], "portfolio_source": "cache",
        "portfolio_key": info["portfolio_key"]}
    assert again["assignment"] == out["assignment"]


def test_auto_picks_dpop_on_the_domino_then_replays(tmp_path, monkeypatch):
    monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    res = tapi.solve(domino_chain("torch"), "auto", device="cpu")
    info = res["metrics"]["portfolio"]
    assert info["algo"] == "dpop"
    assert res.cost == 1.0
    res2 = tapi.solve(domino_chain("torch"), "auto", device="cpu")
    assert res2["metrics"]["portfolio"]["portfolio_source"] == "cache"
    assert res2["metrics"]["portfolio"]["algo"] == "dpop"
    assert res2.cost == 1.0


def test_dropped_params_warn(tmp_path, monkeypatch, caplog):
    """The winner's parameters are merged over the caller's; those it
    does not take are dropped with the reference's warning."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE", str(path))
    tdcop = coloring_dcop("torch")
    key = TA.dcop_portfolio_key(tdcop, "cpu")
    TA._store_cache(str(path), {key: {"algo": "maxsum_decim"}})
    with caplog.at_level("WARNING", logger="pydcop_tpu_torch.api"):
        res = tapi.solve(tdcop, "auto", max_cycles=50, device="cpu",
                         algo_params={"damping": 0.7, "variant": "B"})
    assert "variant" in caplog.text and "damping" not in caplog.text
    assert res["metrics"]["portfolio"]["algo"] == "maxsum_decim"
    assert res["metrics"]["decimated_vars"] >= 0


def cli(main, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    assert rc in (0, None)
    return json.loads(buf.getvalue())


def test_cli_auto_equals_the_reference(tmp_path, monkeypatch):
    from pydcop_tpu.dcop.yamldcop import load_dcop_from_file as jload

    path = os.path.join(os.path.dirname(__file__), "instances",
                        "coloring_12_3.yml")
    jdcop = jload(path)
    with fake_clock(monkeypatch):
        monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE",
                           str(tmp_path / "j.json"))
        ref = cli(jcli.main, ["solve", "-a", "auto", "-c", "60",
                              "-p", "noise:0.01", path])
        monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE",
                           str(tmp_path / "t.json"))
        out = cli(tcli.main, ["solve", "-a", "auto", "-c", "60",
                              "-p", "noise:0.01", "--device", "cpu", path])
    assert set(out) == set(ref)
    for key in ("status", "assignment", "cost", "violation", "cycle",
                "msg_count", "msg_size", "backend"):
        assert out[key] == ref[key], key
    assert jdcop.solution_cost(out["assignment"])[0] == out["cost"]


# ------------------------------------------------------------------ #
# the deliberate divergences


def test_a_leg_that_raises_fails_the_race_and_the_solve(
        tmp_path, monkeypatch):
    """The reference drops a leg on any exception; the port drops one
    only on a leg's refusal (DPOP's UtilTooLargeError), so a kernel
    that fails to build or launch fails the solve."""
    from pydcop_tpu_torch.ops import dsa as dsa_ops

    def broken(*a, **kw):
        raise RuntimeError("segment_sum launch failed: CUDA error 700")

    monkeypatch.setattr(dsa_ops, "run_dsa", broken)
    monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE",
                       str(tmp_path / "tune.json"))
    _, (_, tg, tmeta) = compiled("ring")
    with pytest.raises(RuntimeError, match="launch failed"):
        TA.autotune_portfolio(tg, race_cycles=10, meta=tmeta,
                              device="cpu", use_cache=False)
    with pytest.raises(RuntimeError, match="launch failed"):
        tapi.solve(ring_instance("torch"), "auto", device="cpu")
    assert not (tmp_path / "tune.json").exists()


def test_a_leg_refusal_drops_the_leg(tmp_path):
    from pydcop_tpu_torch.ops.dpop import UtilTooLargeError

    def refusing():
        raise UtilTooLargeError("UTIL table too large")

    _, (_, tg, tmeta) = compiled("ring")
    info = TA.autotune_portfolio(
        tg, race_cycles=10, meta=tmeta, device="cpu",
        cache_file=str(tmp_path / "tune.json"),
        extra_runners={"dpop": refusing})
    assert info["portfolio_notes"] == {"dpop": "UtilTooLargeError"}
    assert info["portfolio_costs"]["dpop"] is None
    assert info["algo"] != "dpop"


def test_the_port_never_replays_a_reference_entry(tmp_path, monkeypatch):
    """Both packages read one file and their CPU keys are equal: the
    port replays only the entries it wrote, and the reference still
    replays those (the marker is one more field)."""
    (_, g, jmeta), (tdcop, tg, tmeta) = compiled("coloring30")
    cache = str(tmp_path / "shared.json")
    ref = JA.autotune_portfolio(g, race_cycles=10, cache_file=cache,
                                meta=jmeta, candidates=("maxsum", "dsa"))
    key = ref["portfolio_key"]
    assert TA.portfolio_key(TA.graph_shape_key(tg, "cpu")) == key
    assert TA.cached_portfolio_choice(key, cache) is None
    assert TA.cached_portfolio_timing_ms(key, cache) is None
    out = TA.autotune_portfolio(tg, race_cycles=10, cache_file=cache,
                                meta=tmeta, device="cpu",
                                candidates=("maxsum", "dsa"))
    assert out["portfolio_source"] == "measured"
    stored = json.load(open(cache))[key]
    assert stored[TA.WRITER_KEY] == TA.WRITER
    assert stored["backend"] == "cpu"
    assert JA.autotune_portfolio(
        g, race_cycles=10, cache_file=cache,
        meta=jmeta)["portfolio_source"] == "cache"
    # api.solve: a reference entry under the DCOP's key is raced again.
    monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE", cache)
    with open(cache, "w") as f:
        json.dump({key: {"algo": "mgm"}}, f)
    res = tapi.solve(tdcop, "auto", max_cycles=30, device="cpu")
    assert res["metrics"]["portfolio"]["portfolio_source"] == "measured"


def test_the_port_never_replays_a_reference_aggregation_entry(tmp_path):
    _, (_, tg, _) = compiled("coloring30")
    cache = str(tmp_path / "agg.json")
    key = TA.graph_shape_key(tg, "cpu")
    with open(cache, "w") as f:
        json.dump({key: {"aggregation": "sorted", "backend": "cpu"}}, f)
    assert TA.cached_choice(key, cache) is None
    info = TA.autotune_aggregation(tg, cache_file=cache, device="cpu")
    assert info["aggregation_source"] == "measured"
    assert TA.cached_choice(key, cache) == info["aggregation"]


def test_auto_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.solve(ring_instance("torch"), "auto")
