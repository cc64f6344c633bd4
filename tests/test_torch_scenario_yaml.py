"""The port's scenario model and YAML writers against ``pydcop_tpu``,
and ``solve --scenario`` against the reference CLI, on the CPU.

- ``dcop/scenario.py``: the same events, actions, equality and repr.
- ``dcop/yamldcop.py``: ``load_scenario``/``yaml_scenario`` round trips
  (``tests/unit/test_yamldcop.py``, ``test_yaml_battery.py``), equal to
  the reference's text both ways; ``dcop_yaml`` of every fixture the
  reference can dump gives the reference's text and reloads to the same
  DCOP; ``yaml_agents``/``load_agents`` the same.
- ``python -m pydcop_tpu_torch solve --scenario F --device cpu`` prints
  ``pydcop solve --scenario F``'s JSON: the same keys (the ``scenario``
  block's and each event's too), assignment, cost, cycle and per-event
  records but their wall times.
"""

import contextlib
import glob
import io
import json
import os

import pytest
import torch

import pydcop_tpu.dcop.scenario as js
import pydcop_tpu.dcop.yamldcop as jy
import pydcop_tpu_torch.dcop.scenario as ts
import pydcop_tpu_torch.dcop.yamldcop as ty
from pydcop_tpu import dcop_cli as jcli
from pydcop_tpu_torch import dcop_cli as tcli

HERE = os.path.dirname(os.path.abspath(__file__))
INSTANCES = os.path.join(HERE, "instances")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SCENARIO_YAML = """
events:
  - id: w
    delay: 1
  - id: e1
    actions:
      - type: remove_agent
        agent: a001
      - type: add_agent
        agent: a777
  - id: e2
    actions:
      - type: change_factor
        name: c1
        table: [[0, 10, 10], [10, 0, 10], [10, 10, 0]]
  - id: e3
    actions:
      - type: remove_factor
        name: c3
      - type: add_factor
        name: extra
        variables: [v002, v009]
        table: [[5, 0, 0], [0, 5, 0], [0, 0, 5]]
  - id: e4
    actions:
      - type: add_variable
        name: w0
        domain: [R, G, B]
      - type: add_factor
        name: cw
        expression: "0 if w0 == v001 else 7"
"""


def scenarios():
    return [SCENARIO_YAML,
            open(os.path.join(INSTANCES, "scenario_remove_a1.yaml")).read()]


@pytest.mark.parametrize("text", scenarios())
def test_load_and_dump_scenario_equal_the_reference(text):
    ref = jy.load_scenario(text)
    out = ty.load_scenario(text)
    assert len(out) == len(ref)
    for e_out, e_ref in zip(out, ref):
        assert e_out.id == e_ref.id
        assert e_out.delay == e_ref.delay
        assert e_out.is_delay == e_ref.is_delay
        assert repr(e_out) == repr(e_ref)
        for a_out, a_ref in zip(e_out.actions or [], e_ref.actions or []):
            assert a_out.type == a_ref.type
            assert a_out.args == a_ref.args
    dumped = ty.yaml_scenario(out)
    assert dumped == jy.yaml_scenario(ref)
    # Round trip, both ways.
    assert ty.load_scenario(dumped).events == out.events
    assert ty.load_scenario(jy.yaml_scenario(ref)).events == out.events
    assert jy.yaml_scenario(jy.load_scenario(dumped)) == dumped


def test_scenario_objects_equal_the_reference():
    for mod in (ts, js):
        a = mod.EventAction("remove_agent", agent="a1")
        assert a == mod.EventAction("remove_agent", agent="a1")
        assert a != mod.EventAction("remove_agent", agent="a2")
        e = mod.DcopEvent("e", actions=[a])
        assert not e.is_delay and mod.DcopEvent("d", delay=2).is_delay
        s = mod.Scenario([e])
        s.add_event(mod.DcopEvent("d", delay=2))
        assert len(s) == 2 and list(s)[0] == e
    assert repr(ts.EventAction("x", k=1)) == repr(js.EventAction("x", k=1))
    assert (ts.EventAction("x", k=1)._simple_repr()["k"]
            == js.EventAction("x", k=1)._simple_repr()["k"])
    assert ts.EventAction._from_repr(
        {"type": "x", "k": 2, "__module__": "m"}).args == {"k": 2}


def dumpable():
    out = []
    for path in sorted(glob.glob(os.path.join(INSTANCES, "*.y*ml"))):
        try:
            jy.dcop_yaml(jy.load_dcop_from_file(path))
        except Exception:  # noqa: BLE001 — not a DCOP the reference dumps
            continue
        out.append(os.path.basename(path))
    return out


@pytest.mark.parametrize("name", dumpable())
def test_dcop_yaml_equals_the_reference(name):
    path = os.path.join(INSTANCES, name)
    text = ty.dcop_yaml(ty.load_dcop_from_file(path))
    assert text == jy.dcop_yaml(jy.load_dcop_from_file(path))
    again = ty.load_dcop(text)
    assert ty.dcop_yaml(again) == text


def test_agents_yaml_equals_the_reference():
    path = os.path.join(INSTANCES, "coloring_12_3_capa_costs.yml")
    agents_t = list(ty.load_dcop_from_file(path).agents.values())
    agents_j = list(jy.load_dcop_from_file(path).agents.values())
    text = ty.yaml_agents(agents_t)
    assert text == jy.yaml_agents(agents_j)
    reloaded = ty.load_agents(text)
    assert [a.name for a in reloaded] == [a.name for a in agents_t]
    assert ty.yaml_agents(reloaded) == text


def cli(main, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    assert rc in (0, None)
    return json.loads(buf.getvalue())


def keys(x):
    """Every key path of a JSON value."""
    if isinstance(x, dict):
        return {(k,) + p for k, v in x.items() for p in keys(v) | {()}}
    if isinstance(x, list):
        return set().union(*(keys(v) for v in x)) if x else set()
    return set()


@pytest.mark.parametrize("margin", [None, "0.5"])
def test_cli_scenario_equals_the_reference(tmp_path, margin):
    scen = tmp_path / "scenario.yaml"
    scen.write_text(SCENARIO_YAML)
    dcop_file = os.path.join(INSTANCES, "coloring_12_3.yml")
    args = ["solve", "--algo", "maxsum", "-c", "80",
            "--scenario", str(scen), "--scenario_event_cycles", "40"]
    if margin:
        args += ["-p", f"decimation_margin:{margin}"]
    ref = cli(jcli.main, args + [dcop_file])
    out = cli(tcli.main, args + ["--device", "cpu", dcop_file])
    assert keys(out) == keys(ref)
    for key in ("status", "assignment", "cost", "violation", "cycle",
                "backend"):
        assert out[key] == ref[key], key
    strip = lambda block: {  # noqa: E731
        **block, "file": None,
        "events": [{k: v for k, v in e.items() if k != "wall_s"}
                   for e in block["events"]]}
    assert strip(out["scenario"]) == strip(ref["scenario"])
    assert out["scenario"]["recompiles"] >= 1


def test_cli_scenario_refuses_other_algorithms(tmp_path):
    scen = tmp_path / "scenario.yaml"
    scen.write_text(SCENARIO_YAML)
    with pytest.raises(ValueError, match="maxsum-family"):
        tcli.main(["solve", "--algo", "dsa", "--device", "cpu",
                   "--scenario", str(scen),
                   os.path.join(INSTANCES, "coloring_12_3.yml")])
