"""The port's problem generators against ``pydcop_tpu``'s, on the CPU.

Every generator draws from ``np.random.default_rng(seed)``, so the port
must copy the reference's draws call for call: a draw moved or merged
changes every problem after it.  Each case runs the reference's
generator and the port's with the same arguments and holds
``dcop_yaml`` of the two DCOPs equal as strings (and, for the edge-list
generators, the edge lists; for ``generate_ising`` its two mappings;
for ``generate_agents`` ``yaml_agents``; for the scenario generators
``yaml_scenario``).  The cases follow ``tests/unit/test_generators.py``
and ``test_scenario_generators_battery.py``, at a few seeds and sizes.
"""

import importlib

import pytest
import torch

import pydcop_tpu.dcop.yamldcop as jy
import pydcop_tpu_torch.dcop.yamldcop as ty


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def both(module: str, func: str, *args, **kwargs):
    """``func`` of ``generators/<module>.py`` run in each package."""
    ref = getattr(importlib.import_module(
        f"pydcop_tpu.generators.{module}"), func)(*args, **kwargs)
    port = getattr(importlib.import_module(
        f"pydcop_tpu_torch.generators.{module}"), func)(*args, **kwargs)
    return ref, port


def both_raise(module: str, func: str, *args, **kwargs):
    """The message of the error each package raises, which must agree."""
    messages = []
    for package in ("pydcop_tpu", "pydcop_tpu_torch"):
        fn = getattr(importlib.import_module(
            f"{package}.generators.{module}"), func)
        with pytest.raises(ValueError) as info:
            fn(*args, **kwargs)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    return messages[0]


def assert_same_yaml(ref, port):
    text = jy.dcop_yaml(ref)
    assert ty.dcop_yaml(port) == text
    return text


# -- edge lists -------------------------------------------------------- #

EDGE_CASES = [
    ("random_graph", (30, 0.05), {"seed": 0}),
    ("random_graph", (20, 0.2), {"seed": 5}),
    ("random_graph", (60, 0.01), {"seed": 3}),
    ("random_graph", (40, 0.1), {"allow_subgraph": True, "seed": 2}),
    ("grid_graph", (9,), {}),
    ("grid_graph", (16,), {"periodic": True}),
    ("grid_graph", (25,), {"periodic": True}),
    ("grid_2d_graph", (4, 4), {"periodic": True}),
    ("grid_2d_graph", (2, 3), {"periodic": True}),
    ("grid_2d_graph", (3, 5), {"periodic": False}),
    ("grid_2d_graph", (1, 4), {}),
    ("scalefree_graph", (30, 2), {"seed": 0}),
    ("scalefree_graph", (200, 3), {"seed": 11}),
    ("scalefree_graph", (50, 1), {"allow_subgraph": True, "seed": 4}),
    ("scalefree_graph", (2_000, 2), {"seed": 0}),
    ("small_world_graph", (20,), {"k": 4, "seed": 0}),
    ("small_world_graph", (100, 6, 0.3), {"seed": 9}),
    ("small_world_graph", (5, 4, 1.0), {"seed": 1}),
]


@pytest.mark.parametrize("func,args,kwargs", EDGE_CASES)
def test_edge_lists_equal_the_reference(func, args, kwargs):
    ref, port = both("graphs", func, *args, **kwargs)
    assert ref, "no edge generated"
    assert port == ref


@pytest.mark.parametrize("func,args", [
    ("grid_graph", (7,)),
    ("scalefree_graph", (5, 0)),
    ("scalefree_graph", (5, 5)),
])
def test_edge_list_refusals_equal_the_reference(func, args):
    both_raise("graphs", func, *args)


# -- graph colouring --------------------------------------------------- #

COLORING_CASES = [
    ((10, 3, "random"), {"p_edge": 0.3, "seed": 1}),
    ((10, 3, "random"), {"p_edge": 0.3, "seed": 7}),
    ((10, 3, "random"), {"soft": True, "p_edge": 0.3, "seed": 1}),
    ((6, 3, "random"), {"intentional": True, "p_edge": 0.3, "seed": 1}),
    ((12, 3, "random"), {"p_edge": 0.3, "allow_subgraph": True,
                         "seed": 1}),
    ((16, 4, "grid"), {"seed": 2}),
    ((25, 9, "grid"), {"soft": True, "seed": 3}),
    ((50, 3, "scalefree"), {"soft": True, "m_edge": 2, "seed": 0}),
    ((40, 5, "scalefree"), {"m_edge": 3, "noagents": True, "seed": 6}),
    ((100, 3, "scalefree"), {"soft": True, "m_edge": 2, "seed": 0}),
    ((1_000, 3, "scalefree"), {"soft": True, "m_edge": 2, "seed": 0}),
]


@pytest.mark.parametrize("args,kwargs", COLORING_CASES)
def test_graph_coloring_equals_the_reference(args, kwargs):
    ref, port = both("graphcoloring", "generate_graph_coloring",
                     *args, **kwargs)
    assert_same_yaml(ref, port)
    assert len(port.variables) == args[0]
    assert port.name == ref.name


@pytest.mark.parametrize("args,kwargs", [
    ((10, 3, "random"), {}),
    ((10, 3, "scalefree"), {}),
    ((10, 3, "ring"), {}),
    ((10, 3, "random"), {"soft": True, "intentional": True,
                         "p_edge": 0.3}),
])
def test_graph_coloring_refusals_equal_the_reference(args, kwargs):
    both_raise("graphcoloring", "generate_graph_coloring", *args, **kwargs)


# -- Ising ------------------------------------------------------------- #

ISING_CASES = [
    ((4, 4), {"seed": 0, "var_dist": True, "fg_dist": True}),
    ((3, 4), {"seed": 1}),
    ((3, 3), {"un_range": 0.05, "seed": 3}),
    ((2, 2), {"seed": 5, "extensive": False}),
    ((5,), {"seed": 0}),
    ((2, 3), {"bin_range": 3.0, "un_range": 0.5, "seed": 8,
              "fg_dist": True}),
    ((3, 3), {"no_agents": True, "var_dist": True, "seed": 2}),
    ((10,), {"seed": 0, "fg_dist": True, "var_dist": True}),
]


@pytest.mark.parametrize("args,kwargs", ISING_CASES)
def test_ising_and_its_mappings_equal_the_reference(args, kwargs):
    (ref, ref_var, ref_fg), (port, port_var, port_fg) = both(
        "ising", "generate_ising", *args, **kwargs)
    assert_same_yaml(ref, port)
    assert port_var == ref_var
    assert port_fg == ref_fg
    if kwargs.get("fg_dist") and not kwargs.get("no_agents"):
        comps = [c for lst in port_fg.values() for c in lst]
        assert sorted(comps) == sorted(
            set(port.constraints) | set(port.variables))


# -- the other problem families --------------------------------------- #

MEETINGS_CASES = [
    ((4, 3, 3, 2), {"seed": 0}),
    ((4, 3, 3, 2), {"seed": 9}),
    ((3, 2, 2, 1), {"seed": 4}),
    ((6, 8, 5, 3), {"max_length_event": 2, "seed": 2}),
    ((5, 10, 6, 3), {"max_resource_value": 5, "penalty": 50,
                     "capacity": 20, "seed": 1}),
    ((4, 5, 3, 2), {"no_agents": True, "seed": 3}),
    ((10, 40, 20, 4), {"seed": 0}),
]


@pytest.mark.parametrize("args,kwargs", MEETINGS_CASES)
def test_meetings_equal_the_reference(args, kwargs):
    ref, port = both("meetingscheduling", "generate_meetings",
                     *args, **kwargs)
    assert_same_yaml(ref, port)
    assert port.objective == "max"


SECP_CASES = [
    ((6, 2, 3), {"seed": 0}),
    ((4, 2, 2), {"seed": 3}),
    ((20, 5, 5), {"seed": 0}),
    ((10, 4, 6), {"capacity": 50, "max_model_size": 4,
                  "max_rule_size": 4, "seed": 7}),
    ((2, 1, 3), {"max_model_size": 5, "seed": 1}),
    ((60, 12, 12), {"seed": 0}),
]


@pytest.mark.parametrize("args,kwargs", SECP_CASES)
def test_secp_equals_the_reference(args, kwargs):
    ref, port = both("secp", "generate_secp", *args, **kwargs)
    assert_same_yaml(ref, port)
    lights = sum(1 for v in port.variables if v.startswith("l"))
    assert lights == args[0] == len(port.agents)


@pytest.mark.parametrize("args,kwargs", [
    ((12,), {"seed": 0}),
    ((40,), {"seed": 0}),
    ((30,), {"domain_size": 4, "m_edge": 3, "range_cost": 5, "seed": 2}),
    ((8,), {"domain_size": 2, "m_edge": 1, "seed": 5}),
])
def test_iot_equals_the_reference(args, kwargs):
    ref, port = both("iot", "generate_iot", *args, **kwargs)
    assert_same_yaml(ref, port)


@pytest.mark.parametrize("args,kwargs", [
    ((12, 4), {"seed": 0}),
    ((40,), {"seed": 0}),
    ((30, 3, 6, 0.3, 5), {"seed": 4}),
    ((10, 2, 2, 0.0), {"seed": 1}),
])
def test_small_world_equals_the_reference(args, kwargs):
    ref, port = both("smallworld", "generate_small_world", *args, **kwargs)
    assert_same_yaml(ref, port)


# -- agents ------------------------------------------------------------ #

AGENT_CASES = [
    {"mode": "count", "count": 5, "capacity": 50},
    {"mode": "count", "count": 12, "capacity": 10, "agent_prefix": "ag",
     "hosting": "var_startswith", "hosting_default": 7,
     "variables": ["v1", "v2", "x1"]},
    {"mode": "variables", "variables": ["v1", "v2"], "capacity": 10,
     "hosting": "name_mapping", "hosting_default": 100},
    {"mode": "variables", "variables": ["v1", "v2", "v3"], "capacity": 3,
     "routes": "uniform", "routes_default": 5},
    {"mode": "variables", "variables": ["v1", "v2", "v3", "v4"],
     "capacity": 3, "routes": "graph", "routes_default": 9,
     "adjacency": [("v1", "v2"), ("v2", "v3"), ("v4", "v9")]},
]


@pytest.mark.parametrize("kwargs", AGENT_CASES)
def test_agents_equal_the_reference(kwargs):
    ref, port = both("agents_gen", "generate_agents", **kwargs)
    assert ty.yaml_agents(port) == jy.yaml_agents(ref)
    assert [a.name for a in port] == [a.name for a in ref]


@pytest.mark.parametrize("kwargs", [
    {"mode": "count", "hosting": "name_mapping"},
    {"mode": "count", "count": 3, "routes": "graph"},
    {"mode": "variables"},
    {"mode": "count"},
    {"mode": "count", "count": 3, "hosting": "var_startswith"},
    {"mode": "count", "count": 3, "routes": "uniform"},
])
def test_agent_refusals_equal_the_reference(kwargs):
    both_raise("agents_gen", "generate_agents", **kwargs)


# -- scenarios --------------------------------------------------------- #

@pytest.mark.parametrize("args,kwargs", [
    ((2, 1, 5, ["a1", "a2", "a3", "a4"]), {"seed": 0}),
    ((3, 2, 1.5, [f"a{i}" for i in range(10)]), {"seed": 4,
                                                  "initial_delay": 3,
                                                  "end_delay": 7}),
    ((5, 2, 2, ["a1", "a2", "a3"]), {"seed": 1}),
])
def test_agent_scenarios_equal_the_reference(args, kwargs):
    ref, port = both("scenario_gen", "generate_scenario", *args, **kwargs)
    assert ty.yaml_scenario(port) == jy.yaml_scenario(ref)


@pytest.mark.parametrize("n_events,seed,weights", [
    (8, 28, {}),
    (20, 3, {"change_weight": 0.2, "churn_weight": 0.6,
             "grow_weight": 0.2}),
    (12, 5, {"cost_range": 4}),
])
def test_factor_scenarios_equal_the_reference(n_events, seed, weights):
    """Each package mutates its own copy of one generated problem."""
    ref_dcop, port_dcop = both(
        "iot", "generate_iot", 30, seed=seed)
    assert_same_yaml(ref_dcop, port_dcop)
    ref = importlib.import_module(
        "pydcop_tpu.generators.scenario_gen").generate_factor_scenario(
            ref_dcop, n_events, seed=seed, **weights)
    port = importlib.import_module(
        "pydcop_tpu_torch.generators.scenario_gen"
    ).generate_factor_scenario(port_dcop, n_events, seed=seed, **weights)
    assert ty.yaml_scenario(port) == jy.yaml_scenario(ref)
    assert len(port) == n_events


def test_factor_scenario_refusal_equals_the_reference():
    ref_dcop, port_dcop = both("ising", "generate_ising", 2, 2,
                               extensive=False, seed=0)
    messages = []
    for package, dcop in (("pydcop_tpu", ref_dcop[0]),
                          ("pydcop_tpu_torch", port_dcop[0])):
        gen = importlib.import_module(f"{package}.generators.scenario_gen")
        with pytest.raises(ValueError) as info:
            gen.generate_factor_scenario(dcop, 3, seed=0)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
