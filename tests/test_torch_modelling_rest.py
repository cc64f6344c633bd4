"""The rest of the port's modelling layer against ``pydcop_tpu``, on the
CPU: the objects and relations the generators and the graph tooling
need, ``filter_dcop``, and ``Distribution`` with the distribution files.

Each case builds the same inputs in both packages and holds the port's
answers (values, names, reprs, cost tables, YAML text, error messages)
to the reference's.  The cases follow ``tests/unit/test_dcop_objects.py``,
``test_objects_battery.py``, ``test_dcop_relations.py``,
``test_relations_battery.py`` and ``test_distribution.py``.
"""

import importlib

import numpy as np
import pytest
import torch

PACKAGES = ("pydcop_tpu", "pydcop_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def mods(package):
    return (importlib.import_module(f"{package}.dcop.objects"),
            importlib.import_module(f"{package}.dcop.relations"))


def in_both(build):
    """``build(objects, relations)`` run with each package's modules."""
    return [build(*mods(p)) for p in PACKAGES]


def errors_in_both(build, exc=Exception):
    messages = []
    for p in PACKAGES:
        with pytest.raises(exc) as info:
            build(*mods(p))
        messages.append((type(info.value).__name__, str(info.value)))
    assert messages[0] == messages[1]


# -- objects ----------------------------------------------------------- #

def test_binary_variable_equals_the_reference():
    def build(o, r):
        v = o.BinaryVariable("b1", initial_value=1)
        c = v.clone()
        return (repr(v), v.name, list(v.domain), v.initial_value,
                repr(c), c.initial_value, list(o.binary_domain),
                o.binary_domain.name, v.cost_for_val(1))
    ref, port = in_both(build)
    assert port == ref


def test_variable_with_cost_dict_equals_the_reference():
    def build(o, r):
        d = o.Domain("d", "", ["a", "b", "c"])
        v = o.VariableWithCostDict("x", d, {"a": 1.5, "c": -2.0},
                                   initial_value="b")
        c = v.clone()
        return (v.has_cost, v.costs, [v.cost_for_val(x) for x in d],
                c.costs, c.initial_value, type(c).__name__,
                [c.cost_for_val(x) for x in d])
    ref, port = in_both(build)
    assert port == ref


@pytest.mark.parametrize("indexes", [
    range(3), ["a", "b"], [["a", "b"], range(2)], [range(2), range(3)],
    [[1, 2], ["x"], range(2)], (range(2), ("p", "q")),
])
def test_mass_creation_equals_the_reference(indexes):
    def build(o, r):
        d = o.Domain("d", "", [0, 1])
        vs = o.create_variables("x_", indexes, d)
        bs = o.create_binary_variables("b_", indexes) if not isinstance(
            indexes, range) else o.create_binary_variables(
                "b_", [str(i) for i in indexes])
        agents = o.create_agents("a", indexes, default_hosting_cost=3,
                                 capacity=7)
        return ({k: (v.name, list(v.domain)) for k, v in vs.items()},
                {k: (type(v).__name__, v.name) for k, v in bs.items()},
                {k: (a.name, a.capacity, a.hosting_cost("z"))
                 for k, a in agents.items()},
                o._expand_indices(indexes))
    ref, port = in_both(build)
    assert port == ref


# -- relations --------------------------------------------------------- #

def test_unary_and_zero_ary_relations_equal_the_reference():
    def build(o, r):
        d = o.Domain("d", "", [0, 1, 2, 3])
        x = o.Variable("x", d)
        zero = r.ZeroAryRelation("z", 4.5)
        by_str = r.UnaryFunctionRelation("u", x, "x * 2 - 1")
        by_fn = r.UnaryFunctionRelation("f", x, lambda v: v ** 2)
        const = r.UnaryFunctionRelation("k", x, "7")
        boolean = r.UnaryBooleanRelation("b", x)
        return (zero(), zero.to_array().tolist(), zero.arity,
                [by_str(v) for v in d], [by_str(x=v) for v in d],
                by_str.expression, by_str.to_array().tolist(),
                [by_fn(v) for v in d], by_fn.expression,
                [const(v) for v in d], [boolean(v) for v in d],
                boolean.to_array().tolist(), by_str.variable.name,
                by_fn.scope_names)
    ref, port = in_both(build)
    assert port == ref


def test_neutral_and_conditional_relations_equal_the_reference():
    def build(o, r):
        d = o.Domain("d", "", [0, 1, 2])
        x, y, z = (o.Variable(n, d) for n in "xyz")
        neutral = r.NeutralRelation([x, y])
        cond = r.constraint_from_str("cond", "x > 0", [x])
        rel = r.constraint_from_str("rel", "y + 10 * z", [y, z])
        conditional = r.ConditionalRelation(cond, rel, "cr",
                                            return_default=-1)
        grid = [(a, b, c) for a in d for b in d for c in d]
        return (neutral.name, neutral.to_array().tolist(),
                neutral(1, 2), conditional.scope_names,
                conditional.condition.name, conditional.relation.name,
                [conditional(*g) for g in grid],
                [conditional(x=a, y=b, z=c) for a, b, c in grid],
                conditional.to_array().tolist())
    ref, port = in_both(build)
    assert port == ref


def test_relation_functions_equal_the_reference():
    def build(o, r):
        d = o.Domain("d", "", [0, 1, 2])
        x, y, z = (o.Variable(n, d) for n in "xyz")

        @r.AsNAryFunctionRelation(x, y)
        def pair(x, y):
            return x * 3 + y

        table = r.NAryMatrixRelation(
            [y, z], np.arange(9, dtype=float).reshape(3, 3), "t")
        costly = o.VariableWithCostDict("w", d, {0: 5.0, 1: -1.0, 2: 2.0})
        ext = r.add_var_to_rel("ext", pair, z, lambda c, v: c * 10 + v)
        asst = {"x": 2, "y": 1, "z": 0}
        return (pair.name, pair(2, 1), pair.to_array().tolist(),
                list(r.generate_assignment([x, y])),
                list(r.generate_assignment_as_dict([x, z])),
                r.count_var_match(["x", "z", "q"], pair),
                r.assignment_cost(asst, [pair, table]),
                r.find_optimum(table, "min"), r.find_optimum(table, "max"),
                r.find_optimal(y, asst, [pair, table], "min"),
                r.find_optimal(y, asst, [pair, table], "max"),
                r.optimal_cost_value(costly, "min"),
                r.optimal_cost_value(costly, "max"),
                ext.scope_names, ext(x=1, y=2, z=1), ext.to_array().tolist(),
                r.RelationProtocol is r.Constraint)
    ref, port = in_both(build)
    assert port == ref


def test_assignment_cost_refusal_equals_the_reference():
    def build(o, r):
        d = o.Domain("d", "", [0, 1])
        x = o.Variable("x", d)
        hard = r.UnaryFunctionRelation(
            "h", x, lambda v: float("inf") if v else 0.0)
        assert r.assignment_cost({"x": 0}, [hard]) == 0.0
        r.assignment_cost({"x": 1}, [hard])
    errors_in_both(build, ValueError)


# -- dcop.py ----------------------------------------------------------- #

@pytest.mark.parametrize("accept_unary", [False, True])
@pytest.mark.parametrize("generator", ["ising", "secp",
                                       "meetingscheduling"])
def test_filter_dcop_equals_the_reference(generator, accept_unary):
    """A lone variable with only a unary factor is dropped unless unary
    factors count."""
    from pydcop_tpu.dcop.yamldcop import dcop_yaml as jyaml
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml as tyaml

    texts = []
    for package in PACKAGES:
        gen = importlib.import_module(f"{package}.generators.{generator}")
        o, r = mods(package)
        dcop = {"ising": lambda: gen.generate_ising(3, 3, seed=2)[0],
                "secp": lambda: gen.generate_secp(5, 2, 3, seed=1),
                "meetingscheduling": lambda: gen.generate_meetings(
                    4, 5, 6, 2, seed=4)}[generator]()
        lone = o.Variable("lone", list(dcop.variables.values())[0].domain)
        dcop.add_variable(lone)
        dcop.add_constraint(r.UnaryFunctionRelation("c_lone", lone, "lone"))
        filtered = importlib.import_module(
            f"{package}.dcop.dcop").filter_dcop(dcop, accept_unary)
        assert ("lone" in filtered.variables) == accept_unary
        texts.append((jyaml if package == "pydcop_tpu" else tyaml)(
            filtered))
    assert texts[0] == texts[1]


# -- distribution ------------------------------------------------------ #

def dist_modules(package):
    return (importlib.import_module(f"{package}.distribution.objects"),
            importlib.import_module(f"{package}.dcop.yamldcop"))


def test_distribution_equals_the_reference():
    answers = []
    for package in PACKAGES:
        objs, _ = dist_modules(package)
        d = objs.Distribution({"a1": ["c1", "c2"], "a2": ["c3"]})
        d.host_on_agent("a3", ["c4"])
        d.host_on_agent("a1", ["c5"])
        answers.append((d.mapping, d.agents, d.computations,
                        d.agent_for("c3"), d.computations_hosted("a1"),
                        d.computations_hosted("none"), d.is_hosted("c4"),
                        d.is_hosted(["c1", "c9"]), d.has_computation("c5"),
                        repr(d), d == objs.Distribution(d.mapping),
                        d._simple_repr()["mapping"],
                        objs.Distribution._from_repr(
                            d._simple_repr()).mapping,
                        issubclass(objs.ImpossibleDistributionException,
                                   Exception)))
    assert answers[0] == answers[1]


@pytest.mark.parametrize("bad", [["c1"], ["c9", "c9"]])
def test_distribution_refusals_equal_the_reference(bad):
    messages = []
    for package in PACKAGES:
        objs, _ = dist_modules(package)
        d = objs.Distribution({"a1": ["c1"]})
        with pytest.raises(ValueError) as info:
            d.host_on_agent("a2", bad)
        messages.append(str(info.value))
        with pytest.raises(KeyError):
            d.agent_for("nowhere")
    assert messages[0] == messages[1]


@pytest.mark.parametrize("inputs,cost", [
    (None, None), ({"dist_algo": "adhoc", "graph": "factor_graph"}, 12.5),
    ({}, 0),
])
def test_distribution_files_round_trip_as_the_reference(tmp_path, inputs,
                                                        cost):
    mapping = {"a1": ["v1", "c1"], "a2": [], "a_3": ["v2"]}
    texts, loaded = [], []
    for package in PACKAGES:
        objs, yml = dist_modules(package)
        text = yml.yaml_dist(objs.Distribution(mapping), inputs, cost)
        texts.append(text)
        path = tmp_path / f"{package}.yaml"
        path.write_text(text, encoding="utf-8")
        loaded.append((yml.load_dist(text).mapping,
                       yml.load_dist_from_file(str(path)).mapping,
                       yml.load_dist("").mapping,
                       yml.load_dist("distribution:\n  a1:\n").mapping))
    assert texts[0] == texts[1]
    assert loaded[0] == loaded[1]
    assert loaded[1][0] == mapping


def test_ising_distribution_files_equal_the_reference():
    """What ``generate ising --fg_dist --var_dist`` writes."""
    texts = []
    for package in PACKAGES:
        objs, yml = dist_modules(package)
        gen = importlib.import_module(f"{package}.generators.ising")
        _, var_mapping, fg_mapping = gen.generate_ising(
            3, 4, fg_dist=True, var_dist=True, seed=6)
        texts.append([yml.yaml_dist(objs.Distribution(m))
                      for m in (var_mapping, fg_mapping)])
    assert texts[0] == texts[1]
