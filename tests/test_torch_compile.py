"""The port's host compiler (pydcop_tpu_torch/engine/compile.py) against
pydcop_tpu.engine.compile.compile_dcop: every compiled array is
``np.array_equal`` and every meta field equal, on the fixtures under
tests/instances/, with and without tie-breaking noise, on a mixed-arity
(1/2/3) DCOP and under row padding; the ``agg_*`` arrays of the
sorted/boundary/ell aggregations too, on the fixtures and on a padded
multi-bucket graph.  The ell hub guard refuses the same graphs with the
same message; ``validated_aggregation`` and ``prune_width`` give the
same values; the structure cache counts hits and layout builds.

Also the home of the small test problems the other port tests share.
"""

import os

import jax  # noqa: F401  (imported first: JAX stays on the CPU)
import numpy as np
import pytest
import torch

import pydcop_tpu.engine.compile as JC
import pydcop_tpu_torch.engine.compile as TC
from pydcop_tpu.dcop import yamldcop as jax_yaml
from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu_torch.dcop import yamldcop as torch_yaml
from pydcop_tpu_torch.engine.compile import compile_dcop as torch_compile


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


INSTANCES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "instances")

FIXTURES = [
    "coloring_12_3.yml",
    "coloring_12_3_capa_costs.yml",
    "coloring_3agents_10vars.yaml",
    "coloring_chain.yaml",
    "coloring_chain_func.yaml",
    "coloring_ext_costs.yaml",
    "coloring_int_costs.yaml",
    "coloring_ring_hard.yaml",
    "loft_scene.yml",
    "pref_ring_max.yaml",
    "secp_lamps.yaml",
]

# Arities 1, 2 and 3, two domain sizes (so tables carry BIG padding),
# a variable-side cost function, and integer-valued costs throughout.
MIXED_YAML = """
name: mixed
objective: min
domains:
  d2: {values: [0, 1]}
  d3: {values: [0, 1, 2]}
variables:
  a: {domain: d3}
  b: {domain: d3}
  c: {domain: d2}
  e: {domain: d3, cost_function: 0.5 * e}
constraints:
  u1: {type: intention, function: "a * 2"}
  u2: {type: intention, function: "3 if c == 1 else 0"}
  p1: {type: intention, function: "10 if a == b else abs(a - c)"}
  p2: {type: intention, function: "2 * (b + e) % 3"}
  p3: {type: extensional, variables: [c, e], default: 1,
       values: {0: "0 0 | 1 1"}}
  t1: {type: intention, function: "a + b + c if a != b else 7"}
  t2: {type: intention, function: "abs(a - b) + 2 * abs(b - e)"}
agents: [a1]
"""


def load_both(name_or_yaml):
    """The same problem loaded by each package's own YAML loader."""
    if name_or_yaml.lstrip().startswith("name:"):
        return (jax_yaml.load_dcop(name_or_yaml),
                torch_yaml.load_dcop(name_or_yaml))
    path = os.path.join(INSTANCES, name_or_yaml)
    return (jax_yaml.load_dcop_from_file(path),
            torch_yaml.load_dcop_from_file(path))


def build_coloring(objects, relations, dcop_mod, n_vars: int,
                   seed: int = 0, n_colors: int = 3):
    """The bench.py build_dcop construction (cost-1 equality penalty per
    edge, ~1.5 edges per variable), built from one package's objects."""
    rng = np.random.default_rng(seed)
    dom = objects.Domain("colors", "color", list(range(n_colors)))
    dcop = dcop_mod.DCOP(f"gc_{n_vars}", objective="min")
    variables = [objects.Variable(f"v{i}", dom) for i in range(n_vars)]
    for v in variables:
        dcop.add_variable(v)
    eq = np.eye(n_colors, dtype=np.float64)
    seen = set()
    k = 0
    for _ in range(int(n_vars * 1.5)):
        i, j = rng.choice(n_vars, size=2, replace=False)
        key = (min(i, j), max(i, j))
        if key in seen:
            continue
        seen.add(key)
        dcop.add_constraint(relations.NAryMatrixRelation(
            [variables[i], variables[j]], eq, f"c{k}"))
        k += 1
    return dcop


def build_coloring_both(n_vars: int, seed: int = 0):
    import pydcop_tpu.dcop.dcop as jd
    import pydcop_tpu.dcop.objects as jo
    import pydcop_tpu.dcop.relations as jr
    import pydcop_tpu_torch.dcop.dcop as td
    import pydcop_tpu_torch.dcop.objects as to
    import pydcop_tpu_torch.dcop.relations as tr

    return (build_coloring(jo, jr, jd, n_vars, seed),
            build_coloring(to, tr, td, n_vars, seed))


def assert_same_compile(jax_dcop, torch_dcop, **kw):
    g1, m1 = jax_compile(jax_dcop, **kw)
    g2, m2 = torch_compile(torch_dcop, **kw)
    for name in ("var_costs", "var_valid"):
        a, b = getattr(g1, name), getattr(g2, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(g1.buckets) == len(g2.buckets)
    for b1, b2 in zip(g1.buckets, g2.buckets):
        assert b1.costs.dtype == b2.costs.dtype
        assert b1.var_ids.dtype == b2.var_ids.dtype
        np.testing.assert_array_equal(b1.costs, b2.costs)
        np.testing.assert_array_equal(b1.var_ids, b2.var_ids)
    for field in ("var_names", "domains", "factor_names", "bucket_sizes",
                  "mode", "constant_cost"):
        assert getattr(m1, field) == getattr(m2, field), field
    np.testing.assert_array_equal(m1.var_base_costs, m2.var_base_costs)
    for field in AGG_FIELDS:
        a, b = getattr(g1, field), getattr(g2, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
    return g2


AGG_FIELDS = ("agg_perm", "agg_sorted_seg", "agg_starts", "agg_ends",
              "agg_ell")


@pytest.mark.parametrize("noise", [0.0, 0.01])
@pytest.mark.parametrize("fixture", FIXTURES)
def test_fixture_compiles_identically(fixture, noise):
    assert_same_compile(*load_both(fixture), noise_level=noise)


@pytest.mark.parametrize("noise,pad_to", [(0.0, 1), (0.01, 1), (0.02, 4)])
def test_mixed_arity_compiles_identically(noise, pad_to):
    graph = assert_same_compile(*load_both(MIXED_YAML), noise_level=noise,
                                pad_to=pad_to)
    assert [b.arity for b in graph.buckets] == [1, 2, 3]
    assert (graph.buckets[2].costs == np.float32(1e9)).any()


def test_seeded_noise_compiles_identically():
    assert_same_compile(*load_both("coloring_12_3.yml"), noise_level=0.05,
                        noise_seed=11)


def test_bench_style_instance_compiles_identically():
    assert_same_compile(*build_coloring_both(300), noise_level=0.01)


@pytest.mark.parametrize("aggregation", ["sorted", "boundary", "ell"])
@pytest.mark.parametrize("fixture", ["coloring_12_3.yml", "loft_scene.yml",
                                     "secp_lamps.yaml", MIXED_YAML])
def test_aggregation_arrays_compile_identically(fixture, aggregation):
    g = assert_same_compile(*load_both(fixture), noise_level=0.01,
                            aggregation=aggregation, use_cache=False)
    set_fields = {f for f in AGG_FIELDS if getattr(g, f) is not None}
    assert set_fields == {
        "sorted": {"agg_perm", "agg_sorted_seg"},
        "boundary": {"agg_perm", "agg_starts", "agg_ends"},
        "ell": {"agg_ell"}}[aggregation]


@pytest.mark.parametrize("aggregation", ["sorted", "boundary", "ell"])
@pytest.mark.parametrize("n_buckets", [2, 3, 4])
def test_aggregation_arrays_of_padded_multi_bucket_graphs(aggregation,
                                                          n_buckets):
    """Buckets of arity 1..n with a tenth of their rows padding (the
    sentinel V), through each package's own builder."""
    rng = np.random.default_rng(n_buckets)
    n_vars = 50
    ids = []
    for arity in range(1, n_buckets + 1):
        f = int(rng.integers(20, 60))
        b = rng.integers(0, n_vars, size=(f, arity)).astype(np.int32)
        b[-(f // 10):] = n_vars
        ids.append(b)
    ref = JC.build_aggregation_arrays(
        [JC.FactorBucket(np.zeros(0, np.float32), b) for b in ids],
        n_vars + 1, aggregation)
    out = TC.build_aggregation_arrays(
        [TC.FactorBucket(np.zeros(0, np.float32), b) for b in ids],
        n_vars + 1, aggregation)
    for a, b in zip(ref, out):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if aggregation == "ell":
        # The sentinel row keeps an all-dummy list.
        assert (out[4][-1] == sum(b.size for b in ids)).all()


def _hub_buckets(module, n_vars, n_factors):
    ids = np.zeros((n_factors, 2), np.int32)
    ids[:, 1] = np.arange(n_factors) % (n_vars - 1) + 1
    return (module.FactorBucket(np.zeros(0, np.float32), ids),)


@pytest.mark.parametrize("n_vars,n_factors,refused", [
    (2_000_000, 600_000, True),      # the reference's own hub-guard case
    (1_500_000, 400_000, True),
    (1_000, 900, False),
])
def test_ell_hub_guard_refuses_the_same_graphs(n_vars, n_factors, refused):
    def build(module):
        try:
            module.build_aggregation_arrays(
                _hub_buckets(module, n_vars, n_factors), n_vars + 1, "ell")
        except ValueError as e:
            return str(e)
        return None

    ref, out = build(JC), build(TC)
    assert out == ref
    assert (out is not None) == refused
    if refused:
        assert "hub" in out


def test_unknown_aggregation_is_refused_like_the_reference():
    ids = (TC.FactorBucket(np.zeros(0, np.float32),
                           np.zeros((3, 2), np.int32)),)
    with pytest.raises(ValueError) as err:
        TC.build_aggregation_arrays(ids, 4, "nope")
    with pytest.raises(ValueError) as ref:
        JC.build_aggregation_arrays(ids, 4, "nope")
    assert str(err.value) == str(ref.value)
    with pytest.raises(ValueError):
        torch_compile(load_both("coloring_chain.yaml")[1],
                      aggregation="nope")


@pytest.mark.parametrize("aggregation", ["scatter", "sorted", "ell",
                                         "auto", "boundary"])
@pytest.mark.parametrize("pad_to", [1, 2, 8])
def test_validated_aggregation_equals_reference(aggregation, pad_to):
    params = {"aggregation": aggregation}

    def run(module):
        try:
            return module.validated_aggregation(params, pad_to)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(TC) == run(JC)
    assert TC.validated_aggregation({}, pad_to) == "scatter"


def test_prune_constants_and_width_equal_reference():
    for name in ("PRUNE_WIDTH_DIVISOR", "PRUNE_WIDTH_CAP",
                 "PRUNE_MIN_DOMAIN", "AGGREGATIONS", "AUTO_AGGREGATION"):
        assert getattr(TC, name) == getattr(JC, name), name
    for d in range(1, 300):
        assert TC.prune_width(d) == JC.prune_width(d), d


def test_compile_cache_counts_hits_and_layout_builds(monkeypatch):
    monkeypatch.setattr(TC, "compile_cache", TC.CompileCache(maxsize=2))
    cache = TC.compile_cache
    dcop = load_both("coloring_12_3.yml")[1]
    g1, _ = torch_compile(dcop, aggregation="ell")
    assert cache.stats() == {"hits": 0, "misses": 1, "layout_builds": 1,
                             "entries": 1}
    g2, _ = torch_compile(dcop, aggregation="ell", noise_level=0.5)
    assert cache.stats()["hits"] == 1
    assert cache.stats()["layout_builds"] == 1
    # The layout is shared and frozen; the costs are not.
    assert g2.agg_ell is g1.agg_ell and not g1.agg_ell.flags.writeable
    assert g2.buckets[0].var_ids is g1.buckets[0].var_ids
    assert not np.array_equal(g1.var_costs, g2.var_costs)
    # Another aggregation or pad_to is another structure.
    torch_compile(dcop, aggregation="sorted")
    torch_compile(dcop, aggregation="sorted", pad_to=4)
    assert cache.stats()["layout_builds"] == 3
    assert cache.stats()["entries"] == 2          # LRU bound
    # use_cache=False builds without touching the entries.
    torch_compile(dcop, use_cache=False)
    assert cache.stats()["layout_builds"] == 4
    assert cache.stats()["misses"] == 3
    monkeypatch.setenv("PYDCOP_COMPILE_CACHE", "0")
    torch_compile(dcop, aggregation="sorted", pad_to=4)
    assert cache.stats()["layout_builds"] == 5
    cache.clear()
    assert cache.stats() == {"hits": 0, "misses": 0, "layout_builds": 0,
                             "entries": 0}


def test_cached_compile_equals_uncached_and_reference():
    jax_dcop, torch_dcop = build_coloring_both(120, seed=2)
    first = assert_same_compile(jax_dcop, torch_dcop, noise_level=0.01,
                                aggregation="sorted")
    again = assert_same_compile(jax_dcop, torch_dcop, noise_level=0.01,
                                aggregation="sorted")
    fresh = assert_same_compile(jax_dcop, torch_dcop, noise_level=0.01,
                                aggregation="sorted", use_cache=False)
    for field in ("agg_perm", "agg_sorted_seg"):
        np.testing.assert_array_equal(getattr(again, field),
                                      getattr(fresh, field))
    assert again.agg_perm is first.agg_perm
