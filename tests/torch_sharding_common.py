"""Shared helpers of the partitioned engine's parity tests
(``tests/test_torch_partition.py``, ``test_torch_sharding*.py``,
``test_torch_shardloss.py``): the same problem built in both packages
from one seed, both packages' partitioned engines on the CPU, and the
state-by-state comparison.

The reference runs on the repo's 8-device CPU mesh (root
``conftest.py``); the port's ``partitioned_mesh`` counts the CPU as the
same 8 devices (``engine.sharding.host_device_count``).
"""

from functools import partial

import jax
import numpy as np

from pydcop_tpu.algorithms.maxsum import build_engine as jax_build_engine
from pydcop_tpu.dcop.dcop import DCOP as JDCOP
from pydcop_tpu.dcop.objects import AgentDef as JAgentDef
from pydcop_tpu.dcop.objects import Domain as JDomain
from pydcop_tpu.dcop.objects import Variable as JVariable
from pydcop_tpu.dcop.relations import NAryMatrixRelation as JRel
from pydcop_tpu_torch.algorithms.maxsum import build_engine
from pydcop_tpu_torch.dcop.dcop import DCOP as TDCOP
from pydcop_tpu_torch.dcop.objects import AgentDef as TAgentDef
from pydcop_tpu_torch.dcop.objects import Domain as TDomain
from pydcop_tpu_torch.dcop.objects import Variable as TVariable
from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation as TRel
from pydcop_tpu_torch.utils.tree import tree_leaves

J = (JDCOP, JAgentDef, JDomain, JVariable, JRel)
T = (TDCOP, TAgentDef, TDomain, TVariable, TRel)


def _table(rng, shape, decades, scale=1.0):
    """A cost table: integers 0..9 (``decades=None``, exact float32
    sums) or signed floats over ``decades`` decades of magnitude, times
    ``scale`` (1e-36 puts the messages among float32's subnormals)."""
    if decades is None:
        return rng.integers(0, 10, size=shape).astype(np.float64)
    return (rng.uniform(-1.0, 1.0, shape)
            * 10.0 ** rng.uniform(0.0, decades, shape)) * scale


def _problem(mods, name, n_vars, d, factors, decades, seed, scale=1.0):
    """A DCOP over ``n_vars`` variables of domain ``d`` with one table
    factor per scope of ``factors`` (drawn in order from one rng)."""
    dcop_cls, agent_cls, dom_cls, var_cls, rel_cls = mods
    rng = np.random.default_rng(seed)
    dom = dom_cls("d", "", list(range(d)))
    dcop = dcop_cls(name, objective="min")
    vs = [var_cls(f"v{i}", dom) for i in range(n_vars)]
    for v in vs:
        dcop.add_variable(v)
    for k, scope in enumerate(factors):
        table = _table(rng, (d,) * len(scope), decades, scale)
        dcop.add_constraint(rel_cls([vs[i] for i in scope], table,
                                    name=f"c{k}"))
    dcop.add_agents([agent_cls("a0")])
    return dcop


def grid_scopes(side):
    out = []
    for r in range(side):
        for c in range(side):
            i = r * side + c
            for rr, cc in ((r + 1, c), (r, c + 1)):
                if rr < side and cc < side:
                    out.append((i, rr * side + cc))
    return out


def loopy_scopes(n, m, seed):
    rng = np.random.default_rng(seed + 1000)
    seen, out = set(), []
    while len(out) < m:
        i, j = (int(x) for x in rng.choice(n, size=2, replace=False))
        key = (min(i, j), max(i, j))
        if key not in seen:
            seen.add(key)
            out.append(key)
    return out


def mixed_scopes(n):
    """Unary + binary ring + ternary factors (the reference battery's
    mixed-arity shape)."""
    out = [(i,) for i in range(n)]
    out += [(i, (i + 1) % n) for i in range(n)]
    out += [(i, (i + 1) % n, (i + 2) % n) for i in range(0, n, 3)]
    return out


def nocut_scopes(half):
    """Two disjoint rings of ``half`` variables each: two shards
    partition them with no cut edge."""
    ring = [(i, (i + 1) % half) for i in range(half)]
    return ring + [(half + i, half + j) for i, j in ring]


def both(make, *args, **kw):
    """The same problem in both packages: (reference DCOP, port DCOP)."""
    return make(J, *args, **kw), make(T, *args, **kw)


def _grid(mods, side, decades=3, seed=0, d=3, scale=1.0):
    return _problem(mods, f"grid_{side}", side * side, d,
                    grid_scopes(side), decades, seed, scale)


def _loopy(mods, n=24, m=36, decades=3, seed=0, d=3):
    return _problem(mods, "loopy", n, d, loopy_scopes(n, m, seed),
                    decades, seed)


def _mixed(mods, n=12, decades=3, seed=0, d=3):
    return _problem(mods, "mixed", n, d, mixed_scopes(n), decades, seed)


def _nocut(mods, half=8, decades=3, seed=0, d=3):
    return _problem(mods, "nocut", 2 * half, d, nocut_scopes(half),
                    decades, seed)


def binary_ternary_scopes(n, components=1):
    """``components`` disjoint rings of ``n`` variables, each with a
    binary factor and a ternary factor at every variable: the belief
    sum's fold ends on the ternary bucket summed on its own."""
    out = []
    for c in range(components):
        off = c * n
        out += [(off + i, off + (i + 1) % n) for i in range(n)]
        out += [(off + i, off + (i + 1) % n, off + (i + 2) % n)
                for i in range(n)]
    return out


def _binary_ternary(mods, n=12, components=1, decades=3, seed=0, d=3):
    return _problem(mods, "bt", n * components, d,
                    binary_ternary_scopes(n, components), decades, seed)


def binary_ternary_both(n=12, components=1, decades=3, seed=0, d=3):
    return both(_binary_ternary, n=n, components=components,
                decades=decades, seed=seed, d=d)


def _free(mods, n=8, d=3):
    return _problem(mods, "free", n, d, [], None, 0)


def grid_both(side, decades=3, seed=0, d=3, scale=1.0):
    return both(_grid, side, decades=decades, seed=seed, d=d,
                scale=scale)


def loopy_both(n=24, m=36, decades=3, seed=0, d=3):
    return both(_loopy, n=n, m=m, decades=decades, seed=seed, d=d)


def mixed_both(n=12, decades=3, seed=0, d=3):
    return both(_mixed, n=n, decades=decades, seed=seed, d=d)


def nocut_both(half=8, decades=3, seed=0):
    return both(_nocut, half=half, decades=decades, seed=seed)


def free_both(n=8):
    return both(_free, n=n)


def engines(jdcop, tdcop, shards, params=None):
    """(reference engine, port engine), each built by its package's
    ``build_engine(..., shards=shards)`` (the port's on the CPU)."""
    params = dict(params or {})
    return (jax_build_engine(jdcop, params, shards=shards),
            build_engine(tdcop, params, shards=shards, device="cpu"))


def solver_kw(engine):
    return dict(damping=engine.damping, damp_vars=engine.damp_vars,
                damp_factors=engine.damp_factors,
                stability=engine.stability)


def assert_same_leaves(jstate, tstate, where=""):
    """Every leaf of the two states (messages, counts, halo, stable,
    cycle) equal bit for bit, shape and dtype included."""
    jl = jax.tree_util.tree_leaves(jstate)
    tl = tree_leaves(tstate)
    assert len(jl) == len(tl), where
    for i, (a, b) in enumerate(zip(jl, tl)):
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.dtype == b.dtype, (where, i, a.dtype, b.dtype)
        assert a.shape == b.shape, (where, i, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), (
            where, i, int(np.sum(a != b)))


def compare_cycles(jeng, teng, cycles, prune=False):
    """Run both engines one cycle at a time from zero messages and hold
    every leaf of the state and the selected values equal after each
    cycle (the reference jitted with the graph as an argument, as its
    engine runs it)."""
    kw = solver_kw(teng)
    step = jax.jit(partial(jeng._ops.run_maxsum_from, extra_cycles=1,
                           stop_on_convergence=False, prune=prune, **kw))
    jst = jeng._ops.init_state(jeng.graph)
    tst = teng._ops.init_state(teng.graph)
    assert_same_leaves(jst, tst, "init")
    for c in range(cycles):
        jst, jv = step(jeng.graph, jst)
        tst, tv = teng._ops.run_maxsum_from(
            teng.graph, tst, 1, stop_on_convergence=False, prune=prune,
            **kw)
        assert_same_leaves(jst, tst, f"cycle {c + 1}")
        assert np.array_equal(np.asarray(jv), tv.numpy()), c + 1
    return jst, tst
