"""The port's MGM and MGM2 steps (pydcop_tpu_torch/ops/mgm.py, mgm2.py)
against ``pydcop_tpu.ops.mgm`` / ``mgm2`` on the CPU, state by state.

From the same seed, the port's state (values, key words, cycle) equals
the reference's after ``init_state`` and after every one of 40 steps
(``np.array_equal``; the reference's step jitted with the graph as an
argument): MGM with both break modes, MGM2 with every ``favor`` and the
thresholds 0, 0.5 and 1, under ``scatter`` and ``ell``, on the integer
colouring problem and the mixed real-cost problem of arity 1-3 of
``test_torch_dsa.py``.  ``_fix_two_axes`` equals the reference's at
every (p, q) of arity 2-4 buckets, and ``_drop_index`` reproduces
``x.at[idx].set(v, mode="drop")`` with repeated indices: XLA:CPU keeps
the last update, so does the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.algorithms.mgm import lexic_ranks as j_lexic_ranks
from pydcop_tpu.ops import mgm as JM
from pydcop_tpu.ops import mgm2 as J2
from pydcop_tpu_torch.algorithms.mgm import lexic_ranks
from pydcop_tpu_torch.engine.convert import localsearch_state_from_numpy
from pydcop_tpu_torch.ops import mgm as TM
from pydcop_tpu_torch.ops import mgm2 as T2
from test_torch_dsa import assert_same_state, graphs
from test_torch_localsearch import arrays, both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CYCLES = 40


@pytest.mark.parametrize("problem", ["coloring", "mixed_real"])
@pytest.mark.parametrize("aggregation", ["scatter", "ell"])
@pytest.mark.parametrize("break_mode", ["lexic", "random"])
def test_mgm_state_equals_reference_every_step(problem, aggregation,
                                               break_mode):
    jg, tg, meta = graphs(problem, aggregation)
    ranks = j_lexic_ranks(meta)
    np.testing.assert_array_equal(lexic_ranks(meta), ranks)
    t_ranks = torch.tensor(ranks)
    jstate, tstate = JM.init_state(jg, 7), TM.init_state(tg, 7)
    assert_same_state(tstate, jstate)
    step = jax.jit(lambda s, g: JM.mgm_step(
        s, g, lexic_ranks=jnp.asarray(ranks), break_mode=break_mode))
    for _ in range(CYCLES):
        jstate = step(jstate, jg)
        tstate = TM.mgm_step(tstate, tg, lexic_ranks=t_ranks,
                             break_mode=break_mode)
        assert_same_state(tstate, jstate)


MGM2_CASES = [
    ("coloring", "scatter", "unilateral", 0.5),
    ("coloring", "scatter", "no", 0.5),
    ("coloring", "scatter", "coordinated", 0.5),
    ("coloring", "ell", "coordinated", 0.5),
    ("mixed_real", "scatter", "unilateral", 0.5),
    ("mixed_real", "scatter", "no", 0.3),
    ("mixed_real", "scatter", "coordinated", 0.5),
    ("mixed_real", "ell", "no", 0.5),
    ("mixed_real", "scatter", "unilateral", 0.0),
    ("mixed_real", "scatter", "coordinated", 1.0),
]


@pytest.mark.parametrize("problem,aggregation,favor,threshold",
                         MGM2_CASES)
def test_mgm2_state_equals_reference_every_step(problem, aggregation,
                                                favor, threshold):
    jg, tg, meta = graphs(problem, aggregation)
    ranks = j_lexic_ranks(meta)
    t_ranks = torch.tensor(ranks)
    jstate, tstate = J2.init_state(jg, 5), T2.init_state(tg, 5)
    assert_same_state(tstate, jstate)
    step = jax.jit(lambda s, g: J2.mgm2_step(
        s, g, threshold=threshold, favor=favor,
        lexic_ranks=jnp.asarray(ranks)))
    for _ in range(CYCLES):
        jstate = step(jstate, jg)
        tstate = T2.mgm2_step(tstate, tg, threshold=threshold, favor=favor,
                              lexic_ranks=t_ranks)
        assert_same_state(tstate, jstate)


def test_run_mgm2_and_converter_equal_reference():
    jg, tg, meta = graphs("mixed_real", "scatter")
    ranks = j_lexic_ranks(meta)
    ref = jax.jit(lambda g: J2.run_mgm2(g, 15, favor="no",
                                        lexic_ranks=jnp.asarray(ranks),
                                        seed=2))(jg)
    values, cost, cycles = T2.run_mgm2(tg, 15, favor="no",
                                       lexic_ranks=ranks, seed=2)
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref[0]))
    assert cycles == int(ref[2]) == 15
    assert cost.dtype == torch.float32
    assert cost.numpy().tobytes() == np.asarray(ref[1]).tobytes()
    jstate = J2.init_state(jg, 9)
    tstate = localsearch_state_from_numpy(
        "mgm2", np.asarray(jstate.values), np.asarray(jstate.key), 0,
        device="cpu")
    assert isinstance(tstate, T2.Mgm2State)
    assert_same_state(tstate, jstate)
    ref = jax.jit(lambda g: JM.run_mgm(g, 12, lexic_ranks=jnp.asarray(
        ranks), break_mode="random", seed=4))(jg)
    values, _, cycles = TM.run_mgm(tg, 12, lexic_ranks=ranks,
                                   break_mode="random", seed=4)
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref[0]))
    assert cycles == 12


def test_fix_two_axes_equals_reference():
    arr = arrays(8, 40, 3, [(2, 30), (3, 20), (4, 10)])
    jg, tg = both(*arr, "scatter")
    values = np.random.default_rng(1).integers(0, 3, 41).astype(np.int32)
    for jb, tb in zip(jg.buckets, tg.buckets):
        arity = jb.var_ids.shape[1]
        for p in range(arity):
            for q in range(arity):
                if p == q:
                    continue
                ref = J2._fix_two_axes(jb.costs, jb.var_ids, values, p, q)
                out = T2._fix_two_axes(tb.costs, tb.var_ids,
                                       torch.tensor(values), p, q)
                np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", range(4))
def test_drop_index_keeps_the_last_update_like_xla(seed):
    """Scatter-sets with repeated and dropped indices: XLA:CPU (jitted,
    mode="drop") keeps each index's last update; so does the port."""
    rng = np.random.default_rng(seed)
    n, m = 9, 40
    idx = rng.integers(0, n, size=m)
    keep = rng.random(m) < 0.7
    vals = rng.integers(0, 1000, size=m).astype(np.int32)
    base = np.full(n, -1, np.int32)
    ref = jax.jit(lambda b, i, k, v: b.at[jnp.where(k, i, n)].set(
        v, mode="drop"))(base, idx, keep, vals)
    out = torch.cat([torch.tensor(base), torch.tensor([-1],
                                                      dtype=torch.int32)])
    out[T2._drop_index(torch.tensor(idx), torch.tensor(keep), n)] = (
        torch.tensor(vals))
    np.testing.assert_array_equal(out[:n].numpy(), np.asarray(ref))
