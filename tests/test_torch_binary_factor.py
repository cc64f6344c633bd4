"""The port's binary-factor update (pydcop_tpu_torch/ops/binary_factor.py)
against the JAX reference.

- The plain version equals ``pydcop_tpu.ops.maxsum.factor_to_var`` on the
  same bucket EXACTLY: it keeps the dense path's add order.
- It matches the Pallas kernel (``binary_factor_update(...,
  interpret=True)``) at rtol = atol = 1e-6, the tolerance of
  tests/unit/test_pallas_maxsum.py (the Pallas form adds in another
  order), on that file's cases and closed form.
- The wrapper refuses what the CUDA kernel does not take, and keeps NaN
  visible like ``jnp.min``.
- The CUDA kernel itself runs only on a card: the ``gpu`` test compares
  it with the plain version there and skips elsewhere.
"""

import jax  # noqa: F401  (imported first: JAX stays on the CPU)
import numpy as np
import pytest
import torch

from pydcop_tpu.dcop.objects import Domain, Variable
from pydcop_tpu.dcop.relations import NAryMatrixRelation
from pydcop_tpu.engine.compile import compile_factor_graph
from pydcop_tpu.ops import maxsum as jax_ops
from pydcop_tpu.ops.pallas_maxsum import binary_factor_update as pallas_update
from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops.binary_factor import (
    binary_factor_update,
    binary_factor_update_reference,
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


CASES = [
    (7, 3, 0),        # smaller than one lane block
    (128, 3, 1),      # exactly one block
    (300, 5, 2),      # multiple blocks + padding remainder
    (50, 8, 3),       # largest SECP-style domain
]


def _bucket(n_factors: int, d: int, seed: int, mixed_domains=False):
    """One compiled binary bucket and random messages.  With
    ``mixed_domains`` half the variables have a smaller domain, so the
    compiled tables carry BIG on padded slots."""
    rng = np.random.default_rng(seed)
    dom = Domain("d", "", list(range(d)))
    small = Domain("s", "", list(range(max(1, d - 2))))
    n_vars = max(4, n_factors // 2)
    vs = [Variable(f"v{i}", small if mixed_domains and i % 2 else dom)
          for i in range(n_vars)]
    cs = []
    for k in range(n_factors):
        i, j = rng.choice(n_vars, size=2, replace=False)
        table = rng.normal(size=(len(vs[i].domain), len(vs[j].domain)))
        cs.append(NAryMatrixRelation([vs[i], vs[j]], table, f"c{k}"))
    graph, _ = compile_factor_graph(vs, cs)
    assert len(graph.buckets) == 1 and graph.buckets[0].arity == 2
    msgs = rng.normal(size=(graph.buckets[0].n_factors, 2, d)).astype(
        np.float32)
    return graph, msgs


def _plain(costs, msgs):
    return binary_factor_update_reference(
        torch.from_numpy(np.array(costs)), torch.from_numpy(msgs)).numpy()


@pytest.mark.parametrize("n_factors,d,seed", CASES)
@pytest.mark.parametrize("mixed_domains", [False, True])
def test_plain_equals_jax_factor_to_var(n_factors, d, seed, mixed_domains):
    graph, msgs = _bucket(n_factors, d, seed, mixed_domains)
    if mixed_domains:
        assert (graph.buckets[0].costs == np.float32(1e9)).any()
    ref = np.asarray(jax_ops.factor_to_var(graph, (msgs,))[0])
    np.testing.assert_array_equal(_plain(graph.buckets[0].costs, msgs), ref)


@pytest.mark.parametrize("n_factors,d,seed", CASES)
def test_plain_matches_pallas_interpret(n_factors, d, seed):
    graph, msgs = _bucket(n_factors, d, seed)
    pallas = np.asarray(pallas_update(
        graph.buckets[0].costs, msgs, interpret=True))
    np.testing.assert_allclose(_plain(graph.buckets[0].costs, msgs), pallas,
                               rtol=1e-6, atol=1e-6)


def test_zero_messages_give_row_minima():
    """With no incoming messages the update is the plain table min —
    an independently checkable closed form."""
    graph, msgs = _bucket(20, 4, 5)
    costs = np.asarray(graph.buckets[0].costs)
    out = _plain(costs, np.zeros_like(msgs))
    pallas = np.asarray(pallas_update(
        costs, np.zeros_like(msgs), interpret=True))
    np.testing.assert_allclose(out[:, 0, :], costs.min(axis=2), rtol=1e-6)
    np.testing.assert_allclose(out[:, 1, :], costs.min(axis=1), rtol=1e-6)
    np.testing.assert_allclose(out, pallas, rtol=1e-6, atol=1e-6)


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    graph, msgs = _bucket(30, 3, 7)
    costs = torch.from_numpy(np.array(graph.buckets[0].costs))
    before = _build.launch_counts["binary_factor_update"]
    out = binary_factor_update(costs, torch.from_numpy(msgs))
    assert torch.equal(out, binary_factor_update_reference(
        costs, torch.from_numpy(msgs)))
    assert _build.launch_counts["binary_factor_update"] == before


@pytest.mark.parametrize("bad", [
    "dtype", "costs_shape", "msgs_shape", "not_square", "non_contiguous",
])
def test_wrapper_refuses(bad):
    costs = torch.zeros((4, 3, 3))
    msgs = torch.zeros((4, 2, 3))
    if bad == "dtype":
        costs = costs.double()
        err = TypeError
    elif bad == "costs_shape":
        costs = torch.zeros((4, 9))
        err = ValueError
    elif bad == "msgs_shape":
        msgs = torch.zeros((4, 3, 3))
        err = ValueError
    elif bad == "not_square":
        costs = torch.zeros((4, 3, 2))
        err = ValueError
    else:
        costs = torch.zeros((3, 3, 4)).transpose(0, 2)
        assert costs.shape == (4, 3, 3) and not costs.is_contiguous()
        err = ValueError
    with pytest.raises(err):
        binary_factor_update(costs, msgs)


def test_nan_propagates_like_jnp_min():
    graph, msgs = _bucket(10, 3, 9)
    msgs = msgs.copy()
    msgs[2, 0, 1] = np.nan    # reaches every output of factor 2's p=1 side
    msgs[5, 1, 0] = np.nan    # and of factor 5's p=0 side
    costs = np.array(graph.buckets[0].costs)
    costs[7, 1, 2] = np.nan
    ref = np.asarray(jax_ops.factor_to_var(
        graph._replace(buckets=(graph.buckets[0]._replace(costs=costs),)),
        (msgs,))[0])
    out = _plain(costs, msgs)
    np.testing.assert_array_equal(out, ref)   # NaNs in the same places
    assert np.isnan(out[2, 1]).all() and np.isnan(out[5, 0]).all()
    assert np.isnan(out[7, 0, 1]) and np.isnan(out[7, 1, 2])
    assert not np.isnan(out[0]).any()


@pytest.mark.gpu
def test_cuda_kernel_equals_plain_version():
    """On the card: kernel and plain version agree bit for bit (same add
    order, no FMA), and each call counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n_factors, d, seed in CASES:
        graph, msgs = _bucket(n_factors, d, seed, mixed_domains=True)
        costs = torch.tensor(np.array(graph.buckets[0].costs), device="cuda")
        v2f = torch.tensor(msgs, device="cuda")
        before = _build.launch_counts["binary_factor_update"]
        out = binary_factor_update(costs, v2f)
        torch.cuda.synchronize()
        assert _build.launch_counts["binary_factor_update"] == before + 1
        assert torch.equal(out, binary_factor_update_reference(costs, v2f))
