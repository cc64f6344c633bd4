"""The cross-shard reduction (pydcop_tpu_torch/ops/halo_sum.py) and the
boundary partial (``ops/segment_sum.py::subset_sum``) against the
reference's collectives, on the CPU.

Tolerance: none.  The reference's ``jax.lax.psum`` across a
``shard_map`` over the repo's 8 forced CPU devices is run on drawn
``[S, B, D]`` float32 partials — over 1, 3 and 6 decades, with signed
zeros, and among the subnormals — and on S scalars (the traced cost's
reduction), at S = 2..8; ``halo_sum`` (its plain version on CPU tensors)
gives the same bits.  ``subset_sum`` equals the reference's
``jax.ops.segment_sum`` over gathered boundary edges
(``pydcop_tpu/engine/sharding.py:438``), in jit, bit for bit.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from pydcop_tpu_torch.ops.halo_sum import halo_sum, halo_sum_reference
from pydcop_tpu_torch.ops.segment_sum import aggregation_plan, subset_sum

TINY = np.finfo(np.float32).tiny


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_PSUM = {}


def reference_psum(parts: np.ndarray) -> np.ndarray:
    """The reference's ``psum`` of ``parts[s]`` across an S-device
    mesh (jitted, as inside its superstep)."""
    s = parts.shape[0]
    if s not in _PSUM:
        mesh = Mesh(np.array(jax.devices()[:s]), ("shard",))
        _PSUM[s] = jax.jit(shard_map(
            lambda x: jax.lax.psum(x[0], "shard"), mesh=mesh,
            in_specs=P("shard"), out_specs=P(), check_rep=False))
    return np.asarray(_PSUM[s](parts))


def draw(shape, decades, seed, low=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.uniform(-1.0, 1.0, shape)
         * 10.0 ** rng.uniform(low, low + decades, shape))
    return x.astype(np.float32)


def bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("decades", [1, 3, 6])
@pytest.mark.parametrize("shards", [2, 3, 4, 5, 8])
def test_halo_sum_equals_the_reference_psum(shards, decades):
    for seed in range(6):
        parts = draw((shards, 37, 3), decades, seed + 10 * shards)
        ref = reference_psum(parts)
        out = halo_sum(torch.from_numpy(parts))
        assert np.array_equal(bits(out.numpy()), bits(ref))
        listed = halo_sum([torch.from_numpy(p) for p in parts])
        assert np.array_equal(bits(listed.numpy()), bits(ref))


@pytest.mark.parametrize("shards", [2, 3, 4, 8])
def test_subnormal_and_signed_zero_partials(shards):
    """Subnormal operands read as zeros of their sign and subnormal
    results flush; the sum starts from +0.0, so an all -0.0 element
    sums to +0.0."""
    for seed in range(4):
        parts = draw((shards, 256, 3), 10, seed, low=-45.0)
        parts[:, :8] = -0.0
        parts[1:, 8:16] = 0.0
        parts[:, 16:24] = np.float32(1.5) * TINY * np.sign(
            parts[:, 16:24])
        ref = reference_psum(parts)
        out = halo_sum_reference(torch.from_numpy(parts)).numpy()
        assert np.array_equal(bits(out), bits(ref))
        assert not np.any(np.signbit(out[:8]))
        assert np.any((parts != 0) & (np.abs(parts) < TINY))


@pytest.mark.parametrize("shards", [2, 3, 8])
def test_scalar_costs_equal_the_reference_psum(shards):
    """The traced cost's reduction: one scalar a shard."""
    for seed in range(40):
        parts = draw((shards,), 4, seed)
        ref = reference_psum(parts)
        out = halo_sum([torch.from_numpy(p.reshape(1)) for p in parts])
        assert bits(out.numpy()[0]) == bits(ref)


def test_halo_sum_checks_its_inputs():
    with pytest.raises(ValueError, match="at least one"):
        halo_sum([])
    with pytest.raises(TypeError, match="float32"):
        halo_sum([torch.zeros(3, dtype=torch.float64)] * 2)
    with pytest.raises(ValueError, match="shapes"):
        halo_sum([torch.zeros(3), torch.zeros(4)])
    with pytest.raises(ValueError, match="at most 64"):
        halo_sum(torch.zeros(65, 2))
    empty = halo_sum(torch.zeros(3, 0, 3))
    assert tuple(empty.shape) == (0, 3)


def _boundary_case(seed, n_bnd=7, d=3, decades=6):
    """Two buckets of f2v messages, a drawn subset of edges with a
    boundary index each (and padding entries at index B), as the
    reference's per-shard arrays."""
    rng = np.random.default_rng(seed)
    f2v = (draw((9, 2, d), decades, seed), draw((4, 3, d), decades,
                                                seed + 1))
    n_edges = 9 * 2 + 4 * 3
    picked = np.sort(rng.choice(n_edges, size=17, replace=False))
    seg = rng.integers(0, n_bnd, size=picked.shape[0])
    idx = np.concatenate([picked, np.zeros(3, np.int64)])
    seg = np.concatenate([seg, np.full(3, n_bnd)])
    return f2v, idx.astype(np.int32), seg.astype(np.int32)


@pytest.mark.parametrize("seed", range(6))
def test_subset_sum_equals_the_reference_partial(seed):
    n_bnd, d = 7, 3
    f2v, idx, seg = _boundary_case(seed, n_bnd, d)

    @partial(jax.jit, static_argnums=3)
    def ref_partial(msgs, idx, seg, n_boundary):
        flat = jnp.concatenate([m.reshape(-1, d) for m in msgs], 0)
        return jax.ops.segment_sum(flat[idx], seg,
                                   num_segments=n_boundary + 1)[:n_boundary]

    ref = np.asarray(ref_partial(tuple(jnp.asarray(m) for m in f2v),
                                 jnp.asarray(idx), jnp.asarray(seg), n_bnd))
    real = seg < n_bnd
    order = np.argsort(seg[real], kind="stable")
    perm = idx[real][order]
    offsets = np.searchsorted(seg[real][order], np.arange(n_bnd + 1),
                              side="left").astype(np.int32)
    out = subset_sum(
        [torch.from_numpy(m) for m in f2v], torch.from_numpy(perm),
        torch.from_numpy(offsets),
        torch.from_numpy(aggregation_plan(offsets, d)),
        torch.zeros((n_bnd, d)))
    assert np.array_equal(bits(out.numpy()), bits(ref))
