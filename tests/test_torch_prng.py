"""``pydcop_tpu_torch.utils.prng`` against ``jax.random`` on the CPU:
``PRNGKey``, ``fold_in`` (indices 0..20), the raw 32-bit draws and
``uniform`` (float32, odd and multi-axis shapes, symmetric and skewed
ranges) over the seeds 0, 1, 7 and 2**31 - 1, each held bit for bit
(``np.array_equal`` on the uint32 views); and the recovery noise,
``perturb_state``, equal to the reference's leaf by leaf.  The local
search's key chain: ``split`` (tensors) and ``key_words`` /
``split_words`` / ``fold_in_words`` (host words) equal
``jax.random.PRNGKey`` / ``split`` / ``fold_in`` for n = 2, 3, 5 and
seeds up to 2**63 - 1 (so ``split(k, n)[i]`` is ``fold_in(k, i)``, which
the port relies on), and ``uniform_words`` equals ``jax.random.uniform``
under a chain of such keys.
"""

import jax  # noqa: F401  (imported first: JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.resilience.recovery import perturb_state as jax_perturb
from pydcop_tpu_torch.resilience.recovery import perturb_state
from pydcop_tpu_torch.utils import prng


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SEEDS = [0, 1, 7, 2 ** 31 - 1]
SHAPES = [(1,), (7,), (3, 5), (4, 2, 3), (2, 1, 3, 2), (1001,)]


def _key_words(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_fold_in_equal_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    tkey = prng.PRNGKey(seed, device="cpu")
    np.testing.assert_array_equal(tkey.numpy(), _key_words(jkey))
    for i in range(21):
        np.testing.assert_array_equal(
            prng.fold_in(tkey, i).numpy(),
            _key_words(jax.random.fold_in(jkey, i)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_equal_jax(seed, shape):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    tkey = prng.fold_in(prng.PRNGKey(seed, device="cpu"), 3)
    ref = np.asarray(jax.random.bits(jkey, shape, jnp.uint32))
    np.testing.assert_array_equal(
        prng.random_bits(tkey, shape).numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1e-3, 1e-3),
                                   (-0.37, 2.5), (1e-7, 3e-7),
                                   (-5.0, 0.5)])
def test_uniform_equals_jax_bit_for_bit(seed, shape, lo, hi):
    """The fused multiply-add of the scaling is the reference's (one
    rounding), checked on every bit, under three fold-in indices."""
    jbase = jax.random.PRNGKey(seed)
    tbase = prng.PRNGKey(seed, device="cpu")
    for i in (0, 5, 20):
        ref = np.asarray(jax.random.uniform(
            jax.random.fold_in(jbase, i), shape, dtype=jnp.float32,
            minval=lo, maxval=hi))
        out = prng.uniform(prng.fold_in(tbase, i), shape, minval=lo,
                           maxval=hi).numpy()
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out.view(np.uint32),
                                      ref.view(np.uint32))


def test_uniform_refuses_ranges_it_cannot_round_exactly():
    key = prng.PRNGKey(0, device="cpu")
    with pytest.raises(NotImplementedError):
        prng.uniform(key, (3,), minval=1000.0, maxval=1001.0)
    with pytest.raises(NotImplementedError):
        prng.uniform(key, (3,), dtype=torch.float64)


def test_out_of_range_seeds_and_data_are_refused():
    with pytest.raises(ValueError):
        prng.PRNGKey(-1, device="cpu")
    with pytest.raises(ValueError):
        prng.fold_in(prng.PRNGKey(0, device="cpu"), 2 ** 32)


@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (1, 1e-3), (4, 0.25)])
def test_perturb_state_equals_jax_leaf_by_leaf(seed, scale):
    """A MaxSum state of three buckets (arities 1-3) with messages,
    counts, ``stable`` and ``cycle``: the noise is folded by the index
    of every leaf, int8 and scalar ones included, and lands on the
    float leaves only; ``stable`` is cleared."""
    from pydcop_tpu.ops.maxsum import MaxSumState as JState
    from pydcop_tpu_torch.engine.convert import state_from_numpy

    rng = np.random.default_rng(seed)
    shapes = [(5, 1, 3), (7, 2, 3), (4, 3, 3)]
    fields = {
        "v2f": [rng.normal(size=s).astype(np.float32) for s in shapes],
        "f2v": [rng.normal(size=s).astype(np.float32) for s in shapes],
        "v2f_count": [rng.integers(0, 5, size=s[:2]).astype(np.int8)
                      for s in shapes],
        "f2v_count": [rng.integers(0, 5, size=s[:2]).astype(np.int8)
                      for s in shapes],
    }
    jstate = JState(
        **{k: tuple(jnp.asarray(a) for a in v) for k, v in fields.items()},
        stable=jnp.asarray(True), cycle=jnp.asarray(9, jnp.int32))
    tstate = state_from_numpy(**fields, stable=True, cycle=9,
                              device="cpu")
    ref = jax_perturb(jstate, scale, seed)
    out = perturb_state(tstate, scale, seed)
    assert not bool(out.stable) and not bool(ref.stable)
    for name in ("v2f", "f2v", "v2f_count", "f2v_count"):
        for a, b in zip(getattr(out, name), getattr(ref, name)):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.view(np.uint8),
                                          b.view(np.uint8))
    assert int(out.cycle) == int(ref.cycle) == 9
    assert not np.array_equal(out.v2f[0].numpy(), fields["v2f"][0])


CHAIN_SEEDS = [0, 1, 7, 2 ** 31 - 1, 2 ** 32, 2 ** 32 + 5, 2 ** 63 - 1]


@pytest.mark.parametrize("seed", CHAIN_SEEDS)
@pytest.mark.parametrize("n", [2, 3, 5])
def test_split_and_host_key_chain_equal_jax(seed, n):
    """Twelve steps of the local search's chain (split into n, carry
    the first) on tensors and on host words, against jax.random."""
    jkey = jax.random.PRNGKey(seed)
    tkey = prng.PRNGKey(seed, device="cpu")
    words = prng.key_words(seed)
    assert words == tuple(int(w) for w in _key_words(jkey))
    for step in range(12):
        jsplit = np.asarray(jax.random.split(jkey, n)).astype(np.int64)
        np.testing.assert_array_equal(prng.split(tkey, n).numpy(), jsplit)
        assert prng.split_words(words, n) == [
            tuple(int(w) for w in row) for row in jsplit]
        for i in range(n):
            np.testing.assert_array_equal(
                jsplit[i], _key_words(jax.random.fold_in(jkey, i)))
        jkey, tkey, words = jsplit[0].astype(np.uint32), prng.split(
            tkey, n)[0], prng.split_words(words, n)[0]
        jkey = jnp.asarray(jkey)
    for data in (0, 1, 10_000, 2 ** 32 - 1):
        assert prng.fold_in_words(words, data) == tuple(
            int(w) for w in _key_words(jax.random.fold_in(jkey, data)))


@pytest.mark.parametrize("seed", CHAIN_SEEDS)
@pytest.mark.parametrize("shape", [(1,), (1001,), (31, 9)])
def test_uniform_words_equal_jax(seed, shape):
    jkey, words = jax.random.PRNGKey(seed), prng.key_words(seed)
    for _ in range(3):
        jkey, jsub = jax.random.split(jkey)
        words, sub = prng.split_words(words)
        ref = np.asarray(jax.random.uniform(jsub, shape))
        out = prng.uniform_words(sub, shape).numpy()
        np.testing.assert_array_equal(out.view(np.uint32),
                                      ref.view(np.uint32))
