"""Counter-based random numbers equal to ``jax.random``'s, bit for bit.

The reference draws its recovery noise with ``jax.random``
(``PRNGKey``, ``fold_in``, ``uniform``), whose generator is
threefry-2x32: a keyed hash of a counter, so the numbers are a pure
function of (key, position) and need no state.  This module computes
the same hash on torch tensors, in int64 with every word masked to 32
bits, so the same code gives the same bits on the CPU and on the card.

Conventions of jax 0.9.0 with ``jax_threefry_partitionable`` (its
default):

- a key is two uint32 words; ``PRNGKey(seed)`` is ``[0, seed &
  0xFFFFFFFF]``: without ``jax_enable_x64`` (the reference's setting)
  jax keeps the seed's low 32 bits, so ``PRNGKey(2**32 + 5)`` is
  ``[0, 5]``;
- ``fold_in(key, data)`` hashes the counter pair ``(0, data)`` under
  ``key``;
- the bits of an array of ``shape`` hash, for the element at row-major
  flat index i, the counter pair ``(i >> 32, i & 0xFFFFFFFF)`` and
  XOR the two output words;
- ``uniform`` keeps the top 23 bits as the mantissa of a float in
  [1, 2), subtracts 1, then scales: ``max(min, f * (max - min) + min)``,
  where XLA:CPU contracts the multiply and the add into one fused
  multiply-add (one rounding).  Here the product is exact in float64
  and, for ranges with ``|min| <= 16 (max - min)``, so is the sum, so
  its one rounding to float32 is the FMA's
  (``tests/test_torch_prng.py`` holds the bits).

Keys are int64 tensors of shape [2] holding the two words, or, for
the ``*_words`` functions, the two words as a tuple of Python ints: a
key chain that depends on the seed and a counter alone (the local
search's ``split`` / ``fold_in`` per cycle) is then computed on the
host, and a draw on the card takes its key as two kernel arguments
(``ops/threefry.py``) without reading the device.  ``split(key, n)[i]``
is ``fold_in(key, i)`` (the partitionable layout: counter ``(0, i)``),
which ``tests/test_torch_prng.py`` holds against ``jax.random.split``.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.device import DeviceLike, resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


Words = Tuple[int, int]


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry-2x32 hash (20 rounds) of the counter words
    ``(x0, x1)`` under ``key``: two word tensors of the counters'
    shape, int64 in [0, 2**32)."""
    return threefry2x32_words((int(key[0]), int(key[1])), x0, x1)


def threefry2x32_words(key: Words, x0, x1):
    """:func:`threefry2x32` under host key words; the counter words are
    int64 tensors or Python ints (then so are the two results)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key_words(seed: int) -> Words:
    """``jax.random.PRNGKey(seed)``'s two words, for a seed in
    [0, 2**63): the seed's low 32 bits, as jax keeps them."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 63:
        raise ValueError(f"seed must be in [0, 2**63): {seed}")
    return 0, seed & _MASK


def PRNGKey(seed: int, device: DeviceLike = "cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**63)."""
    return torch.tensor(key_words(seed), dtype=torch.int64,
                        device=resolve_device(device))


def _fold_data(data: int) -> int:
    data = int(data)
    if not 0 <= data <= _MASK:
        raise ValueError(f"fold_in data must be in [0, 2**32): {data}")
    return data


def fold_in_words(key: Words, data: int) -> Words:
    """``jax.random.fold_in(key, data)`` on host words."""
    return threefry2x32_words(key, 0, _fold_data(data))


def split_words(key: Words, n: int = 2) -> List[Words]:
    """``jax.random.split(key, n)`` on host words: ``n`` keys, the i-th
    ``fold_in(key, i)``."""
    return [fold_in_words(key, i) for i in range(n)]


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for ``data`` in [0, 2**32)."""
    words = torch.tensor([0, _fold_data(data)], dtype=torch.int64,
                         device=key.device)
    y0, y1 = threefry2x32(key, words[:1], words[1:])
    return torch.cat([y0, y1])


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: [n, 2] int64, row i
    ``fold_in(key, i)``."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key, torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 in [0, 2**32)),
    the partitionable layout of ``jax.random.bits``."""
    return random_bits_words((int(key[0]), int(key[1])), shape, key.device)


def random_bits_words(key: Words, shape: Sequence[int],
                      device: DeviceLike = "cpu") -> torch.Tensor:
    """:func:`random_bits` under host key words, on ``device``."""
    n = 1
    for s in shape:
        n *= int(s)
    i = torch.arange(n, dtype=torch.int64, device=torch.device(device))
    y0, y1 = threefry2x32_words(key, i >> 32, i & _MASK)
    return (y0 ^ y1).reshape(tuple(shape))


def uniform_range(minval: float, maxval: float) -> Tuple[float, float]:
    """``(lo, span)`` of a draw in [minval, maxval) as float32 values
    (``span`` is the float32 difference), refusing ranges whose
    scaling this module cannot round as XLA's fused multiply-add."""
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    if not abs(float(lo)) <= 16 * float(span):
        raise NotImplementedError(
            "uniform's fused multiply-add is exact here only for "
            f"|minval| <= 16 (maxval - minval): [{minval}, {maxval})")
    return float(lo), float(span)


def uniform(key: torch.Tensor, shape: Sequence[int],
            dtype: torch.dtype = torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    if dtype != torch.float32:
        raise NotImplementedError(
            f"uniform draws float32 only, not {dtype}")
    return uniform_words((int(key[0]), int(key[1])), shape, key.device,
                         minval, maxval)


def uniform_words(key: Words, shape: Sequence[int],
                  device: DeviceLike = "cpu", minval: float = 0.0,
                  maxval: float = 1.0) -> torch.Tensor:
    """:func:`uniform` (float32) under host key words, on ``device``:
    the plain version of ``ops/threefry.py``'s kernel."""
    lo, span = uniform_range(minval, maxval)
    bits = random_bits_words(key, shape, device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    fma = (floats.double() * span + lo).to(torch.float32)
    return torch.clamp(fma, min=lo)
