"""``jax.random.uniform`` draws on the card: CUDA kernel wrappers and
plain versions.

The local search draws its random numbers with ``jax.random``, so the
port must give the same bits (``utils/prng.py`` says how).  Its keys
depend on the seed and the cycle alone, so the key chain runs on the
host (``prng.split_words`` / ``prng.fold_in_words``) and each draw takes
its key as two words: :func:`uniform` is ``jax.random.uniform(key,
shape)`` and :func:`best_choice` is the local search's uniform choice
among the True slots of each row.  On a CUDA tensor each launches its
entry of ``csrc/threefry.cu`` on the current stream and raises if the
launch fails; on the CPU it runs the plain version, whose arithmetic is
``utils/prng.py``'s.  Neither reads the device on the host.
"""

import ctypes
import functools
from typing import Sequence

import torch

from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.utils import prng

KERNEL = "threefry"
# Launch-count keys of the two entry points (``_build.launch_counts``).
UNIFORM = "threefry:uniform_f32"
BEST_CHOICE = "threefry:best_choice"


def uniform_reference(key: prng.Words, shape: Sequence[int],
                      device: DeviceLike = "cpu", minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """The plain version: ``prng.uniform_words``."""
    return prng.uniform_words(key, shape, device, minval, maxval)


def best_choice_reference(key: prng.Words,
                          mask: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`best_choice`: ``argmax(where(mask,
    uniform(key, mask.shape), -1.0), dim=1)`` as int32 (torch's argmax
    takes the first maximum, as jnp's)."""
    u = prng.uniform_words(key, mask.shape, mask.device)
    return torch.argmax(torch.where(mask, u, -1.0), dim=1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _launchers():
    lib = _build.load(KERNEL)
    uni = lib.threefry_uniform_launch
    uni.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_longlong,
                    ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                    ctypes.c_void_p]
    uni.restype = ctypes.c_int
    best = lib.threefry_best_choice_launch
    best.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p]
    best.restype = ctypes.c_int
    return uni, best


def _check_key(key) -> prng.Words:
    k0, k1 = (int(w) for w in key)
    if not (0 <= k0 <= 0xFFFFFFFF and 0 <= k1 <= 0xFFFFFFFF):
        raise ValueError(f"key words must be uint32, got {key}")
    return k0, k1


def uniform(key: prng.Words, shape: Sequence[int],
            device: DeviceLike = "cuda", minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` on
    ``device`` (float32), ``key`` the two host words."""
    key = _check_key(key)
    dev = torch.device(device)
    if dev.type == "cpu":
        return uniform_reference(key, shape, dev, minval, maxval)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lo, span = prng.uniform_range(minval, maxval)
    out = torch.empty(tuple(int(s) for s in shape), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        err = _launchers()[0](key[0], key[1], out.numel(), lo, span,
                              out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry uniform launch failed: CUDA error "
                           f"{err}")
    _build.launch_counts[UNIFORM] += 1
    return out


def best_choice(key: prng.Words, mask: torch.Tensor) -> torch.Tensor:
    """[N] int32: per row of the [N, K] bool ``mask``, a uniform choice
    among its True slots (the slot whose draw of ``uniform(key, (N,
    K))`` is largest; 0 for an empty row) — the reference's
    ``argmax(where(mask, u, -1.0), axis=1)``."""
    key = _check_key(key)
    if mask.dim() != 2 or mask.dtype != torch.bool:
        raise TypeError(f"best_choice takes an [N, K] bool mask, got "
                        f"{mask.dtype} {tuple(mask.shape)}")
    if mask.shape[1] < 1:
        raise ValueError("best_choice needs K >= 1")
    if mask.device.type == "cpu":
        return best_choice_reference(key, mask)
    if mask.device.type != "cuda":
        raise ValueError(f"unsupported device {mask.device}")
    if mask.shape[0] >= 2 ** 31:
        raise ValueError(f"mask too large: {tuple(mask.shape)}")
    mask = mask.contiguous()
    n_rows, k = mask.shape
    out = torch.empty((n_rows,), dtype=torch.int32, device=mask.device)
    with torch.cuda.device(mask.device):
        err = _launchers()[1](key[0], key[1], mask.data_ptr(), n_rows, k,
                              out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry best_choice launch failed: CUDA "
                           f"error {err}")
    _build.launch_counts[BEST_CHOICE] += 1
    return out
