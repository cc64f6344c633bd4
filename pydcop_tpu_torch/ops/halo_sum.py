"""The partitioned engine's cross-shard sum: CUDA kernel wrapper and
plain version.

The reference all-reduces across the mesh with ``jax.lax.psum``: the
``[B, D]`` boundary partials of every superstep
(``pydcop_tpu/engine/sharding.py:426 _exchange_halo``) and, in a traced
run, each shard's scalar cost (``:765``).  Its order on XLA:CPU (jax
0.9.0, read off the bits over 1, 3 and 6 decades of draws and subnormal
ones at S = 2..8): every element starts from +0.0 and takes the shards'
values in mesh order, each add reading a subnormal operand as a zero of
its sign and flushing a subnormal result.  :func:`halo_sum` sums in that
order: on CUDA tensors it launches ``csrc/halo_sum.cu`` (one
``add.ftz`` a shard, no atomics, no tree) and raises if the launch
fails; on CPU tensors it runs :func:`halo_sum_reference`.

The partials are the shards' own tensors.  On one device the kernel
reads them where they lie; a partial on another card is first copied to
the reduction device (``out_device``, the mesh's first device).
"""

import ctypes
import functools
from typing import Optional, Sequence, Union

import torch

from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops.flush import ftz

KERNEL = "halo_sum"
# The kernel takes the shards' base pointers in its parameters.
MAX_SHARDS = 64

Parts = Union[torch.Tensor, Sequence[torch.Tensor]]


def _split(parts: Parts):
    """The partials as a list: the rows of a stacked [S, ...] tensor, or
    the given tensors."""
    if isinstance(parts, torch.Tensor):
        return list(parts.unbind(0))
    return list(parts)


def halo_sum_reference(parts: Parts) -> torch.Tensor:
    """The plain version: from +0.0, each shard's partial added in mesh
    order, read flushed and the sum flushed (``ops/flush.py``)."""
    parts = _split(parts)
    acc = torch.zeros_like(parts[0])
    for p in parts:
        acc = ftz(acc + ftz(p.to(acc.device)))
    return acc


def _check(parts, dev):
    if len(parts) > MAX_SHARDS:
        raise ValueError(f"{len(parts)} shards: the kernel takes at most "
                         f"{MAX_SHARDS}")
    shape = tuple(parts[0].shape)
    for p in parts:
        if p.dtype != torch.float32:
            raise TypeError(f"halo_sum takes float32, got {p.dtype}")
        if tuple(p.shape) != shape:
            raise ValueError(f"partials of different shapes: {shape} and "
                             f"{tuple(p.shape)}")
        if p.device.type != dev.type:
            raise ValueError(f"partials on {p.device} and {dev}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load(KERNEL)
    fn = lib.halo_sum_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def halo_sum(parts: Parts,
             out_device: Optional[torch.device] = None) -> torch.Tensor:
    """The cross-shard total of ``parts`` (S tensors of one shape, or
    one stacked [S, ...] tensor), in the reference's all-reduce order,
    on ``out_device`` (default: the first partial's device)."""
    parts = _split(parts)
    if not parts:
        raise ValueError("halo_sum needs at least one partial")
    dev = torch.device(out_device) if out_device is not None \
        else parts[0].device
    _check(parts, dev)
    if dev.type == "cpu":
        return halo_sum_reference(parts)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return halo_sum(parts, dev)
    # A partial on another card comes over in one peer copy; the rest
    # are read where they lie.
    parts = [p.to(dev).contiguous() for p in parts]
    out = torch.empty_like(parts[0])
    n = out.numel()
    if n == 0:
        return out
    bases = (ctypes.c_void_p * len(parts))(*(p.data_ptr() for p in parts))
    err = _launcher()(bases, len(parts), out.data_ptr(), n,
                      torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"halo_sum launch failed: CUDA error {err}")
    _build.launch_counts[KERNEL] += 1
    return out
