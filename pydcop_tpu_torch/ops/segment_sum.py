"""The belief aggregation: CUDA kernel wrapper and plain version.

Sums every variable's incoming factor->variable messages in a fixed
order — edge order within a bucket, and across buckets the form XLA
gives the reference's jitted superstep — and adds its own costs.  The reference's scatter branch of
``pydcop_tpu/ops/maxsum.py:389 aggregate_beliefs`` is jnp code, not a
Pallas kernel; on the card it is the hand-written kernel
``csrc/segment_sum.cu``, because torch's ``index_add_`` adds with
atomics in no fixed order there and the run would neither repeat
itself nor equal the CPU's.  On a CUDA tensor the wrapper launches the
kernel and raises if the launch fails; on a CPU tensor it runs the
plain version.
"""

import ctypes
import functools
from typing import Tuple

import torch

from pydcop_tpu_torch.ops import _build

KERNEL = "segment_sum"


def segment_sum_reference(msgs: torch.Tensor, perm: torch.Tensor,
                          offsets: torch.Tensor, buckets: torch.Tensor,
                          var_costs: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The definition, in ``index_add_`` calls (each sequential in edge
    order on the CPU): bucket 0's edges are added into zeros; then,
    bucket by bucket, an odd bucket is summed into zeros of its own and
    added, and an even bucket is added into the running sums — the form
    XLA gives the reference's jitted sum of per-bucket segment_sums.
    Then ``var_costs + sums``.  Each edge's variable is read back from
    the CSR arrays.  Returns (beliefs, sums), both [V+1, D]."""
    n_seg, d = var_costs.shape
    dev = perm.device
    counts = (offsets[1:] - offsets[:-1]).to(torch.int64)
    seg = torch.empty(perm.shape, dtype=torch.int64, device=dev)
    seg[perm.to(torch.int64)] = torch.repeat_interleave(
        torch.arange(n_seg, device=dev), counts, output_size=perm.shape[0])
    edge_bucket = torch.searchsorted(
        buckets, torch.arange(perm.shape[0], dtype=torch.int32, device=dev),
        right=True) - 1
    # Row n_seg takes the edges of the other buckets and is dropped.
    sums = torch.zeros((n_seg + 1, d), dtype=var_costs.dtype, device=dev)
    for b in range(buckets.shape[0] - 1):
        rows = torch.where(edge_bucket == b, seg, n_seg)
        if b % 2:
            part = torch.zeros_like(sums)
            part.index_add_(0, rows, msgs)
            sums = sums + part
        else:
            sums.index_add_(0, rows, msgs)
    sums = sums[:-1]
    return var_costs + sums, sums


def _check(msgs, perm, offsets, buckets, var_costs):
    for name, t, dtype in (("msgs", msgs, torch.float32),
                           ("perm", perm, torch.int32),
                           ("offsets", offsets, torch.int32),
                           ("buckets", buckets, torch.int32),
                           ("var_costs", var_costs, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"segment_sum: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if t.device != msgs.device:
            raise ValueError(f"segment_sum: {name} on {t.device} but "
                             f"msgs on {msgs.device}")
        if not t.is_contiguous():
            raise ValueError(f"segment_sum: {name} is not contiguous")
    if msgs.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {msgs.device}")
    if var_costs.dim() != 2:
        raise ValueError(
            f"var_costs must be [V+1, D], got {tuple(var_costs.shape)}")
    n_seg, d = var_costs.shape
    n_edges = perm.shape[0] if perm.dim() == 1 else -1
    if tuple(msgs.shape) != (n_edges, d):
        raise ValueError(
            f"msgs must be [E, D] = {(n_edges, d)} (E from perm), got "
            f"{tuple(msgs.shape)} with perm {tuple(perm.shape)}")
    if tuple(offsets.shape) != (n_seg + 1,):
        raise ValueError(
            f"offsets must be [V+2] = {(n_seg + 1,)}, got "
            f"{tuple(offsets.shape)}")
    if buckets.dim() != 1 or buckets.shape[0] < 2:
        raise ValueError(
            f"buckets must be [n_buckets + 1] edge starts, got "
            f"{tuple(buckets.shape)}")


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load(KERNEL)
    fn = lib.segment_sum_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def segment_sum(msgs: torch.Tensor, perm: torch.Tensor,
                offsets: torch.Tensor, buckets: torch.Tensor,
                var_costs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """msgs [E, D] f32, perm [E] int32, offsets [V+2] int32, buckets
    [n_buckets + 1] int32, var_costs [V+1, D] f32 -> (beliefs, sums)
    [V+1, D] f32, in the order of :func:`segment_sum_reference`.
    Launches the CUDA kernel on the current stream for CUDA tensors;
    runs the plain version for CPU tensors."""
    _check(msgs, perm, offsets, buckets, var_costs)
    if msgs.device.type == "cpu":
        return segment_sum_reference(msgs, perm, offsets, buckets,
                                     var_costs)
    n_seg, d = var_costs.shape
    if max(msgs.numel(), var_costs.numel()) >= 2 ** 31:
        raise ValueError(
            f"graph too large for one launch: E={msgs.shape[0]}, "
            f"V+1={n_seg}, D={d}")
    if msgs.device.index != torch.cuda.current_device():
        with torch.cuda.device(msgs.device):
            return segment_sum(msgs, perm, offsets, buckets, var_costs)
    sums = torch.empty_like(var_costs)
    beliefs = torch.empty_like(var_costs)
    if sums.numel() == 0:
        return beliefs, sums
    err = _launcher()(msgs.data_ptr(), perm.data_ptr(), offsets.data_ptr(),
                      buckets.data_ptr(), buckets.shape[0] - 1,
                      var_costs.data_ptr(), sums.data_ptr(),
                      beliefs.data_ptr(), n_seg, d,
                      torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {err}")
    _build.launch_counts[KERNEL] += 1
    return beliefs, sums
