"""The lane layout's belief sum: CUDA kernel wrapper and plain version.

Port of ``pydcop_tpu/ops/maxsum_lane.py:318 aggregate_beliefs``: per
bucket ``sums.at[:, seg].add(flat)`` over the lane-major messages
``[D, a, F]`` flattened to ``[D, a*F]`` (position-major edges), the
buckets' scatters chained from zeros, then ``var_costs + sums``.  XLA:CPU
runs each scatter as one serial loop over its updates, so every
variable's sum is ONE running sum from +0.0 over its edges in the
global position-major order — bucket by bucket, position by position,
factor by factor — each add flushed to zero.  That order was read off
the jitted reference (``tests/test_torch_maxsum_lane.py`` holds it bit
for bit on graphs of one to four buckets, one-edge buckets included);
it is the edge layout's ``one_sum`` walk over another edge order.

On a CUDA tensor the wrapper launches ``csrc/lane_sum.cu`` (CUDA's
``index_add_`` adds with atomics in no fixed order, so only a
fixed-order kernel makes the card equal the CPU) and raises if the
launch fails; on a CPU tensor it runs the plain version.
"""

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops.flush import ftz
from pydcop_tpu_torch.ops.segment_sum import MAX_BUCKETS, _walk

KERNEL = "lane_sum"


def lane_order(var_ids: Sequence[np.ndarray], n_rows: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(perm [E], offsets [V+2], bucket starts [n_buckets + 1]) int32 of
    the lane buckets' ``var_ids`` ([a, F] each, numpy) over ``n_rows`` =
    V + 1 variables: the edges numbered position-major, bucket after
    bucket, and ``perm`` their stable sort by variable, so variable v's
    edges in the scatters' order are ``perm[offsets[v]:offsets[v+1]]``."""
    seg = (np.concatenate([np.asarray(ids).reshape(-1) for ids in var_ids])
           if len(var_ids) else np.zeros((0,), np.int64))
    perm = np.argsort(seg, kind="stable").astype(np.int32)
    offsets = np.searchsorted(seg[perm], np.arange(n_rows + 1),
                              side="left").astype(np.int32)
    starts = np.cumsum([0] + [np.asarray(ids).size for ids in var_ids]
                       ).astype(np.int32)
    return perm, offsets, starts


def lane_sum_reference(f2v: Sequence[torch.Tensor], perm: torch.Tensor,
                       offsets: torch.Tensor, starts: torch.Tensor,
                       var_costs: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: each bucket's ``[D, a, F]`` messages as [a*F,
    D] edge rows, the running sum walked edge rank by edge rank
    (``segment_sum._walk`` in its one-sum mode, each add flushed), then
    ``var_costs + sums`` flushed.  Returns (beliefs, sums), [D, V+1]."""
    d = var_costs.shape[0]
    rows = [m.reshape(d, -1).t() for m in f2v]
    flat = rows[0] if len(rows) == 1 else torch.cat(rows)
    sums = _walk(flat, perm, offsets, starts,
                 torch.zeros_like(var_costs.t()), True).t().contiguous()
    return ftz(var_costs + sums), sums


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load(KERNEL).lane_sum_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def lane_sum(f2v: Sequence[torch.Tensor], perm: torch.Tensor,
             offsets: torch.Tensor, starts: torch.Tensor,
             var_costs: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(beliefs, sums) [D, V+1] float32 of the lane buckets' f2v
    messages (``[D, a, F]`` float32 each, read where they lie) in the
    reference's scatter order (:func:`lane_order`: perm [E], offsets
    [V+2] and starts [n_buckets + 1], int32), plus ``var_costs`` [D,
    V+1].  One launch on the card; the plain version on the CPU."""
    parts = tuple(f2v)
    dev = var_costs.device
    if var_costs.dtype != torch.float32 or var_costs.dim() != 2:
        raise TypeError("var_costs must be [D, V+1] float32")
    d, n_rows = var_costs.shape
    for name, t, dtype in ([("f2v", p, torch.float32) for p in parts]
                           + [("perm", perm, torch.int32),
                              ("offsets", offsets, torch.int32),
                              ("starts", starts, torch.int32)]):
        if t.dtype != dtype:
            raise TypeError(f"lane_sum: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if t.device != dev:
            raise ValueError(f"lane_sum: {name} on {t.device}, var_costs "
                             f"on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"lane_sum: {name} is not contiguous")
    if any(p.dim() != 3 or p.shape[0] != d for p in parts):
        raise ValueError(f"each bucket's f2v must be [D={d}, a, F]")
    sizes = [p.numel() // d if d else 0 for p in parts]
    if (len(parts) != starts.shape[0] - 1 or sum(sizes) != perm.shape[0]
            or tuple(offsets.shape) != (n_rows + 1,)):
        raise ValueError(
            f"{len(parts)} buckets of {sum(sizes)} edges for starts "
            f"{tuple(starts.shape)}, perm {tuple(perm.shape)}, offsets "
            f"{tuple(offsets.shape)} (V+2 = {n_rows + 1})")
    if dev.type == "cpu":
        return lane_sum_reference(parts, perm, offsets, starts, var_costs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if len(parts) > MAX_BUCKETS:
        raise ValueError(f"{len(parts)} buckets: the kernel takes at most "
                         f"{MAX_BUCKETS}")
    if max([p.numel() for p in parts] + [var_costs.numel()]) >= 2 ** 31:
        raise ValueError(f"graph too large for one launch: E={sum(sizes)},"
                         f" V+1={n_rows}, D={d}")
    beliefs = torch.empty_like(var_costs)
    sums = torch.empty_like(var_costs)
    if var_costs.numel() == 0:
        return beliefs, sums
    n = len(parts)
    bases = (ctypes.c_void_p * max(n, 1))(*(p.data_ptr() for p in parts))
    edge_starts = (ctypes.c_int * (n + 1))(*np.cumsum([0] + sizes).tolist())
    with torch.cuda.device(dev):
        err = _launcher()(bases, edge_starts, n, perm.data_ptr(),
                          offsets.data_ptr(), var_costs.data_ptr(),
                          sums.data_ptr(), beliefs.data_ptr(), n_rows, d,
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"lane_sum launch failed: CUDA error {err}")
    _build.launch_counts[KERNEL] += 1
    return beliefs, sums
