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

The result is one row table ``[V+1, 2P]`` (P = :func:`row_floats`):
row v holds the beliefs ``var_costs[:, v] + sums[:, v]``, then the
sums, each half padded with zeros to P floats, so the variable side
(``ops/lane_var_update.py``) gathers one aligned row an edge;
:func:`lane_sum` returns the two halves as ``[D, V+1]`` views.
:func:`lane_beliefs` is the same walk from ``var_costs`` instead of
zeros, the beliefs only: where the reference keeps no sums (the values
it selects after a run and after each traced cycle) XLA scatters the
messages into ``var_costs`` directly, which adds in another order.

On a CUDA tensor the wrappers launch ``csrc/lane_sum.cu`` (CUDA's
``index_add_`` adds with atomics in no fixed order, so only a
fixed-order kernel makes the card equal the CPU) and raise if the
launch fails; on a CPU tensor they run the plain version.  The kernel
also reads the placement's ``heavy`` (the variables of degree above
:data:`HEAVY_DEGREE`, by degree, descending: :func:`heavy_variables`).
"""

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops.flush import ftz
from pydcop_tpu_torch.ops.segment_sum import MAX_BUCKETS, _walk

KERNEL = "lane_sum"
# Variables of more edges than this take a warp of their own in the
# kernel's walk; the others one thread.
HEAVY_DEGREE = 64


def row_floats(d: int) -> int:
    """Floats a row of D slots takes in the kernel's rows and in each
    half of the table: 4 up to D = 4, 8 up to D = 8 (16-byte vectors;
    the pad is zeros), else D."""
    return 4 if d <= 4 else 8 if d <= 8 else d


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


def heavy_variables(offsets: np.ndarray) -> np.ndarray:
    """[H] int32: the variables of :func:`lane_order`'s ``offsets`` of
    degree above :data:`HEAVY_DEGREE`, by degree, descending (ties by
    index), so their warps start first in the kernel's walk.  The
    kernel's light threads skip exactly these variables, so ``heavy``
    must be this list and no other."""
    degree = np.diff(np.asarray(offsets, np.int64))
    heavy = np.flatnonzero(degree > HEAVY_DEGREE)
    return heavy[np.argsort(-degree[heavy], kind="stable")].astype(np.int32)


def lane_sum_reference(f2v: Sequence[torch.Tensor], perm: torch.Tensor,
                       offsets: torch.Tensor, starts: torch.Tensor,
                       var_costs: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: each bucket's ``[D, a, F]`` messages as [a*F,
    D] edge rows, the running sum walked edge rank by edge rank
    (``segment_sum._walk`` in its one-sum mode, each add flushed), then
    ``var_costs + sums`` flushed.  Returns (beliefs, sums), [D, V+1]."""
    sums = _walk(_edge_rows(f2v, var_costs.shape[0]), perm, offsets, starts,
                 torch.zeros_like(var_costs.t()), True).t().contiguous()
    return ftz(var_costs + sums), sums


def lane_beliefs_reference(f2v: Sequence[torch.Tensor], perm: torch.Tensor,
                           offsets: torch.Tensor, starts: torch.Tensor,
                           var_costs: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`lane_beliefs`: the walk of
    :func:`lane_sum_reference` from ``var_costs``.  [D, V+1]."""
    return _walk(_edge_rows(f2v, var_costs.shape[0]), perm, offsets, starts,
                 var_costs.t().contiguous(), True).t().contiguous()


def _edge_rows(f2v, d):
    rows = [m.reshape(d, -1).t() for m in f2v]
    return rows[0] if len(rows) == 1 else torch.cat(rows)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load(KERNEL).lane_sum_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(parts, perm, offsets, starts, var_costs, heavy):
    dev = var_costs.device
    if var_costs.dtype != torch.float32 or var_costs.dim() != 2:
        raise TypeError("var_costs must be [D, V+1] float32")
    d, n_rows = var_costs.shape
    for name, t, dtype in ([("f2v", p, torch.float32) for p in parts]
                           + [("perm", perm, torch.int32),
                              ("offsets", offsets, torch.int32),
                              ("starts", starts, torch.int32),
                              ("heavy", heavy, torch.int32)]):
        if t is None:
            continue
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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return sizes


def _launch(parts, sizes, perm, offsets, var_costs, heavy, from_costs):
    """One call of the kernel (its two launches); returns the table."""
    dev = var_costs.device
    d, n_rows = var_costs.shape
    if len(parts) > MAX_BUCKETS:
        raise ValueError(f"{len(parts)} buckets: the kernel takes at most "
                         f"{MAX_BUCKETS}")
    if max([p.numel() for p in parts] + [2 * var_costs.numel()]) >= 2 ** 31:
        raise ValueError(f"graph too large for one launch: E={sum(sizes)},"
                         f" V+1={n_rows}, D={d}")
    heavy_degree = HEAVY_DEGREE
    if heavy is None:
        heavy = torch.zeros((0,), dtype=torch.int32, device=dev)
    p = row_floats(d)
    out = torch.empty((n_rows, p if from_costs else 2 * p),
                      dtype=torch.float32, device=dev)
    if n_rows == 0:
        return out
    rows = torch.empty((max(sum(sizes), 1), d), dtype=torch.float32,
                       device=dev)
    n = len(parts)
    bases = (ctypes.c_void_p * max(n, 1))(*(p.data_ptr() for p in parts))
    edge_starts = (ctypes.c_int * (n + 1))(*np.cumsum([0] + sizes).tolist())
    with torch.cuda.device(dev):
        err = _launcher()(bases, edge_starts, n, perm.data_ptr(),
                          offsets.data_ptr(), heavy.data_ptr(),
                          heavy.shape[0], heavy_degree,
                          var_costs.data_ptr(), rows.data_ptr(),
                          out.data_ptr(), n_rows, d, p, int(from_costs),
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"lane_sum launch failed: CUDA error {err}")
    _build.launch_counts[KERNEL] += 1
    return out


def lane_sum_table(f2v: Sequence[torch.Tensor], perm: torch.Tensor,
                   offsets: torch.Tensor, starts: torch.Tensor,
                   var_costs: torch.Tensor,
                   heavy: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The row table [V+1, 2P] float32 (beliefs, then sums, each padded
    with zeros to P = :func:`row_floats` floats) of the lane
    buckets' f2v messages (``[D, a, F]`` float32 each, read where they
    lie) in the reference's scatter order (:func:`lane_order`: perm [E],
    offsets [V+2] and starts [n_buckets + 1], int32), plus ``var_costs``
    [D, V+1].  ``heavy`` (:func:`heavy_variables` of ``offsets``, on the
    same device) gives the hubs a warp each in the kernel's walk;
    without it every variable is one thread.  One call of the kernel
    (two launches) on the card; the plain version on the CPU."""
    parts = tuple(f2v)
    sizes = _check(parts, perm, offsets, starts, var_costs, heavy)
    if var_costs.device.type == "cpu":
        return padded_table(*lane_sum_reference(parts, perm, offsets,
                                                starts, var_costs))
    return _launch(parts, sizes, perm, offsets, var_costs, heavy, False)


def lane_sum(f2v: Sequence[torch.Tensor], perm: torch.Tensor,
             offsets: torch.Tensor, starts: torch.Tensor,
             var_costs: torch.Tensor, heavy: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(beliefs, sums) [D, V+1] float32: the two halves of
    :func:`lane_sum_table`, as views of it."""
    table = lane_sum_table(f2v, perm, offsets, starts, var_costs, heavy)
    return table_halves(table, var_costs.shape[0])


def padded_table(beliefs: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    """The [V+1, 2P] row table of beliefs and sums [D, V+1]."""
    d, n_rows = beliefs.shape
    p = row_floats(d)
    table = torch.zeros((n_rows, 2 * p), dtype=beliefs.dtype,
                        device=beliefs.device)
    table[:, :d] = beliefs.t()
    table[:, p:p + d] = sums.t()
    return table


def table_halves(table: torch.Tensor, d: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(beliefs, sums) [D, V+1]: views of a [V+1, 2P] row table."""
    p = row_floats(d)
    return table[:, :d].t(), table[:, p:p + d].t()


def lane_beliefs(f2v: Sequence[torch.Tensor], perm: torch.Tensor,
                 offsets: torch.Tensor, starts: torch.Tensor,
                 var_costs: torch.Tensor, heavy: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The beliefs [D, V+1] float32 (a view of a [V+1, P] table) as the
    reference computes them where it keeps no sums: each variable's
    running sum from ``var_costs`` over its edges in the scatter order.
    Arguments as :func:`lane_sum_table`."""
    parts = tuple(f2v)
    sizes = _check(parts, perm, offsets, starts, var_costs, heavy)
    if var_costs.device.type == "cpu":
        return lane_beliefs_reference(parts, perm, offsets, starts,
                                      var_costs)
    return _launch(parts, sizes, perm, offsets, var_costs, heavy,
                   True)[:, :var_costs.shape[0]].t()
