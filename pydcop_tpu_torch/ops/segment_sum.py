"""The belief aggregation: CUDA kernel wrapper, placement plan and plain
version.

Sums every variable's incoming factor->variable messages in a fixed
order — edge order within a bucket, and across buckets the form XLA
gives the reference's jitted superstep (:func:`separate_buckets`; or,
in the ``one_sum`` mode of the ``sorted`` aggregation, one running sum
over every bucket's edges in CSR order) — and adds its own costs.
The reference's scatter branch of
``pydcop_tpu/ops/maxsum.py:389 aggregate_beliefs`` is jnp code, not a
Pallas kernel; on the card it is the hand-written kernel
``csrc/segment_sum.cu``, because torch's ``index_add_`` adds with
atomics in no fixed order there and the run would neither repeat
itself nor equal the CPU's.  On a CUDA tensor the wrapper launches the
kernel and raises if the launch fails; on a CPU tensor it runs the
plain version.

The kernel works tile by tile, one block each, as
:func:`aggregation_plan` cuts the variables at placement.
"""

import ctypes
import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pydcop_tpu_torch.ops import _build

KERNEL = "segment_sum"

# Threads per block of the tiled kernel (kThreads in the source): a
# light tile holds at most TILE_THREADS // D variables, one thread per
# (variable, slot).
TILE_THREADS = 256
# Message floats a block stages in shared memory per pass (24 KB, so
# eight blocks of 256 threads fit an SM): PASS_FLOATS // D edges.
PASS_FLOATS = 6144
# Variables of larger degree get a block of their own, first in the
# grid.  At 256 edges a variable's serial add chain (a 4-cycle FADD and
# a shared-memory load per edge, ~1-2k cycles) is as long as a light
# tile's whole life (one gather round trip to device memory plus a few
# adds each), so above it one variable would set its tile's length.
HEAVY_DEGREE = 256
# The kernel takes the buckets' base pointers in its parameters.
MAX_BUCKETS = 64

Messages = Union[torch.Tensor, Sequence[torch.Tensor]]


def pass_edges(d: int) -> int:
    """Edges per shared-memory pass of the tiled kernel at width D."""
    return max(1, PASS_FLOATS // d)


def aggregation_plan(offsets, d: int,
                     heavy_degree: int = HEAVY_DEGREE) -> np.ndarray:
    """The kernel's tiles, [T, 4] int32 rows (first variable, end
    variable, first edge, end edge), from the CSR ``offsets`` [V+2].

    The first rows are the heavy variables (degree above
    ``heavy_degree``), one tile each, largest degree first.  The rest
    are light tiles: runs of consecutive other variables, each at most
    ``TILE_THREADS // D`` variables, cut where the running edge count
    crosses a multiple of ``pass_edges(d) - heavy_degree`` so that a
    light tile's edges fit one pass.  Every variable, the sentinel row
    included, lies in exactly one tile; zero-degree variables are in
    light tiles."""
    offsets = np.asarray(offsets, dtype=np.int64)
    n = offsets.shape[0] - 1
    degree = np.diff(offsets)
    heavy = np.flatnonzero(degree > heavy_degree)
    heavy = heavy[np.argsort(-degree[heavy], kind="stable")]
    is_heavy = np.zeros(n + 1, bool)
    is_heavy[heavy] = True
    width = max(1, TILE_THREADS // d)
    window = max(1, pass_edges(d) - heavy_degree)
    cut = np.arange(n) % width == 0
    cut[1:] |= offsets[1:n] // window != offsets[:n - 1] // window
    cut |= is_heavy[:n]           # a heavy variable is a run of its own
    cut[1:] |= is_heavy[:n - 1]
    starts = np.flatnonzero(cut)
    ends = np.append(starts[1:], n)
    light = ~is_heavy[starts]
    first = np.concatenate([heavy, starts[light]])
    end = np.concatenate([heavy + 1, ends[light]])
    return np.stack([first, end, offsets[first], offsets[end]],
                    axis=1).astype(np.int32)


def separate_buckets(starts: Sequence[int], n_rows: int) -> int:
    """Which buckets the reference's jitted ``((0 + S0) + S1) + ...``
    sums on their own: bit b set means bucket b's edges are summed from
    zero and the result added to the running sums; clear, they are added
    into the running sums edge by edge.  ``starts`` are the buckets'
    first edges and then E; ``n_rows`` is V + 1.

    XLA's algebraic simplifier (jax 0.9.0, CPU) rewrites the chain of
    adds from the left: adding a bucket's scatter-add to a scatter
    merges the two into one scatter over the concatenated edges (one
    running sum) when together they hold fewer edges than ``n_rows``;
    otherwise the bucket stays a scatter of its own, summed from zero
    and added; and adding a bucket to such a sum scatters the bucket
    into it.  Without merges this is the odd/even form (odd buckets on
    their own).  The rule reproduced every shape probed against the
    reference's optimised HLO and sums (two to six buckets, D = 1, 3,
    5, merges on and off)."""
    sizes = np.diff(np.asarray(starts, dtype=np.int64))
    mask = 0
    into_scatter = True      # the running expression ends in a scatter
    edges = int(sizes[0]) if sizes.size else 0
    for b in range(1, sizes.size):
        e = int(sizes[b])
        if not into_scatter:
            into_scatter, edges = True, e
        elif edges + e < n_rows:
            edges += e
        else:
            mask |= 1 << b
            into_scatter = False
    return mask


def segment_sum_reference(msgs: torch.Tensor, perm: torch.Tensor,
                          offsets: torch.Tensor, buckets: torch.Tensor,
                          var_costs: torch.Tensor, one_sum: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The definition, in ``index_add_`` calls (each sequential in edge
    order on the CPU): bucket 0's edges are added into zeros; then,
    bucket by bucket, a bucket that :func:`separate_buckets` marks is
    summed into zeros of its own and added, and any other is added into
    the running sums — the form XLA gives the reference's jitted sum of
    per-bucket segment_sums.
    With ``one_sum`` every edge is added into the one running sum in
    edge order (the reference's ``sorted`` aggregation: its single
    segment_sum over the edges gathered into CSR order).  Then
    ``var_costs + sums``.  Each edge's variable is read back from the
    CSR arrays.  ``msgs`` is [E, D], every bucket's edges in bucket
    order.  Returns (beliefs, sums), both [V+1, D]."""
    n_seg, d = var_costs.shape
    dev = perm.device
    counts = (offsets[1:] - offsets[:-1]).to(torch.int64)
    seg = torch.empty(perm.shape, dtype=torch.int64, device=dev)
    seg[perm.to(torch.int64)] = torch.repeat_interleave(
        torch.arange(n_seg, device=dev), counts, output_size=perm.shape[0])
    if one_sum:
        sums = torch.zeros((n_seg, d), dtype=var_costs.dtype, device=dev)
        sums.index_add_(0, seg, msgs)
        return var_costs + sums, sums
    edge_bucket = torch.searchsorted(
        buckets, torch.arange(perm.shape[0], dtype=torch.int32, device=dev),
        right=True) - 1
    # Row n_seg takes the edges of the other buckets and is dropped.
    sums = torch.zeros((n_seg + 1, d), dtype=var_costs.dtype, device=dev)
    # Bucket 0 is never summed on its own: one bucket needs no host
    # read of the starts (so the plain version stays capturable in a
    # CUDA graph there).
    n_buckets = buckets.shape[0] - 1
    sep = separate_buckets(buckets.tolist(), n_seg) if n_buckets > 1 else 0
    for b in range(n_buckets):
        rows = torch.where(edge_bucket == b, seg, n_seg)
        if (sep >> b) & 1:
            part = torch.zeros_like(sums)
            part.index_add_(0, rows, msgs)
            sums = sums + part
        else:
            sums.index_add_(0, rows, msgs)
    sums = sums[:-1]
    return var_costs + sums, sums


def _check(parts, flat, perm, offsets, buckets, var_costs, tiles):
    dev = parts[0].device if parts else perm.device
    named = [("msgs", p, torch.float32) for p in parts] + [
        ("perm", perm, torch.int32), ("offsets", offsets, torch.int32),
        ("buckets", buckets, torch.int32),
        ("var_costs", var_costs, torch.float32)]
    if tiles is not None:
        named.append(("tiles", tiles, torch.int32))
    for name, t, dtype in named:
        if t.dtype != dtype:
            raise TypeError(f"segment_sum: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"segment_sum: {name} on {t.device} but "
                             f"msgs on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"segment_sum: {name} is not contiguous")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if var_costs.dim() != 2:
        raise ValueError(
            f"var_costs must be [V+1, D], got {tuple(var_costs.shape)}")
    n_seg, d = var_costs.shape
    n_edges = perm.shape[0] if perm.dim() == 1 else -1
    if flat:
        if tuple(parts[0].shape) != (n_edges, d):
            raise ValueError(
                f"msgs must be [E, D] = {(n_edges, d)} (E from perm), got "
                f"{tuple(parts[0].shape)} with perm {tuple(perm.shape)}")
    else:
        for p in parts:
            if p.dim() < 2 or p.shape[-1] != d:
                raise ValueError(
                    f"each bucket's messages must be [..., D] with D = {d},"
                    f" got {tuple(p.shape)}")
        total = sum(p.numel() // d for p in parts)
        if total != n_edges:
            raise ValueError(
                f"the buckets' messages hold {total} edges, perm "
                f"{tuple(perm.shape)}")
    if tuple(offsets.shape) != (n_seg + 1,):
        raise ValueError(
            f"offsets must be [V+2] = {(n_seg + 1,)}, got "
            f"{tuple(offsets.shape)}")
    if buckets.dim() != 1 or buckets.shape[0] < 2:
        raise ValueError(
            f"buckets must be [n_buckets + 1] edge starts, got "
            f"{tuple(buckets.shape)}")
    if not flat and len(parts) != buckets.shape[0] - 1:
        raise ValueError(
            f"{len(parts)} bucket tensors for {buckets.shape[0] - 1} "
            f"buckets")
    if tiles is not None and (tiles.dim() != 2 or tiles.shape[1] != 4):
        raise ValueError(
            f"tiles must be [T, 4], got {tuple(tiles.shape)}")


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load(KERNEL)
    fn = lib.segment_sum_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 5 + [ctypes.c_ulonglong]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _load_width(parts, d: int) -> int:
    """Floats per load: the widest of 4, 2, 1 that divides D and to
    whose size every bucket's base address is aligned."""
    for w in (4, 2):
        if d % w == 0 and all(p.data_ptr() % (4 * w) == 0 for p in parts):
            return w
    return 1


def segment_sum(msgs: Messages, perm: torch.Tensor,
                offsets: torch.Tensor, buckets: torch.Tensor,
                var_costs: torch.Tensor,
                tiles: Optional[torch.Tensor] = None,
                one_sum: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beliefs and sums [V+1, D] f32, in the order of
    :func:`segment_sum_reference` (``one_sum`` as there).

    ``msgs`` is either one [E, D] f32 tensor, every bucket's edges in
    bucket order, or the buckets' own f2v tensors in bucket order
    (each [..., D], e.g. [F, arity, D]), which the kernel reads where
    they lie.  perm [E] int32, offsets [V+2] int32, buckets
    [n_buckets + 1] int32, var_costs [V+1, D] f32; ``tiles`` is the
    placement plan of :func:`aggregation_plan` on the same device.

    For CUDA tensors it launches the kernel on the current stream; the
    card takes per-bucket tensors (one [E, D] tensor only for one
    bucket) and needs ``tiles``.  For CPU tensors it concatenates the
    buckets and runs the plain version."""
    flat = isinstance(msgs, torch.Tensor)
    parts = (msgs,) if flat else tuple(msgs)
    _check(parts, flat, perm, offsets, buckets, var_costs, tiles)
    if perm.device.type == "cpu":
        d = var_costs.shape[1]
        whole = parts[0] if flat else (
            parts[0].reshape(-1, d) if len(parts) == 1
            else torch.cat([p.reshape(-1, d) for p in parts]))
        return segment_sum_reference(whole, perm, offsets, buckets,
                                     var_costs, one_sum)
    n_seg, d = var_costs.shape
    n_buckets = buckets.shape[0] - 1
    if flat and n_buckets > 1:
        raise ValueError(
            f"segment_sum on the card reads each bucket where it lies: "
            f"pass the {n_buckets} buckets' tensors, not one [E, D] tensor")
    if n_buckets > MAX_BUCKETS:
        raise ValueError(f"{n_buckets} buckets: the kernel takes at most "
                         f"{MAX_BUCKETS}")
    if tiles is None:
        raise ValueError("segment_sum on the card needs the placement "
                         "plan (graph.agg_tiles)")
    if max([p.numel() for p in parts] + [perm.shape[0] * d,
                                         var_costs.numel()]) >= 2 ** 31:
        raise ValueError(
            f"graph too large for one launch: E={perm.shape[0]}, "
            f"V+1={n_seg}, D={d}")
    if perm.device.index != torch.cuda.current_device():
        with torch.cuda.device(perm.device):
            return segment_sum(msgs, perm, offsets, buckets, var_costs,
                               tiles, one_sum)
    sums = torch.empty_like(var_costs)
    beliefs = torch.empty_like(var_costs)
    if sums.numel() == 0:
        return beliefs, sums
    bases = (ctypes.c_void_p * n_buckets)(*(p.data_ptr() for p in parts))
    edge_starts = np.cumsum([0] + [p.numel() // d for p in parts]).tolist()
    starts = (ctypes.c_int * (n_buckets + 1))(*edge_starts)
    err = _launcher()(bases, starts, n_buckets, perm.data_ptr(),
                      offsets.data_ptr(), tiles.data_ptr(), tiles.shape[0],
                      var_costs.data_ptr(), sums.data_ptr(),
                      beliefs.data_ptr(), n_seg, d, _load_width(parts, d),
                      pass_edges(d), int(one_sum),
                      0 if one_sum else separate_buckets(edge_starts, n_seg),
                      torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {err}")
    _build.launch_counts[KERNEL] += 1
    return beliefs, sums
