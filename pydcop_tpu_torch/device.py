"""Device resolution and the on-device form of a compiled graph.

The device rule of the port: every entry point takes ``device=`` with
default ``"cuda"``.  When no CUDA card is present and the caller did
not ask for ``"cpu"``, :func:`resolve_device` raises — the port never
falls back to the CPU on its own.
"""

from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from pydcop_tpu_torch.engine.compile import CompiledFactorGraph

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device``, refusing a CUDA request on a
    host without a card."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(
            f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run "
            "on the CPU")
    return dev


class TorchFactorBucket(NamedTuple):
    costs: torch.Tensor    # [F, Dmax]*arity float32
    var_ids: torch.Tensor  # [F, arity] int64 (sentinel V on padding)


class TorchFactorGraph(NamedTuple):
    """``CompiledFactorGraph`` with every array a tensor on one device.
    ``var_ids`` is int64 (torch's index dtype); values are unchanged.

    ``agg_perm``/``agg_offsets`` index the edges — the flattened
    (bucket, factor, position) slots in bucket order — by variable,
    CSR-style: variable ``v``'s edges, in edge order, are
    ``agg_perm[agg_offsets[v]:agg_offsets[v + 1]]``.  The sentinel row
    V holds the padding edges like any other row.  ``agg_buckets``
    holds the edge index at which each bucket starts, then E.  The
    belief aggregation (``ops/segment_sum.py``) sums in this order."""

    var_costs: torch.Tensor   # [V+1, Dmax] float32
    var_valid: torch.Tensor   # [V+1, Dmax] bool
    buckets: Tuple[TorchFactorBucket, ...]
    agg_perm: torch.Tensor     # [E] int32
    agg_offsets: torch.Tensor  # [V+2] int32
    agg_buckets: torch.Tensor  # [n_buckets + 1] int32


def aggregation_arrays(buckets, n_segments: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(perm [E], offsets [n_segments + 1], bucket starts
    [len(buckets) + 1]) int32 for the edges of ``buckets`` (numpy
    ``var_ids`` arrays).  perm and offsets follow the numpy steps of the
    reference's ``build_aggregation_arrays`` (a stable argsort, then
    ``searchsorted`` starts and ends); ``offsets`` is the starts
    followed by the last end, which is E."""
    sizes = [np.asarray(ids).size for ids in buckets]
    seg = np.concatenate(
        [np.asarray(ids).reshape(-1) for ids in buckets]
    ) if buckets else np.zeros((0,), np.int32)
    perm = np.argsort(seg, kind="stable").astype(np.int32)
    sorted_seg = seg[perm]
    offsets = np.searchsorted(
        sorted_seg, np.arange(n_segments + 1), side="left"
    ).astype(np.int32)
    starts = np.cumsum([0] + sizes).astype(np.int32)
    return perm, offsets, starts


def to_device_graph(graph: CompiledFactorGraph,
                    device: DeviceLike = "cuda") -> TorchFactorGraph:
    """Move a host-compiled graph onto ``device`` (resolved by the
    device rule)."""
    dev = resolve_device(device)

    def put(arr, dtype):
        # A copy: the caller's arrays may be read-only or strided.
        return torch.tensor(np.asarray(arr), dtype=dtype, device=dev)

    perm, offsets, starts = aggregation_arrays(
        [b.var_ids for b in graph.buckets], graph.var_costs.shape[0])
    return TorchFactorGraph(
        var_costs=put(graph.var_costs, torch.float32),
        var_valid=put(graph.var_valid, torch.bool),
        buckets=tuple(
            TorchFactorBucket(put(b.costs, torch.float32),
                              put(b.var_ids, torch.int64))
            for b in graph.buckets),
        agg_perm=put(perm, torch.int32),
        agg_offsets=put(offsets, torch.int32),
        agg_buckets=put(starts, torch.int32),
    )
