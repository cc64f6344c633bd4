"""Device resolution and the on-device form of a compiled graph.

The device rule of the port: every entry point takes ``device=`` with
default ``"cuda"``.  When no CUDA card is present and the caller did
not ask for ``"cpu"``, :func:`resolve_device` raises — the port never
falls back to the CPU on its own.
"""

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from pydcop_tpu_torch.engine.compile import CompiledFactorGraph
from pydcop_tpu_torch.ops.segment_sum import aggregation_plan

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


# Widest domain whose per-edge validity fits one byte (``edge_valid``).
EDGE_VALID_MAX_D = 8


class TorchFactorBucket(NamedTuple):
    """One bucket on the device.  ``var_ids32`` holds ``var_ids``'s
    values as int32 and ``edge_valid`` each edge's valid slots as bits
    (bit k of ``[f, p]`` is ``var_valid[var_ids[f, p], k]``), ``None``
    above ``EDGE_VALID_MAX_D``: what ``ops/var_update.py``'s kernel
    reads instead of int64 indices and ``var_valid`` rows.  Both are
    built from the host arrays in :func:`to_device_graph`, the one place
    a bucket is placed; ``var_valid`` never changes on a placed graph."""

    costs: torch.Tensor    # [F, Dmax]*arity float32
    var_ids: torch.Tensor  # [F, arity] int64 (sentinel V on padding)
    var_ids32: torch.Tensor  # [F, arity] int32, the same values
    edge_valid: Optional[torch.Tensor]  # [F, arity] uint8 bits (D <= 8)


class TorchFactorGraph(NamedTuple):
    """``CompiledFactorGraph`` with every array a tensor on one device.
    ``var_ids`` is int64 (torch's index dtype); values are unchanged.

    ``agg_perm``/``agg_offsets`` index the edges — the flattened
    (bucket, factor, position) slots in bucket order — by variable,
    CSR-style: variable ``v``'s edges, in edge order, are
    ``agg_perm[agg_offsets[v]:agg_offsets[v + 1]]``.  The sentinel row
    V holds the padding edges like any other row.  ``agg_buckets``
    holds the edge index at which each bucket starts, then E.  The
    belief aggregation (``ops/segment_sum.py``) sums in this order.
    ``agg_tiles`` is its kernel's plan (``aggregation_plan``): the heavy
    variables' tiles first, then the light tiles, each row (first
    variable, end variable, first edge, end edge).

    ``agg_strategy`` names the belief aggregation the graph was compiled
    for (``engine.compile.AGGREGATIONS``).  ``scatter`` and ``sorted``
    both sum through ``segment_sum`` on the CSR arrays (``sorted`` as
    one running sum per variable over every bucket, whose edge order is
    the compiled graph's ``agg_perm``: the same array as ``agg_perm``
    here); ``boundary`` takes its starts and ends from ``agg_offsets``;
    ``ell`` reads ``agg_ell``, the compiled graph's [V+1, K] lists."""

    var_costs: torch.Tensor   # [V+1, Dmax] float32
    var_valid: torch.Tensor   # [V+1, Dmax] bool
    buckets: Tuple[TorchFactorBucket, ...]
    agg_perm: torch.Tensor     # [E] int32
    agg_offsets: torch.Tensor  # [V+2] int32
    agg_buckets: torch.Tensor  # [n_buckets + 1] int32
    agg_tiles: torch.Tensor    # [T, 4] int32
    agg_strategy: str = "scatter"
    agg_ell: Optional[torch.Tensor] = None  # [V+1, K] int32 (ell only)


def aggregation_strategy(graph: CompiledFactorGraph) -> str:
    """The strategy whose ``agg_*`` arrays a compiled graph carries."""
    if graph.agg_ell is not None:
        return "ell"
    if graph.agg_starts is not None:
        return "boundary"
    if graph.agg_sorted_seg is not None:
        return "sorted"
    return "scatter"


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


def edge_valid_bits(var_valid: np.ndarray,
                    var_ids: np.ndarray) -> Optional[np.ndarray]:
    """[F, arity] uint8 whose bit k is ``var_valid[var_ids[f, p], k]``,
    or ``None`` when the domain is wider than ``EDGE_VALID_MAX_D``."""
    var_valid = np.asarray(var_valid, bool)
    if var_valid.shape[1] > EDGE_VALID_MAX_D:
        return None
    rows = np.packbits(var_valid, axis=1, bitorder="little")[:, 0]
    return rows[np.asarray(var_ids)]


def to_device_graph(graph: CompiledFactorGraph,
                    device: DeviceLike = "cuda") -> TorchFactorGraph:
    """Move a host-compiled graph onto ``device`` (resolved by the
    device rule), with its aggregation strategy and arrays."""
    dev = resolve_device(device)

    def put(arr, dtype):
        # A copy: the caller's arrays may be read-only or strided.
        return torch.tensor(np.asarray(arr), dtype=dtype, device=dev)

    perm, offsets, starts = aggregation_arrays(
        [b.var_ids for b in graph.buckets], graph.var_costs.shape[0])
    tiles = aggregation_plan(offsets, graph.var_costs.shape[1])

    def bucket(b):
        bits = edge_valid_bits(graph.var_valid, b.var_ids)
        return TorchFactorBucket(
            put(b.costs, torch.float32), put(b.var_ids, torch.int64),
            put(b.var_ids, torch.int32),
            None if bits is None else put(bits, torch.uint8))

    return TorchFactorGraph(
        var_costs=put(graph.var_costs, torch.float32),
        var_valid=put(graph.var_valid, torch.bool),
        buckets=tuple(bucket(b) for b in graph.buckets),
        agg_perm=put(perm, torch.int32),
        agg_offsets=put(offsets, torch.int32),
        agg_buckets=put(starts, torch.int32),
        agg_tiles=put(tiles, torch.int32),
        agg_strategy=aggregation_strategy(graph),
        agg_ell=(None if graph.agg_ell is None
                 else put(graph.agg_ell, torch.int32)),
    )
