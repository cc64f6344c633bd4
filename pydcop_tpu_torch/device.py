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
from pydcop_tpu_torch.ops.segment_sum import (
    aggregation_plan,
    positional_fold,
)

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
    (bucket, factor, position) slots of the buckets taken in the order
    ``agg_order`` — by variable, CSR-style: variable ``v``'s edges, in
    edge order, are ``agg_perm[agg_offsets[v]:agg_offsets[v + 1]]``.
    The sentinel row V holds the padding edges like any other row.
    ``agg_buckets`` holds the edge index at which each bucket of that
    order starts, then E.  The belief aggregation
    (``ops/segment_sum.py``) sums in this order, bit i of ``agg_sep``
    marking the i-th bucket of ``agg_order`` as summed on its own.
    Under ``scatter`` the order and mask are
    ``segment_sum.positional_fold``'s over the buckets' edge counts (the
    order XLA adds the reference's per-bucket segment_sums in: a
    one-edge bucket can move); under the other strategies, and whenever
    no bucket moves, ``agg_order`` is the bucket order.
    ``agg_tiles`` is its kernel's plan (``aggregation_plan``): the heavy
    variables' tiles first, then the light tiles, each row (first
    variable, end variable, first edge, end edge).

    ``agg_strategy`` names the belief aggregation the graph was compiled
    for (``engine.compile.AGGREGATIONS``).  ``scatter`` and ``sorted``
    both sum through ``segment_sum`` on the CSR arrays (``sorted`` as
    one running sum per variable over every bucket, whose edge order is
    the compiled graph's ``agg_perm``: the same array as ``agg_perm``
    here); ``boundary`` takes its starts and ends from ``agg_offsets``;
    ``ell`` reads ``agg_ell``, the compiled graph's [V+1, K] lists.

    ``pos_perm`` orders the same edges by variable in the local search's
    positional order — unit by unit, factor by factor — for its
    candidate-cost sum (``segment_sum.positional_sum``): a variable's
    edges are ``pos_perm[agg_offsets[v]:agg_offsets[v + 1]]`` (the same
    count as in edge order, so the offsets and the tile plan serve
    both).  The units are the (bucket, position) pairs, numbered in
    bucket order, then position, and taken in the order ``pos_order``
    (``segment_sum.positional_fold``: the order XLA adds the
    reference's); ``pos_units`` holds the positional index at which each
    unit of that order starts, then E, and bit i of ``pos_sep`` marks
    the i-th unit as summed on its own.  ``pos_mid`` [V+1] int32, for
    two units only, is where each variable's edges of the second unit
    start in ``pos_perm``; ``pos_other`` [E] int32, when a bucket is
    binary, is for each of ``pos_perm``'s slots the other variable of
    a binary factor's edge (0 for the edges of other arities): the
    fused candidate-cost sum reads the cost tables through them."""

    var_costs: torch.Tensor   # [V+1, Dmax] float32
    var_valid: torch.Tensor   # [V+1, Dmax] bool
    buckets: Tuple[TorchFactorBucket, ...]
    agg_perm: torch.Tensor     # [E] int32
    agg_offsets: torch.Tensor  # [V+2] int32
    agg_buckets: torch.Tensor  # [n_buckets + 1] int32
    agg_tiles: torch.Tensor    # [T, 4] int32
    agg_strategy: str = "scatter"
    agg_ell: Optional[torch.Tensor] = None  # [V+1, K] int32 (ell only)
    agg_order: Tuple[int, ...] = ()
    agg_sep: int = 0
    pos_perm: Optional[torch.Tensor] = None   # [E] int32
    pos_units: Optional[torch.Tensor] = None  # [n_units + 1] int32
    pos_order: Tuple[int, ...] = ()
    pos_sep: int = 0
    pos_mid: Optional[torch.Tensor] = None    # [V+1] int32 (two units)
    pos_other: Optional[torch.Tensor] = None  # [E] int32 (binary buckets)


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


class PositionalArrays(NamedTuple):
    """The positional sum's placement arrays (numpy), as
    ``TorchFactorGraph``'s ``pos_*`` fields describe them."""

    perm: np.ndarray                # [E] int32
    starts: np.ndarray              # [n_units + 1] int32
    order: Tuple[int, ...]
    sep: int
    mid: Optional[np.ndarray]       # [V+1] int32 (two units)
    other: Optional[np.ndarray]     # [E] int32 (a binary bucket)


def positional_arrays(buckets, n_rows: int) -> PositionalArrays:
    """The positional edge order of ``buckets`` (numpy ``var_ids``
    arrays) over ``n_rows`` = V + 1 variables: unit (b, p) holds
    ``var_ids[:, p]`` of bucket b; the units are taken in
    ``positional_fold``'s order and perm is the stable argsort of their
    variables."""
    ids = [np.asarray(b) for b in buckets]
    cols = [(b, p) for b, v in enumerate(ids) for p in range(v.shape[1])]
    order, sep = positional_fold([ids[b].shape[0] for b, _ in cols],
                                 n_rows)
    cols = [cols[u] for u in order]
    seg = (np.concatenate([ids[b][:, p] for b, p in cols]) if cols
           else np.zeros((0,), np.int32))
    perm = np.argsort(seg, kind="stable").astype(np.int32)
    sizes = [ids[b].shape[0] for b, _ in cols]
    starts = np.cumsum([0] + sizes).astype(np.int32)
    mid = None
    if len(cols) == 2:
        counts = np.bincount(seg, minlength=n_rows)
        first = np.bincount(seg[:sizes[0]], minlength=n_rows)
        mid = (np.cumsum(counts) - counts + first).astype(np.int32)
    other = None
    if any(v.shape[1] == 2 for v in ids):
        other = np.concatenate([
            ids[b][:, 1 - p] if ids[b].shape[1] == 2
            else np.zeros(ids[b].shape[0], ids[b].dtype)
            for b, p in cols])[perm].astype(np.int32)
    return PositionalArrays(perm, starts, order, sep, mid, other)


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

    n_rows = graph.var_costs.shape[0]
    strategy = aggregation_strategy(graph)
    order = tuple(range(len(graph.buckets)))
    sep = 0
    if strategy == "scatter":
        order, sep = positional_fold(
            [b.var_ids.size for b in graph.buckets], n_rows)
    perm, offsets, starts = aggregation_arrays(
        [graph.buckets[b].var_ids for b in order], n_rows)
    tiles = aggregation_plan(offsets, graph.var_costs.shape[1])
    pos = positional_arrays([b.var_ids for b in graph.buckets], n_rows)

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
        agg_strategy=strategy,
        agg_ell=(None if graph.agg_ell is None
                 else put(graph.agg_ell, torch.int32)),
        agg_order=order,
        agg_sep=sep,
        pos_perm=put(pos.perm, torch.int32),
        pos_units=put(pos.starts, torch.int32),
        pos_order=pos.order,
        pos_sep=pos.sep,
        pos_mid=None if pos.mid is None else put(pos.mid, torch.int32),
        pos_other=(None if pos.other is None
                   else put(pos.other, torch.int32)),
    )
