"""The partitioned MaxSum engine's device side: mesh, per-shard layout,
halo exchange.

Port of the partitioned half of ``pydcop_tpu/engine/sharding.py``
(``build_partitioned_graph`` and ``ShardOps``, the ``shards=`` path).  A
host-side min-edge-cut partition (``engine/partition.py``) assigns
variables AND factors to shards; each shard owns a local slice of the
variable tables and the messages of its own factors, interior message
updates are purely local, and only HALO variables — endpoints of cut
edges — are exchanged per superstep through a compacted ``[B, D]``
boundary buffer.  The boundary partial sums of the messages just sent
are reduced at the tail of superstep *t* into the halo slot that
superstep *t+1* consumes at its head (the variable side always reads
the previous cycle's factor messages, so the slot holds exactly their
boundary totals).

**The mesh is a list of torch devices** (:class:`Mesh`), driven by one
process.  The reference runs one SPMD program on every device of a
``shard_map``; here each shard's local graph and messages live on that
shard's device and the superstep runs shard by shard, each shard's
graph placed by ``device.to_device_graph`` from the shard's own local
arrays at the padded local shapes (so the belief sum's fold, the
positional order and every per-edge placement array are those XLA
compiles for the shard's program).  The cross-shard ``psum``s are
explicit reductions in the reference's all-reduce order:
``ops/halo_sum.py`` for the halo and the traced costs (``csrc/halo_sum.cu``
on the card), exact integer scatters for the boundary values, a boolean
AND for the global ``stable``.  A mesh may name one device more than
once: that is how one card (or the CPU) runs S shards.  No
``torch.distributed``: a mesh across processes is not ported
(``engine/multihost.py``).

State crosses segment boundaries stacked: every message field is one
``[S, F, arity, D]`` tensor on the mesh's first device (the reference's
blocked layout, so a snapshot's leaves are the reference's), split into
per-shard views at the start of a run and stacked again at its end.

``shard_graph`` (the replicated-variable path of ``n_devices=``/``mesh=``)
is not ported: it raises, naming ROADMAP.md Queue A item 6(b).
"""

import os
import re
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.device import (
    DeviceLike,
    TorchFactorGraph,
    resolve_device,
    to_device_graph,
)
from pydcop_tpu_torch.engine.compile import (
    BIG,
    CompiledFactorGraph,
    FactorBucket,
)
from pydcop_tpu_torch.engine.partition import Partition, real_factor_rows
from pydcop_tpu_torch.ops import maxsum as maxsum_ops
from pydcop_tpu_torch.ops.flush import ftz
from pydcop_tpu_torch.ops.halo_sum import halo_sum
from pydcop_tpu_torch.ops.segment_sum import aggregation_plan, subset_sum
from pydcop_tpu_torch.ops.var_update import send_update, v2f_update
from pydcop_tpu_torch.ops.window_sum import window_total

# Where the replicated-variable path stands.
REPLICATED_NOT_PORTED = (
    "replicated-variable sharding (n_devices=/mesh=, engine/sharding."
    "shard_graph) is not ported yet (ROADMAP.md, Queue A item 6(b)); "
    "the partitioned engine (shards=) is")


class Mesh(NamedTuple):
    """A 1-D mesh: one torch device per shard, in shard (rank) order.
    A device may appear more than once."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def host_device_count() -> int:
    """How many devices the CPU counts as: the reference's count under
    the same environment — ``--xla_force_host_platform_device_count=N``
    in ``XLA_FLAGS`` (what the repo's test configuration sets), else 1."""
    m = re.search(r"--xla_force_host_platform_device_count=(\d+)",
                  os.environ.get("XLA_FLAGS", ""))
    return int(m.group(1)) if m else 1


def available_devices(device: DeviceLike = "cuda") -> List[torch.device]:
    """The devices a mesh over ``device``'s kind can use: every CUDA
    card, or the CPU :func:`host_device_count` times (resolved by the
    device rule: no card and not ``"cpu"`` raises)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * host_device_count()


def make_mesh(n_devices: Optional[int] = None, devices=None,
              device: DeviceLike = "cuda") -> Mesh:
    """A 1-D mesh over (the first n of) ``devices``, default the
    available devices of ``device``'s kind."""
    if devices is None:
        devices = available_devices(device)
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"Requested {n_devices} devices but only "
                f"{len(devices)} available"
            )
        devices = devices[:n_devices]
    for d in devices:
        resolve_device(d)
    # A bare "cuda" names the current card.
    return Mesh(tuple(
        torch.device("cuda", torch.cuda.current_device())
        if d.type == "cuda" and d.index is None else d for d in devices))


def shard_graph(graph, mesh):
    """The replicated-variable placement: not ported."""
    raise NotImplementedError(REPLICATED_NOT_PORTED)


# --------------------------------------------------------------------- #
# Partitioned layout.


class ShardBucket(NamedTuple):
    """One arity bucket, stacked per shard: leading axis S, var_ids in
    the shard-LOCAL variable index space (host numpy)."""

    costs: np.ndarray     # [S, F, Dmax]*arity
    var_ids: np.ndarray   # [S, F, arity] int32, local L-space


class LocalShard(NamedTuple):
    """One shard's placed block on its device: the local graph and the
    index plumbing of its halo exchange."""

    device: torch.device
    graph: TorchFactorGraph      # local L-space, scatter aggregation
    bnd_rows: torch.Tensor       # [k] int64: local slots of present bnd vars
    bnd_index: torch.Tensor      # [k] int64: their boundary indices
    part_perm: torch.Tensor      # [Eb] int32: boundary edges by bnd index
    part_offsets: torch.Tensor   # [B+1] int32
    part_tiles: torch.Tensor     # [T, 4] int32
    part_zeros: torch.Tensor     # [B, D] float32 zeros
    owner_rows: torch.Tensor     # [m] int64: local slots of owned bnd vars
    owner_index: torch.Tensor    # [m] int64: their boundary indices
    halo_bnd: torch.Tensor       # [H] int64 (B on padding)
    local_global: torch.Tensor   # [L-1] int64 (V on padding)


class ShardedGraph(NamedTuple):
    """Partitioned layout.  The reference's fields, host numpy arrays
    with a leading shard axis S (``tests/test_torch_sharding.py`` holds
    them ``np.array_equal`` to the reference's), plus ``shards``, each
    shard's block placed on its device.

    Local variable index space per shard (size ``L``): slots
    ``[0, V_loc)`` hold OWNED variables (padded across shards to the
    max owned count), ``[V_loc, V_loc + H)`` hold HALO variables (owned
    elsewhere, referenced by local factors; cost rows are copies of the
    owner's rows so beliefs compute identically), and slot ``L-1`` is
    the sentinel absorbing padding edges.  The boundary buffer covers
    the B variables that are halo for at least one shard."""

    var_costs: np.ndarray     # [S, L, D] f32
    var_valid: np.ndarray     # [S, L, D] bool
    buckets: Tuple[ShardBucket, ...]
    local_global: np.ndarray  # [S, L-1] int32: global id per local slot
    bnd_local: np.ndarray     # [S, B] int32: local slot of bnd var b
    bnd_present: np.ndarray   # [S, B] bool: shard holds a slot for b
    bnd_owner: np.ndarray     # [S, B] bool: shard owns b
    halo_bnd: np.ndarray      # [S, H] int32: bnd index of halo slot h
    bnd_edge_idx: np.ndarray  # [S, Eb] int32: flat f2v index of bnd edges
    bnd_edge_seg: np.ndarray  # [S, Eb] int32: bnd index of that edge
    shards: Tuple[LocalShard, ...] = ()

    @property
    def n_shards(self) -> int:
        return self.var_costs.shape[0]

    @property
    def dmax(self) -> int:
        return self.var_costs.shape[-1]

    @property
    def n_boundary(self) -> int:
        return self.bnd_local.shape[-1]

    @property
    def v_loc(self) -> int:
        return self.local_global.shape[-1] - self.halo_bnd.shape[-1]


class ShardedMaxSumState(NamedTuple):
    """MaxSum state of the partitioned engine.  Messages are stacked
    per shard ([S, F, arity, D], one tensor per bucket on the mesh's
    first device); ``halo`` is the boundary-sum slot (the reduced
    totals of the CURRENT ``f2v`` messages); ``stable`` is the global
    verdict and ``cycle`` the cycle count.  The leaves are the
    reference's, in its order."""

    v2f: Tuple[torch.Tensor, ...]
    f2v: Tuple[torch.Tensor, ...]
    v2f_count: Tuple[torch.Tensor, ...]
    f2v_count: Tuple[torch.Tensor, ...]
    halo: torch.Tensor      # [B, D] f32
    stable: torch.Tensor    # 0-d bool
    cycle: torch.Tensor     # 0-d int32


def partitioned_layout(graph: CompiledFactorGraph, part: Partition,
                       n_shards: int) -> Tuple[ShardedGraph, Dict[str, Any]]:
    """The host half of :func:`build_partitioned_graph`: the reference's
    arrays (numpy, step for step) and its communication metrics, no
    shard placed yet (:func:`place_partitioned` places them)."""
    if part.n_shards != n_shards:
        raise ValueError(
            f"partition has {part.n_shards} shards but mesh has "
            f"{n_shards} devices")
    n_vars = graph.n_vars
    d = graph.dmax
    var_shard = part.var_shard
    var_costs = np.asarray(graph.var_costs)
    var_valid = np.asarray(graph.var_valid)

    owned = [np.nonzero(var_shard == s)[0] for s in range(n_shards)]
    # Per-bucket real rows + their shard assignment (padding rows of
    # the input graph are dropped; per-shard padding is rebuilt).
    bucket_rows = []
    for b, fs in zip(graph.buckets, part.factor_shard):
        ids = np.asarray(b.var_ids)
        rows = real_factor_rows(ids, n_vars)
        if rows.shape[0] != fs.shape[0]:
            raise ValueError(
                "partition factor assignment does not match the "
                f"graph ({rows.shape[0]} real factors vs "
                f"{fs.shape[0]} assigned)")
        bucket_rows.append((ids, np.asarray(b.costs), rows, fs))

    halo = []
    for s in range(n_shards):
        touched: list = []
        for ids, _, rows, fs in bucket_rows:
            sel = rows[fs == s]
            if sel.size:
                touched.append(np.unique(ids[sel]))
        all_touched = (np.unique(np.concatenate(touched))
                       if touched else np.zeros((0,), np.int64))
        halo.append(np.setdiff1d(all_touched, owned[s]))

    v_loc = max((len(o) for o in owned), default=0)
    v_loc = max(v_loc, 1)
    n_halo = max((len(h) for h in halo), default=0)
    L = v_loc + n_halo + 1

    bnd_list = (np.unique(np.concatenate(halo))
                if any(h.size for h in halo)
                else np.zeros((0,), np.int64))
    n_bnd = len(bnd_list)
    bnd_of = np.full(n_vars + 1, n_bnd, np.int64)
    bnd_of[bnd_list] = np.arange(n_bnd)

    s_var_costs = np.full((n_shards, L, d), BIG, var_costs.dtype)
    s_var_valid = np.zeros((n_shards, L, d), bool)
    s_local_global = np.full((n_shards, L - 1), n_vars, np.int32)
    s_bnd_local = np.full((n_shards, max(n_bnd, 0)), L - 1, np.int32)
    s_bnd_present = np.zeros((n_shards, n_bnd), bool)
    s_bnd_owner = np.zeros((n_shards, n_bnd), bool)
    s_halo_bnd = np.full((n_shards, n_halo), n_bnd, np.int32)

    local_of = np.full((n_shards, n_vars + 1), L - 1, np.int64)
    for s in range(n_shards):
        o, h = owned[s], halo[s]
        local_of[s, o] = np.arange(len(o))
        local_of[s, h] = v_loc + np.arange(len(h))
        rows = np.concatenate([o, h]).astype(np.int64)
        slots = local_of[s, rows]
        s_var_costs[s, slots] = var_costs[rows]
        s_var_valid[s, slots] = var_valid[rows]
        s_local_global[s, slots] = rows
        if n_bnd:
            s_bnd_local[s] = local_of[s, bnd_list]
            s_bnd_present[s] = s_bnd_local[s] != (L - 1)
            s_bnd_owner[s] = var_shard[bnd_list] == s
        if len(h):
            s_halo_bnd[s, :len(h)] = bnd_of[h]

    # Per-bucket local layouts, padded to the max per-shard factor
    # count so the stacked arrays are rectangular.
    buckets = []
    bucket_pad_counts = []
    flat_offsets = []
    offset = 0
    for ids, costs, rows, fs in bucket_rows:
        arity = ids.shape[1]
        counts = [int((fs == s).sum()) for s in range(n_shards)]
        f_max = max(counts + [0])
        s_costs = np.zeros((n_shards, f_max) + costs.shape[1:],
                           costs.dtype)
        s_ids = np.full((n_shards, f_max, arity), L - 1, np.int32)
        for s in range(n_shards):
            sel = rows[fs == s]
            k = sel.shape[0]
            if k:
                s_costs[s, :k] = costs[sel]
                s_ids[s, :k] = local_of[s][ids[sel]]
        buckets.append(ShardBucket(costs=s_costs, var_ids=s_ids))
        bucket_pad_counts.append(f_max)
        flat_offsets.append(offset)
        offset += f_max * arity
    total_edges = offset

    # Boundary-incident edges per shard, in the flat f2v order (bucket
    # order, row-major [F, arity]): the halo partial sums aggregate
    # ONLY these edges, never the interior ones.
    is_bnd_slot = np.zeros((n_shards, L), bool)
    for s in range(n_shards):
        if n_bnd:
            pres = s_bnd_present[s]
            is_bnd_slot[s, s_bnd_local[s][pres]] = True
    edge_idx = [[] for _ in range(n_shards)]
    edge_seg = [[] for _ in range(n_shards)]
    slot_bnd = np.full((n_shards, L), n_bnd, np.int64)
    for s in range(n_shards):
        if n_bnd:
            pres = s_bnd_present[s]
            slot_bnd[s, s_bnd_local[s][pres]] = np.nonzero(pres)[0]
    for bi, bucket in enumerate(buckets):
        for s in range(n_shards):
            lids = bucket.var_ids[s].reshape(-1)
            sel = np.nonzero(is_bnd_slot[s][lids])[0]
            edge_idx[s].append(flat_offsets[bi] + sel)
            edge_seg[s].append(slot_bnd[s][lids[sel]])
    e_max = 0
    for s in range(n_shards):
        edge_idx[s] = (np.concatenate(edge_idx[s])
                       if edge_idx[s] else np.zeros((0,), np.int64))
        edge_seg[s] = (np.concatenate(edge_seg[s])
                       if edge_seg[s] else np.zeros((0,), np.int64))
        e_max = max(e_max, edge_idx[s].shape[0])
    s_edge_idx = np.zeros((n_shards, e_max), np.int32)
    s_edge_seg = np.full((n_shards, e_max), n_bnd, np.int32)
    for s in range(n_shards):
        k = edge_idx[s].shape[0]
        s_edge_idx[s, :k] = edge_idx[s]
        s_edge_seg[s, :k] = edge_seg[s]

    sharded = ShardedGraph(
        var_costs=s_var_costs,
        var_valid=s_var_valid,
        buckets=tuple(buckets),
        local_global=s_local_global,
        bnd_local=s_bnd_local,
        bnd_present=s_bnd_present,
        bnd_owner=s_bnd_owner,
        halo_bnd=s_halo_bnd,
        bnd_edge_idx=s_edge_idx,
        bnd_edge_seg=s_edge_seg,
    )
    # Communication accounting: what one superstep moves between
    # shards on each path.  The partitioned exchange is the [B, D]
    # halo reduction (+ one scalar convergence flag); the replicated
    # baseline all-reduces the dense [V+1, D] totals.
    metrics = {
        **part.stats,
        "halo_exchange_elems_per_superstep": n_bnd * d,
        "replicated_allreduce_elems_per_superstep": (n_vars + 1) * d,
        "halo_exchange_bytes_per_superstep": n_bnd * d * 4,
        "replicated_allreduce_bytes_per_superstep":
            (n_vars + 1) * d * 4,
        "boundary_edges_per_shard_max": int(e_max),
        "local_factor_rows_per_shard": list(bucket_pad_counts),
        "total_flat_edges": int(total_edges),
    }
    return sharded, metrics


def local_graph(sharded: ShardedGraph, s: int) -> CompiledFactorGraph:
    """Shard ``s``'s block as a compiled graph over its local L-space
    (scatter aggregation: local graphs carry no ``agg_*`` arrays)."""
    return CompiledFactorGraph(
        var_costs=sharded.var_costs[s],
        var_valid=sharded.var_valid[s],
        buckets=tuple(FactorBucket(b.costs[s], b.var_ids[s])
                      for b in sharded.buckets),
    )


def _place_shard(sharded: ShardedGraph, s: int,
                 dev: torch.device) -> LocalShard:
    """Place shard ``s``'s block on ``dev``."""
    n_bnd = sharded.n_boundary
    d = sharded.dmax

    def put(arr, dtype):
        return torch.tensor(np.asarray(arr), dtype=dtype, device=dev)

    present = np.nonzero(sharded.bnd_present[s])[0]
    owner = np.nonzero(sharded.bnd_owner[s])[0]
    seg = sharded.bnd_edge_seg[s].astype(np.int64)
    real = seg < n_bnd
    idx = sharded.bnd_edge_idx[s][real]
    seg = seg[real]
    # Stable by boundary index: edge order within each (the scatter's
    # update order).
    order = np.argsort(seg, kind="stable")
    offsets = np.searchsorted(seg[order], np.arange(n_bnd + 1),
                              side="left").astype(np.int32)
    return LocalShard(
        device=dev,
        graph=to_device_graph(local_graph(sharded, s), dev),
        bnd_rows=put(sharded.bnd_local[s][present], torch.int64),
        bnd_index=put(present, torch.int64),
        part_perm=put(idx[order], torch.int32),
        part_offsets=put(offsets, torch.int32),
        part_tiles=put(aggregation_plan(offsets, d), torch.int32),
        part_zeros=torch.zeros((n_bnd, d), dtype=torch.float32, device=dev),
        owner_rows=put(sharded.bnd_local[s][owner], torch.int64),
        owner_index=put(owner, torch.int64),
        halo_bnd=put(sharded.halo_bnd[s], torch.int64),
        local_global=put(sharded.local_global[s], torch.int64),
    )


def build_partitioned_graph(graph: CompiledFactorGraph, part: Partition,
                            mesh: Mesh
                            ) -> Tuple[ShardedGraph, Dict[str, Any]]:
    """Materialize the per-shard layout for a partition: local variable
    tables (owned + halo + sentinel), locally-reindexed factor buckets
    and the boundary-exchange index arrays (the reference's host arrays),
    each shard's block placed on its mesh device.  Returns the
    ShardedGraph plus the metrics dict (partition stats + communication
    accounting)."""
    sharded, metrics = partitioned_layout(graph, part, mesh.size)
    return place_partitioned(sharded, mesh), metrics


def place_partitioned(sharded: ShardedGraph, mesh: Mesh) -> ShardedGraph:
    """``sharded``'s host layout placed block by block on ``mesh`` (of
    its shard count): the same layout on another mesh, e.g. the CPU's
    beside the card's, without partitioning again."""
    if mesh.size != sharded.n_shards:
        raise ValueError(f"layout has {sharded.n_shards} shards but mesh "
                         f"has {mesh.size} devices")
    return sharded._replace(shards=tuple(
        _place_shard(sharded, s, dev) for s, dev in enumerate(mesh.devices)))


# --------------------------------------------------------------------- #
# The shard-local superstep and its exchanges.


class _Local(NamedTuple):
    """One shard's messages during a run (views or copies of the stacked
    state's blocks, on the shard's device)."""

    v2f: Tuple[torch.Tensor, ...]
    f2v: Tuple[torch.Tensor, ...]
    v2f_count: Tuple[torch.Tensor, ...]
    f2v_count: Tuple[torch.Tensor, ...]


def _combine_halo(sh: LocalShard, beliefs: torch.Tensor,
                  sums: torch.Tensor, halo: torch.Tensor):
    """Overwrite the boundary rows of the local sums with the exchanged
    totals, and their beliefs with own costs + those totals (the
    reference's ``sums.at[bnd_local].set(...)`` and ``var_costs +
    sums``; absent boundary variables are skipped, which is what its
    write of the sentinel row onto itself amounts to)."""
    if sh.bnd_rows.numel() == 0:
        return beliefs, sums
    rows = halo[sh.bnd_index]
    sums = sums.index_put((sh.bnd_rows,), rows)
    beliefs = beliefs.index_put(
        (sh.bnd_rows,), ftz(sh.graph.var_costs[sh.bnd_rows] + rows))
    return beliefs, sums


def _local_beliefs(sh: LocalShard, f2v, halo: torch.Tensor, n_bnd: int):
    """(beliefs, sums) [L, D] of one shard: the local scatter sums
    (``ops.maxsum.aggregate_beliefs`` on the local graph) with the halo
    rows combined in."""
    beliefs, sums = maxsum_ops.aggregate_beliefs(sh.graph, f2v)
    if n_bnd:
        beliefs, sums = _combine_halo(sh, beliefs, sums, halo)
    return beliefs, sums


def _boundary_partial(sh: LocalShard, f2v) -> torch.Tensor:
    """[B, D] this shard's sums of its boundary edges' f2v messages
    (``segment_sum.subset_sum``, the buckets read in place)."""
    return subset_sum(f2v, sh.part_perm, sh.part_offsets, sh.part_tiles,
                      sh.part_zeros)


def _superstep_local(sh: LocalShard, loc: _Local, halo: torch.Tensor,
                     cycle: torch.Tensor, *, damping: float,
                     damp_vars: bool, damp_factors: bool,
                     stability: float, n_bnd: int, prune=None):
    """One partitioned superstep on one shard's block: the semantics of
    ``ops.maxsum.superstep`` (Jacobi BSP, damping, SAME_COUNT
    send-suppression) with the variable side's sums combined with the
    halo slot of the previous superstep.  Returns the new messages and
    this shard's all-match flag (``cycle != 0`` ANDed with every
    bucket's)."""
    g = sh.graph
    stable = cycle != 0
    f2v_cand = maxsum_ops.factor_to_var(g, loc.v2f, prune=prune)
    beliefs, sums = _local_beliefs(sh, loc.f2v, halo, n_bnd)
    # The halo rows are written into the sums (a scatter), so XLA
    # materialises them and no longer fuses the last bucket's add into
    # the domain mean: with a boundary the mean is never the fused form.
    fused = maxsum_ops._sums_fused(g) and not n_bnd
    f_damping = damping if damp_factors and damping > 0 else 0.0
    v_damping = damping if damp_vars and damping > 0 else 0.0

    f2v_new, f2v_count = [], []
    v2f_new, v2f_count = [], []
    for i, bucket in enumerate(g.buckets):
        sent, cnt = send_update(
            f2v_cand[i], loc.f2v[i], loc.f2v_count[i], bucket.var_ids,
            g.var_valid, cycle, stable, damping=f_damping,
            stability=stability, var_ids32=bucket.var_ids32,
            edge_valid=bucket.edge_valid)
        f2v_new.append(sent)
        f2v_count.append(cnt)
        sent, cnt = v2f_update(
            beliefs, sums, loc.f2v[i], loc.v2f[i], loc.v2f_count[i],
            bucket.var_ids, g.var_valid, cycle, stable,
            damping=v_damping, stability=stability, fused=fused,
            var_ids32=bucket.var_ids32, edge_valid=bucket.edge_valid)
        v2f_new.append(sent)
        v2f_count.append(cnt)
    return _Local(tuple(v2f_new), tuple(f2v_new), tuple(v2f_count),
                  tuple(f2v_count)), stable


def _select_local(sh: LocalShard, f2v, halo: torch.Tensor, n_bnd: int,
                  v_loc: int) -> torch.Tensor:
    """Per-shard value selection over OWNED rows ([V_loc] int32)."""
    beliefs, _ = _local_beliefs(sh, f2v, halo, n_bnd)
    masked = torch.where(sh.graph.var_valid, beliefs, torch.inf)
    return torch.argmin(masked[:v_loc], dim=1).to(torch.int32)


def _all(flags: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """AND of per-shard 0-d bool flags, on ``dev``."""
    return torch.stack([f.to(dev) for f in flags]).all()


class ShardOps:
    """``ops.maxsum``-compatible namespace for a partitioned graph —
    ``MaxSumEngine``'s ``_ops`` seam lets the segmented, checkpointed
    and recovery machinery drive these unchanged.  Holds the mesh and
    the global variable count."""

    def __init__(self, mesh: Mesh, n_vars: int):
        self.mesh = mesh
        self.n_vars = n_vars

    @property
    def home(self) -> torch.device:
        """Where the stacked state, the halo and the reductions live:
        the mesh's first device."""
        return self.mesh.devices[0]

    # -- state ------------------------------------------------------- #

    def init_state(self, graph: ShardedGraph) -> ShardedMaxSumState:
        """Zero state on the mesh's first device — also the checkpoint
        template (``resilience/checkpoint.py`` restores into it)."""
        d = graph.dmax
        dev = self.home

        def zeros():
            return tuple(
                torch.zeros(tuple(b.var_ids.shape) + (d,),
                            dtype=torch.float32, device=dev)
                for b in graph.buckets)

        def counts():
            return tuple(
                torch.zeros(tuple(b.var_ids.shape), dtype=torch.int8,
                            device=dev)
                for b in graph.buckets)

        return ShardedMaxSumState(
            v2f=zeros(), f2v=zeros(), v2f_count=counts(),
            f2v_count=counts(),
            halo=torch.zeros((graph.n_boundary, d), dtype=torch.float32,
                             device=dev),
            stable=torch.zeros((), dtype=torch.bool, device=dev),
            cycle=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def _split(self, graph: ShardedGraph, state: ShardedMaxSumState
               ) -> List[_Local]:
        """The stacked state's per-shard blocks on their devices (views
        where the device is the home device)."""
        out = []
        for s, sh in enumerate(graph.shards):
            def block(field):
                return tuple(m[s].to(sh.device) for m in field)
            out.append(_Local(block(state.v2f), block(state.f2v),
                              block(state.v2f_count),
                              block(state.f2v_count)))
        return out

    def _stack(self, locs: List[_Local], halo, stable, cycle
               ) -> ShardedMaxSumState:
        dev = self.home

        def stack(field):
            n = len(getattr(locs[0], field)) if locs else 0
            return tuple(
                torch.stack([getattr(loc, field)[i].to(dev)
                             for loc in locs])
                for i in range(n))

        return ShardedMaxSumState(
            v2f=stack("v2f"), f2v=stack("f2v"),
            v2f_count=stack("v2f_count"), f2v_count=stack("f2v_count"),
            halo=halo, stable=stable, cycle=cycle)

    # -- the superstep ------------------------------------------------ #

    def _step(self, graph: ShardedGraph, locs: List[_Local], halo, cycle,
              prune=None, **kw):
        """One partitioned superstep over every shard, then the halo
        reduction of the messages just sent and the global verdict.
        Returns (locs, halo, stable, cycle)."""
        n_bnd = graph.n_boundary
        new_locs, flags, partials = [], [], []
        for s, sh in enumerate(graph.shards):
            loc, flag = _superstep_local(
                sh, locs[s], halo.to(sh.device), cycle.to(sh.device),
                n_bnd=n_bnd, prune=None if prune is None else prune[s],
                **kw)
            new_locs.append(loc)
            flags.append(flag)
            if n_bnd:
                partials.append(_boundary_partial(sh, loc.f2v))
        if n_bnd:
            halo = halo_sum(partials, self.home)
        return new_locs, halo, _all(flags, self.home), cycle + 1

    def _prune_tables(self, graph: ShardedGraph, prune: bool):
        if not prune:
            return None
        pt = [maxsum_ops.prune_tables(sh.graph) for sh in graph.shards]
        if all(t is None for tables in pt for t in tables):
            return None
        return pt

    def _fits(self, locs: List[_Local], pt) -> torch.Tensor:
        """The global AND of the per-shard fit tests: every shard takes
        the same (pruned or dense) step."""
        return _all([maxsum_ops.prune_fits(loc.v2f, tables)
                     for loc, tables in zip(locs, pt)], self.home)

    def _cycles(self, graph, locs, halo, stable, cycle, n_cycles, pt,
                stop_on_convergence, stats, **kw):
        """Yield (locs, halo, stable, cycle) after each of up to
        ``n_cycles`` supersteps, as ``ops.maxsum._cycles`` does: the
        pruned step when the global fit test holds for the messages
        about to be consumed, ``stable`` and the test read together
        once per cycle; without pruning ``stable`` is read only when the
        run may stop early."""
        fast = 0
        for _ in range(n_cycles):
            use_fast = False
            if pt is not None:
                fits = self._fits(locs, pt)
                if stop_on_convergence:
                    done, use_fast = torch.stack([stable, fits]).tolist()
                    if done:
                        break
                else:
                    use_fast = bool(fits)
            elif stop_on_convergence and bool(stable):
                break
            locs, halo, stable, cycle = self._step(
                graph, locs, halo, cycle, prune=pt if use_fast else None,
                **kw)
            fast += use_fast
            yield locs, halo, stable, cycle
        if stats is not None:
            stats["prune_fast_cycles"] = fast

    def _select(self, graph: ShardedGraph, locs: List[_Local], halo
                ) -> List[torch.Tensor]:
        return [_select_local(sh, loc.f2v, halo.to(sh.device),
                              graph.n_boundary, graph.v_loc)
                for sh, loc in zip(graph.shards, locs)]

    # -- solve entry points (ops.maxsum signatures) -------------------- #

    def run_maxsum_from(self, graph: ShardedGraph,
                        state: ShardedMaxSumState, extra_cycles: int, *,
                        damping: float = 0.5, damp_vars: bool = True,
                        damp_factors: bool = True,
                        stability: float = 0.1,
                        stop_on_convergence: bool = True,
                        prune: bool = False,
                        stats: Optional[Dict[str, int]] = None):
        """Up to ``extra_cycles`` more partitioned supersteps from an
        existing state; returns ``(state, values)`` with ``values``
        reassembled to the GLOBAL [V] order (the interface of
        ``ops.maxsum.run_maxsum_from``).  ``prune=True`` applies
        branch-and-bound pruning to each shard's local factor
        reductions, the phase predicate being the GLOBAL AND of the
        per-shard fit tests; ``stats`` receives ``prune_fast_cycles``."""
        locs = self._split(graph, state)
        halo, stable, cycle = state.halo, state.stable, state.cycle
        for locs, halo, stable, cycle in self._cycles(
                graph, locs, halo, stable, cycle, extra_cycles,
                self._prune_tables(graph, prune), stop_on_convergence,
                stats, damping=damping, damp_vars=damp_vars,
                damp_factors=damp_factors, stability=stability):
            pass
        values = self._assemble_values(graph,
                                       self._select(graph, locs, halo))
        return self._stack(locs, halo, stable, cycle), values

    def run_maxsum(self, graph: ShardedGraph, max_cycles: int, *,
                   damping: float = 0.5, damp_vars: bool = True,
                   damp_factors: bool = True, stability: float = 0.1,
                   stop_on_convergence: bool = True,
                   prune: bool = False,
                   stats: Optional[Dict[str, int]] = None):
        return self.run_maxsum_from(
            graph, self.init_state(graph), max_cycles,
            damping=damping, damp_vars=damp_vars,
            damp_factors=damp_factors, stability=stability,
            stop_on_convergence=stop_on_convergence, prune=prune,
            stats=stats,
        )

    def _exchange_values(self, graph: ShardedGraph,
                         values: List[torch.Tensor]) -> List[torch.Tensor]:
        """The owners' selected values of the boundary variables,
        gathered into each shard's halo slots ([H] int32 each; none
        without a boundary): the reference's owner-scatter + integer
        psum (exact in any order)."""
        dev = self.home
        bnd = torch.zeros((graph.n_boundary + 1,), dtype=torch.int32,
                          device=dev)
        for sh, vals in zip(graph.shards, values):
            bnd[sh.owner_index.to(dev)] = vals[sh.owner_rows].to(dev)
        return [bnd.to(sh.device)[sh.halo_bnd] for sh in graph.shards]

    def _cost(self, graph: ShardedGraph, values: List[torch.Tensor],
              base_local: Optional[List[torch.Tensor]]) -> torch.Tensor:
        """The global assignment cost of the per-shard owned values: per
        shard its factors' costs at owned + halo values plus its owned
        variables' base costs (one ``window_total`` each), the shard
        costs reduced in the reference's all-reduce order."""
        halo_vals = self._exchange_values(graph, values)
        costs = []
        for s, sh in enumerate(graph.shards):
            full = torch.cat([values[s], halo_vals[s]])
            ops = maxsum_ops.constraint_operands(
                sh.graph, maxsum_ops.trace_site(graph.dmax))
            if base_local is not None:
                ops.append(maxsum_ops.variable_operand(base_local[s]))
            costs.append(window_total(ops, full).reshape(1))
        return halo_sum(costs, self.home).reshape(())

    def run_maxsum_trace(self, graph: ShardedGraph, max_cycles: int, *,
                         damping: float = 0.5, damp_vars: bool = True,
                         damp_factors: bool = True,
                         stability: float = 0.1,
                         var_base_costs=None,
                         stop_on_convergence: bool = True,
                         prune: bool = False,
                         stats: Optional[Dict[str, int]] = None):
        """Partitioned run recording the global assignment cost after
        every cycle: per-shard constraint cost over local factors plus
        owned-variable base costs, reduced across shards — each factor
        and each variable is owned by exactly one shard, so the
        reduction is a partition of the global sum.  Halo variables'
        selected values ride the integer exchange.  With
        ``stop_on_convergence`` every shard leaves on the global
        verdict and the tail of the curve holds the final cost.
        ``prune`` is accepted for interface parity but runs dense, as
        the reference's: a trace is a value record."""
        v_loc = graph.v_loc
        base_local = None
        if var_base_costs is not None:
            base = torch.as_tensor(var_base_costs, dtype=torch.float32)
            ext = torch.cat([base.cpu(), torch.zeros((1, graph.dmax))])
            base_local = [
                ext[torch.as_tensor(graph.local_global[s, :v_loc],
                                    dtype=torch.int64)]
                .contiguous().to(sh.device)
                for s, sh in enumerate(graph.shards)]
        dev = self.home
        costs = torch.zeros((max_cycles,), dtype=torch.float32, device=dev)
        last = torch.zeros((), dtype=torch.float32, device=dev)
        state = self.init_state(graph)
        locs = self._split(graph, state)
        halo, stable, cycle = state.halo, state.stable, state.cycle
        n = 0
        for locs, halo, stable, cycle in self._cycles(
                graph, locs, halo, stable, cycle, max_cycles, None,
                stop_on_convergence, None, damping=damping,
                damp_vars=damp_vars, damp_factors=damp_factors,
                stability=stability):
            last = self._cost(graph, self._select(graph, locs, halo),
                              base_local)
            costs[n] = last
            n += 1
        # An early exit leaves the tail unwritten: hold the final cost.
        costs[n:] = last
        values = self._assemble_values(graph,
                                       self._select(graph, locs, halo))
        return self._stack(locs, halo, stable, cycle), values, costs

    def recompute_halo(self, graph: ShardedGraph, f2v) -> torch.Tensor:
        """The ``[B, D]`` boundary buffer of an EXISTING set of stacked
        f2v messages: the superstep tail's partial sums + reduction, run
        once.  Shard-loss recovery rebuilds the halo slot with it after
        remapping a snapshot onto a new partition."""
        n_bnd = graph.n_boundary
        if n_bnd == 0:
            return torch.zeros((0, graph.dmax), dtype=torch.float32,
                               device=self.home)
        partials = [
            _boundary_partial(sh, tuple(m[s].to(sh.device) for m in f2v))
            for s, sh in enumerate(graph.shards)]
        return halo_sum(partials, self.home)

    def assignment_constraint_cost(self, graph: ShardedGraph,
                                   values: torch.Tensor,
                                   site: str = "maxsum") -> torch.Tensor:
        """Global constraint cost of a GLOBAL [V] assignment on the
        partitioned graph (the segment-boundary guard's input; the
        engine probe's at ``site="probe"``): values scattered to each
        shard's local order, per-shard factor costs reduced across
        shards."""
        dev = self.home
        vals = torch.as_tensor(values).to(device=dev, dtype=torch.int32)
        ext = torch.cat([vals, torch.zeros((1,), dtype=torch.int32,
                                           device=dev)])
        costs = []
        for sh in graph.shards:
            local = ext.to(sh.device)[sh.local_global]
            costs.append(maxsum_ops.assignment_constraint_cost(
                sh.graph, local, site=site).reshape(1))
        return halo_sum(costs, dev).reshape(())

    def _assemble_values(self, graph: ShardedGraph,
                         values: List[torch.Tensor]) -> torch.Tensor:
        """Per-shard owned values ([V_loc] each) -> global [V] order.
        Padding owned slots scatter to the sentinel index and are
        dropped by the final slice."""
        dev = self.home
        v_loc = graph.v_loc
        out = torch.zeros((self.n_vars + 1,), dtype=torch.int32,
                          device=dev)
        for sh, vals in zip(graph.shards, values):
            owned = sh.local_global[:v_loc].to(dev)
            keep = owned < self.n_vars
            out[owned[keep]] = vals.to(dev)[keep]
        return out[:self.n_vars]


# ----------------------- shard-loss state remap ---------------------- #


def _factor_row_maps(source_graph: CompiledFactorGraph, part):
    """Per bucket: the positions (in real-factor row order) owned by
    each shard — the inverse of build_partitioned_graph's per-shard
    row packing (``rows[fs == s]`` in order)."""
    n_vars = source_graph.n_vars
    maps = []
    for b, fs in zip(source_graph.buckets, part.factor_shard):
        ids = np.asarray(b.var_ids)
        rows = real_factor_rows(ids, n_vars)
        maps.append((rows,
                     [np.nonzero(fs == s)[0]
                      for s in range(part.n_shards)]))
    return maps


def remap_partitioned_state(source_graph: CompiledFactorGraph,
                            old_part, new_part,
                            state: ShardedMaxSumState,
                            new_graph: ShardedGraph,
                            new_ops: ShardOps) -> ShardedMaxSumState:
    """Map a validated :class:`ShardedMaxSumState` from one partition's
    blocked layout onto another's — the shard-loss recovery step.

    Messages and SAME_COUNT counters live per (factor, scope slot): the
    remap gathers each bucket's per-shard blocks back to global
    real-factor row order (host numpy: it runs once per device loss)
    and re-packs them under the new factor->shard assignment; padding
    rows of the new layout start zeroed, like a fresh ``init_state``.
    The halo slot is recomputed from the remapped f2v messages
    (:meth:`ShardOps.recompute_halo`), in the new layout's reduction
    order.  ``stable``/``cycle`` carry over."""
    old_maps = _factor_row_maps(source_graph, old_part)
    new_maps = _factor_row_maps(source_graph, new_part)
    new_S = new_part.n_shards
    dev = new_ops.home

    def regather(blocked, bucket_i):
        """[S_old, Fmax_old, ...] blocked -> [F_real, ...] global."""
        blocked = blocked.cpu().numpy()
        rows, per_shard = old_maps[bucket_i]
        out = np.zeros((rows.shape[0],) + blocked.shape[2:],
                       blocked.dtype)
        for s, sel in enumerate(per_shard):
            out[sel] = blocked[s, :sel.shape[0]]
        return out

    def reblock(global_arr, bucket_i, f_max):
        """[F_real, ...] global -> [S_new, f_max, ...] blocked."""
        _, per_shard = new_maps[bucket_i]
        out = np.zeros((new_S, f_max) + global_arr.shape[1:],
                       global_arr.dtype)
        for s, sel in enumerate(per_shard):
            out[s, :sel.shape[0]] = global_arr[sel]
        return out

    def remap_field(msgs):
        remapped = []
        for i, blocked in enumerate(msgs):
            f_max = new_graph.buckets[i].var_ids.shape[1]
            remapped.append(torch.from_numpy(
                reblock(regather(blocked, i), i, f_max)).to(dev))
        return tuple(remapped)

    f2v = remap_field(state.f2v)
    return ShardedMaxSumState(
        v2f=remap_field(state.v2f),
        f2v=f2v,
        v2f_count=remap_field(state.v2f_count),
        f2v_count=remap_field(state.f2v_count),
        halo=new_ops.recompute_halo(new_graph, f2v),
        stable=state.stable.to(dev).clone(),
        cycle=state.cycle.to(dev).clone(),
    )
