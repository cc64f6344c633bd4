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

The same kernel runs the local search's candidate-cost sum
(:func:`positional_sum`, the positional mode): ``init`` plus, per
variable, its contributions of every (bucket, position) unit, in the
order XLA gives the reference's ``positional_sum``
(``pydcop_tpu/ops/localsearch.py:57``).
"""

import ctypes
import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops.flush import ftz

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
    """The definition, walked edge rank by edge rank: each variable's
    running sum starts at +0.0 and takes its edges in CSR (edge) order,
    each add flushed to zero like the reference's (``ops/flush.py``).
    Across buckets it is the form XLA gives the reference's jitted sum
    of per-bucket segment_sums: a bucket that :func:`separate_buckets`
    marks is summed on its own from +0.0 and added to the running sum
    when the walk leaves it — every marked bucket is left, so its sum
    (+0.0 where the variable has no edge there) is added to every
    variable, as the reference adds whole arrays; any other bucket is
    added into the running sum edge by edge.  With ``one_sum`` every
    edge goes into the one running sum (the reference's ``sorted``
    aggregation: its single segment_sum over the edges gathered into CSR
    order).  Then ``var_costs + sums``, flushed.  ``msgs`` is [E, D],
    every bucket's edges in bucket order.  Returns (beliefs, sums), both
    [V+1, D].

    Rank r of the walk adds the r-th edge of every variable of degree
    above r at once; the variables are taken in decreasing degree, so
    those are a prefix.  The walk reads the degrees on the host."""
    sums = _walk(msgs, perm, offsets, buckets,
                 torch.zeros_like(var_costs), one_sum)
    return ftz(var_costs + sums), sums


def positional_sum_reference(msgs: torch.Tensor, perm: torch.Tensor,
                             offsets: torch.Tensor, units: torch.Tensor,
                             init: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`positional_sum`: the walk of
    :func:`segment_sum_reference` over the (bucket, position) units
    ``units`` (their first edges, then E), each running sum starting at
    ``init`` [V+1, D] instead of +0.0, and no beliefs.  ``msgs`` is
    [E, D], the units' contributions in unit order."""
    return _walk(msgs, perm, offsets, units, init, False)


def _walk(msgs, perm, offsets, buckets, acc, one_sum):
    """The edge-rank walk of :func:`segment_sum_reference` from the
    running sums ``acc`` [V+1, D]; returns the sums."""
    n_seg = acc.shape[0]
    dev = perm.device
    offsets = offsets.to(torch.int64)
    counts = offsets[1:] - offsets[:-1]
    order = torch.argsort(-counts, stable=True)
    per_rank = torch.bincount(counts, minlength=1).flip(0).cumsum(0).flip(0)
    active = per_rank[1:].tolist()          # variables of degree > r
    starts = offsets[:-1][order]
    perm = perm.to(torch.int64)
    n_buckets = buckets.shape[0] - 1
    sep = (0 if one_sum or n_buckets < 2
           else separate_buckets(buckets.tolist(), n_seg))
    acc = acc[order]
    part = torch.zeros_like(acc)
    at = torch.zeros((n_seg,), dtype=torch.int64, device=dev)
    sep_rows = torch.tensor([(sep >> b) & 1 for b in range(n_buckets)],
                            dtype=torch.bool, device=dev)

    def leave(rows, to):
        # Leave buckets below ``to`` (per row): a separate bucket's own
        # sum goes into the running sum.
        a, p, b = acc[:rows], part[:rows], at[:rows]
        for bb in range(n_buckets - 1 if to is not None else n_buckets):
            go = b == bb
            if to is not None:
                go &= to > bb
            if (sep >> bb) & 1:
                a.copy_(torch.where(go[:, None], ftz(a + p), a))
                p.masked_fill_(go[:, None], 0.0)
            b.masked_fill_(go, bb + 1)

    for r, n in enumerate(active):
        edge = perm[starts[:n] + r]
        m = msgs[edge]
        a = acc[:n]
        if not sep:
            a.copy_(ftz(a + m))
            continue
        eb = torch.searchsorted(buckets, edge.to(buckets.dtype),
                                right=True) - 1
        leave(n, eb)
        own = sep_rows[eb][:, None]
        p = part[:n]
        p.copy_(torch.where(own, ftz(p + m), p))
        a.copy_(torch.where(own, a, ftz(a + m)))
    if sep:
        leave(n_seg, None)
    sums = torch.empty_like(acc)
    sums[order] = acc
    return sums


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
                   + [ctypes.c_int, ctypes.c_void_p])
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
                      0, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {err}")
    _build.launch_counts[KERNEL] += 1
    return beliefs, sums


def positional_sum(units: Sequence[torch.Tensor], perm: torch.Tensor,
                   offsets: torch.Tensor, unit_starts: torch.Tensor,
                   init: torch.Tensor,
                   tiles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[V+1, D] f32: ``init`` plus, per variable, its contributions of
    every (bucket, position) unit, in the order of the reference's
    jitted ``positional_sum``: the running sum starts at ``init``, and
    across units it is :func:`separate_buckets`' fold with the units in
    place of the buckets (probed against the reference on random graphs
    of arity 1-4; ``tests/test_torch_localsearch.py``).

    ``units`` are the units' [F, D] contributions in unit order (bucket
    order, then position), each read where it lies; ``perm`` [E] int32
    orders the edges — unit by unit, factor by factor — by variable
    (``graph.pos_perm``), ``offsets`` and ``tiles`` are the graph's
    ``agg_offsets`` and ``agg_tiles`` (a variable has the same edges in
    either order), ``unit_starts`` [n_units + 1] int32 the units' first
    edges, then E.  On a CUDA tensor it launches the kernel in its
    positional mode; on the CPU it runs the plain version."""
    parts = tuple(units)
    _check(parts, False, perm, offsets, unit_starts, init, tiles)
    n_seg, d = init.shape
    if perm.device.type == "cpu":
        whole = (parts[0].reshape(-1, d) if len(parts) == 1
                 else torch.cat([p.reshape(-1, d) for p in parts]))
        return positional_sum_reference(whole, perm, offsets, unit_starts,
                                        init)
    n_units = len(parts)
    if n_units > MAX_BUCKETS:
        raise ValueError(f"{n_units} (bucket, position) units: the kernel "
                         f"takes at most {MAX_BUCKETS}")
    if tiles is None:
        raise ValueError("positional_sum on the card needs the placement "
                         "plan (graph.agg_tiles)")
    if max([p.numel() for p in parts] + [perm.shape[0] * d,
                                         init.numel()]) >= 2 ** 31:
        raise ValueError(
            f"graph too large for one launch: E={perm.shape[0]}, "
            f"V+1={n_seg}, D={d}")
    out = torch.empty_like(init)
    if out.numel() == 0:
        return out
    bases = (ctypes.c_void_p * n_units)(*(p.data_ptr() for p in parts))
    edge_starts = np.cumsum([0] + [p.numel() // d for p in parts]).tolist()
    starts = (ctypes.c_int * (n_units + 1))(*edge_starts)
    with torch.cuda.device(perm.device):
        err = _launcher()(bases, starts, n_units, perm.data_ptr(),
                          offsets.data_ptr(), tiles.data_ptr(),
                          tiles.shape[0], init.data_ptr(), out.data_ptr(),
                          None, n_seg, d, _load_width(parts, d),
                          pass_edges(d), 0,
                          separate_buckets(edge_starts, n_seg), 1,
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"segment_sum (positional) launch failed: CUDA error {err}")
    _build.launch_counts[KERNEL] += 1
    return out
