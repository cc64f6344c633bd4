"""The superstep's per-edge update: CUDA kernel wrapper and plain version.

Two entry points, one launch each, both on the current stream with no
host read (so a CUDA graph can capture them):

- :func:`v2f_update`, one per bucket, is the whole variable side of the
  reference (``pydcop_tpu/ops/maxsum.py:463 var_to_factor``, ``:494
  _damp``, ``:120 _send_or_suppress``, ``:100 _edge_match``): for each
  edge it gathers its variable's beliefs and sums, subtracts its own
  message, takes the mean over the valid slots in the order XLA sums
  them (:func:`sum_last`), writes BIG into invalid slots, damps, runs
  the approx-match, the SAME_COUNT counts and the sent-or-kept message,
  and ANDs the bucket's all-match into the ``stable`` flag;
- :func:`send_update` is the same epilogue alone (damp, match, counts,
  ``stable``) for the factor side's candidates, whichever path made them.

Every floating-point operation flushes a subnormal result to zero, as
XLA:CPU and the TPU do (``ops/flush.py``).  On a CUDA tensor the
wrappers launch ``csrc/var_update.cu`` and raise if the launch fails; on
a CPU tensor they run the plain version.

The kernel reads the bucket's placement arrays (``device.py``):
``var_ids32``, the int32 copy of ``var_ids``, and at D <= 8
``edge_valid``, each edge's valid slots as bits.  The plain versions
take validity from ``var_valid[var_ids]``, the reference's form; on a
CPU tensor the new arrays are only checked.
"""

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.device import EDGE_VALID_MAX_D
from pydcop_tpu_torch.engine.compile import BIG
from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops.ell import WINDOW, window_sum
from pydcop_tpu_torch.ops.flush import ftz

KERNEL = "var_update"

# Edges a thread of the D <= 8 kernel takes at most (1, 2, 4 or 8), by
# D; a block of BLOCK_THREADS takes that many times as many.  Chosen on
# the H100 (PERF.md §6).
TILE_ITEMS = {1: 4, 2: 4, 3: 4, 4: 4, 5: 2, 6: 2, 7: 2, 8: 2}
BLOCK_THREADS = 256

# Reference maxsum.py:106 SAME_COUNT: a message that approx-matches the
# previously sent one is re-sent at most this many times, then the edge
# goes quiet (the receiver keeps the last value).
SAME_COUNT = 4


def fma(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a * x + y`` for float32 ``x`` and ``y``, rounded once (a fused
    multiply-add).  The product is exact in float64; the sum's float64
    rounding error is recovered exactly (TwoSum), and it decides the
    float32 rounding where the float64 sum lies exactly halfway between
    two float32 values — everywhere else rounding the float64 sum is
    already correct.  The same bits on the CPU and on the card."""
    p = x.double() * float(np.float32(a))
    q = y.double()
    s = p + q
    bq = s - p
    err = (p - (s - bq)) + (q - bq)
    t = s.float()
    d = s - t.double()
    toward = torch.nextafter(t, torch.where(d > 0, torch.inf, -torch.inf)
                             .to(t.dtype))
    tie = (d != 0) & (toward.double() - t.double() == 2 * d)
    return torch.where(tie & (err != 0) & ((err > 0) == (d > 0)), toward, t)


def damp(new: torch.Tensor, old: torch.Tensor, damping: float,
         first: torch.Tensor) -> torch.Tensor:
    """damped = damping * prev + (1-damping) * new; no damping on the
    first cycle (reference maxsum.py:679), in the forms XLA:CPU gives
    the reference's ``damping * o + (1 - damping) * n``: at damping 0.5
    (the default) ``(o + n) * 0.5``, otherwise one fused multiply-add,
    ``fma(damping, o, (1 - damping) * n)`` (:func:`fma`), each
    operation flushed."""
    if damping == 0.5:
        damped = ftz(ftz(old + new) * 0.5)
    else:
        damped = ftz(fma(damping, old, ftz((1.0 - damping) * new)))
    return torch.where(first, new, damped)


def edge_match(new: torch.Tensor, old: torch.Tensor, stability: float,
               valid: torch.Tensor) -> torch.Tensor:
    """Per-edge approx_match (reference maxsum.py:688): relative change
    ``2|d|/|a+b|`` below ``stability`` on every valid domain slot, exact
    equality always matching.  Returns [F, arity] bool."""
    delta = torch.abs(ftz(new - old))
    s = torch.abs(ftz(new + old))
    ok = (2 * delta < ftz(stability * s)) | (delta == 0)
    return torch.all(ok | ~valid, dim=-1)


def send_or_suppress(cand: torch.Tensor, prev: torch.Tensor,
                     count: torch.Tensor, stability: float,
                     valid: torch.Tensor, first: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference send-suppression (maxsum.py:366-377): a candidate that
    approx-matches the last sent message is re-sent at most SAME_COUNT
    times, then the edge freezes on the last sent value.

    Returns (sent messages, new counts, per-edge match flags)."""
    match = edge_match(cand, prev, stability, valid) & ~first
    send = ~match | (count < SAME_COUNT)
    sent = torch.where(send[..., None], cand, prev)
    new_count = torch.where(
        match, torch.clamp(count + 1, max=SAME_COUNT + 1),
        torch.ones_like(count))
    return sent, new_count, match


def lane_sum(x: torch.Tensor, width: int, head: int) -> torch.Tensor:
    """LLVM's vectorised form of a sum over the last axis: ``width``
    lanes from zero, lane j adding slots j, j + width, ... below
    ``head``; the lanes folded by halves; then slots ``head`` onward
    added one by one.  The axis is kept with length 1."""
    lanes = []
    for j in range(width):
        acc = torch.zeros_like(x[..., :1])
        for k in range(j, head, width):
            acc = ftz(acc + x[..., k:k + 1])
        lanes.append(acc)
    while len(lanes) > 1:
        half = len(lanes) // 2
        lanes = [ftz(lanes[i] + lanes[i + half]) for i in range(half)]
    acc = lanes[0]
    for k in range(head, x.shape[-1]):
        acc = ftz(acc + x[..., k:k + 1])
    return acc


def sum_last(x: torch.Tensor, vectorised: bool = False) -> torch.Tensor:
    """Sum over the last (domain) axis, keeping the axis, in the order
    XLA reduces in: left to right up to 32 slots, and above 32 in
    windows of 32 (``ops.ell.window_sum``, XLA's tree-reduction
    rewrite).  ``torch.sum`` vectorises some widths (D=5 on the CPU)
    into another order, which changes the last bit.

    ``vectorised``: the reference's sums come out of an add that XLA
    fuses into the gather feeding this reduction (a scatter fold that
    ends with a bucket summed on its own), and LLVM then vectorises the
    sum of 28 to 32 slots: lanes of 8 over the first 24 slots and the
    rest one by one (D = 28..31), or lanes of 16 over all 32."""
    d = x.shape[-1]
    if d > WINDOW:
        return window_sum(x, x.dim() - 1)
    if vectorised and d == WINDOW:
        return lane_sum(x, 16, WINDOW)
    if vectorised and d >= 28:
        return lane_sum(x, 8, 24)
    acc = x[..., :1]
    for k in range(1, d):
        acc = ftz(acc + x[..., k:k + 1])
    return acc


def var_messages(beliefs: torch.Tensor, sums: torch.Tensor,
                 msgs: torch.Tensor, var_ids: torch.Tensor,
                 var_valid: torch.Tensor, fused: bool) -> torch.Tensor:
    """One bucket's variable->factor candidates: belief minus own
    contribution, mean-normalized over valid slots (reference
    maxsum.py:670-674), BIG on invalid slots."""
    valid = var_valid[var_ids]                       # [F, a, D]
    raw = ftz(beliefs[var_ids] - msgs)               # own cost + others
    factor_sum = ftz(sums[var_ids] - msgs)           # others only
    n_valid = torch.clamp(
        torch.sum(valid, dim=-1, keepdim=True, dtype=torch.int32), min=1)
    avg = ftz(sum_last(torch.where(valid, factor_sum, 0.0), fused)
              / n_valid)
    return torch.where(valid, ftz(raw - avg), float(BIG))


def send_update_reference(cand: torch.Tensor, prev: torch.Tensor,
                          count: torch.Tensor, var_ids: torch.Tensor,
                          var_valid: torch.Tensor, cycle: torch.Tensor,
                          stable: torch.Tensor, *, damping: float,
                          stability: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain epilogue: damp ``cand`` against ``prev`` (``damping``
    0: none), flush, send or keep, and AND the bucket's all-match over
    live edges into ``stable`` (in place).  Returns (sent, counts)."""
    first = cycle == 0
    valid = var_valid[var_ids]
    if damping > 0:
        cand = damp(cand, prev, damping, first)
    sent, new_count, match = send_or_suppress(
        ftz(cand), prev, count, stability, valid, first)
    edge_live = torch.any(valid, dim=-1)
    stable.logical_and_(torch.all(match | ~edge_live))
    return sent, new_count


def v2f_update_reference(beliefs: torch.Tensor, sums: torch.Tensor,
                         f2v: torch.Tensor, prev: torch.Tensor,
                         count: torch.Tensor, var_ids: torch.Tensor,
                         var_valid: torch.Tensor, cycle: torch.Tensor,
                         stable: torch.Tensor, *, damping: float,
                         stability: float, fused: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain variable side of one bucket: :func:`var_messages` of
    the factor messages ``f2v`` against ``beliefs``/``sums``, then
    :func:`send_update_reference` against the last sent ``prev``."""
    cand = var_messages(beliefs, sums, f2v, var_ids, var_valid, fused)
    return send_update_reference(cand, prev, count, var_ids, var_valid,
                                 cycle, stable, damping=damping,
                                 stability=stability)


def _check(named, dev):
    for name, t, dtype in named:
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"var_update: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"var_update: {name} on {t.device} but the "
                             f"messages on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"var_update: {name} is not contiguous")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")


def _check_edges(prev, count, var_ids, var_valid, cycle, stable,
                 var_ids32, edge_valid, var_side):
    if var_ids.dim() != 2 or tuple(prev.shape[:2]) != tuple(var_ids.shape):
        raise ValueError(
            f"messages must be [F, arity, D] over var_ids [F, arity], got "
            f"{tuple(prev.shape)} and {tuple(var_ids.shape)}")
    for name, t in (("counts", count), ("var_ids32", var_ids32),
                    ("edge_valid", edge_valid)):
        if t is not None and t.shape != var_ids.shape:
            raise ValueError(f"{name} must be {tuple(var_ids.shape)}, got "
                             f"{tuple(t.shape)}")
    d = prev.shape[2]
    if var_valid.dim() != 2 or var_valid.shape[1] != d:
        raise ValueError(f"var_valid must be [V+1, D={d}], "
                         f"got {tuple(var_valid.shape)}")
    if cycle.numel() != 1 or stable.numel() != 1:
        raise ValueError("cycle and stable must be 0-d tensors")
    small = d <= EDGE_VALID_MAX_D
    if edge_valid is not None and not small:
        raise ValueError(f"edge_valid is for D <= {EDGE_VALID_MAX_D}, "
                         f"got D={d}")
    if prev.device.type == "cuda":
        missing = [name for name, t, need in (
            ("var_ids32", var_ids32, var_side or not small),
            ("edge_valid", edge_valid, small)) if need and t is None]
        if missing:
            raise ValueError(
                f"var_update on the card needs the bucket's "
                f"{' and '.join(missing)} (device.to_device_graph)")


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load(KERNEL)
    fn = lib.var_update_launch
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def tile_items(n_edges: int, d: int, n_sms: int) -> int:
    """Edges a thread of the D <= 8 kernel takes for a bucket of
    ``n_edges``: ``TILE_ITEMS[d]``, halved while that leaves fewer
    blocks than the card has SMs (a small bucket is spread over more
    of them)."""
    items = TILE_ITEMS.get(d, 1)
    while items > 1 and -(-n_edges // (BLOCK_THREADS * items)) < n_sms:
        items //= 2
    return items


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _damp_mode(damping: float) -> int:
    """0: no damping; 1: ``(o + n) * 0.5``; 2: one fused multiply-add."""
    return 0 if damping <= 0 else 1 if damping == 0.5 else 2


def _launch(beliefs, sums, f2v, prev, count, var_ids32, edge_valid,
            var_valid, cycle, stable, damping, stability, fused):
    """One kernel launch; ``beliefs is None`` takes ``f2v`` as the
    candidates (the epilogue alone)."""
    f, arity, d = prev.shape
    if prev.numel() >= 2 ** 31 or var_valid.numel() >= 2 ** 31:
        raise ValueError(f"bucket too large for one launch: F={f}, "
                         f"arity={arity}, D={d}")
    if prev.device.index != torch.cuda.current_device():
        with torch.cuda.device(prev.device):
            return _launch(beliefs, sums, f2v, prev, count, var_ids32,
                           edge_valid, var_valid, cycle, stable, damping,
                           stability, fused)
    out = torch.empty_like(prev)
    out_count = torch.empty_like(count)
    if f * arity == 0:
        return out, out_count
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = _launcher()(
        ptr(beliefs), ptr(sums), f2v.data_ptr(), prev.data_ptr(),
        count.data_ptr(), ptr(var_ids32), ptr(edge_valid),
        var_valid.data_ptr(), cycle.data_ptr(), out.data_ptr(),
        out_count.data_ptr(), stable.data_ptr(), f * arity, d,
        _damp_mode(damping), float(np.float32(damping)),
        float(np.float32(1.0 - damping)), float(np.float32(stability)),
        int(beliefs is not None), int(fused),
        tile_items(f * arity, d, _sm_count(prev.device.index)),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"var_update launch failed: CUDA error {err}")
    _build.launch_counts[KERNEL] += 1
    return out, out_count


def v2f_update(beliefs: torch.Tensor, sums: torch.Tensor, f2v: torch.Tensor,
               prev: torch.Tensor, count: torch.Tensor,
               var_ids: torch.Tensor, var_valid: torch.Tensor,
               cycle: torch.Tensor, stable: torch.Tensor, *,
               damping: float, stability: float, fused: bool = False,
               var_ids32: Optional[torch.Tensor] = None,
               edge_valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One bucket's sent variable->factor messages [F, a, D] f32 and
    counts [F, a] int8 from the beliefs and sums [V+1, D] f32, the
    bucket's last factor messages ``f2v`` and last sent ``prev``
    [F, a, D] f32, its counts, ``var_ids`` [F, a] int64, ``var_valid``
    [V+1, D] bool, the 0-d int32 ``cycle``; ANDs the bucket's all-match
    into the 0-d bool ``stable`` in place.  ``damping`` 0 damps
    nothing; ``fused`` as :func:`sum_last`'s ``vectorised``.  The
    bucket's ``var_ids32`` [F, a] int32 and, at D <= 8, ``edge_valid``
    [F, a] uint8 (``device.TorchFactorBucket``) are what the kernel
    reads: a CUDA call without them raises.  Equal to
    :func:`v2f_update_reference` bit for bit."""
    dev = prev.device
    _check([("beliefs", beliefs, torch.float32),
            ("sums", sums, torch.float32), ("f2v", f2v, torch.float32),
            ("prev", prev, torch.float32), ("count", count, torch.int8),
            ("var_ids", var_ids, torch.int64),
            ("var_valid", var_valid, torch.bool),
            ("cycle", cycle, torch.int32), ("stable", stable, torch.bool),
            ("var_ids32", var_ids32, torch.int32),
            ("edge_valid", edge_valid, torch.uint8)], dev)
    _check_edges(prev, count, var_ids, var_valid, cycle, stable,
                 var_ids32, edge_valid, var_side=True)
    if f2v.shape != prev.shape or beliefs.shape != var_valid.shape \
            or sums.shape != var_valid.shape:
        raise ValueError(
            f"f2v {tuple(f2v.shape)} must match prev {tuple(prev.shape)},"
            f" beliefs {tuple(beliefs.shape)} and sums "
            f"{tuple(sums.shape)} var_valid {tuple(var_valid.shape)}")
    if dev.type == "cpu":
        return v2f_update_reference(
            beliefs, sums, f2v, prev, count, var_ids, var_valid, cycle,
            stable, damping=damping, stability=stability, fused=fused)
    return _launch(beliefs, sums, f2v, prev, count, var_ids32, edge_valid,
                   var_valid, cycle, stable, damping, stability, fused)


def send_update(cand: torch.Tensor, prev: torch.Tensor,
                count: torch.Tensor, var_ids: torch.Tensor,
                var_valid: torch.Tensor, cycle: torch.Tensor,
                stable: torch.Tensor, *, damping: float, stability: float,
                var_ids32: Optional[torch.Tensor] = None,
                edge_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The epilogue alone for one bucket's factor->variable candidates
    ``cand`` [F, a, D] f32 (arguments as :func:`v2f_update`; at
    D <= 8 the kernel reads ``edge_valid`` and no index, above 8
    ``var_ids32`` and ``var_valid``).  Equal to
    :func:`send_update_reference` bit for bit."""
    dev = prev.device
    _check([("cand", cand, torch.float32), ("prev", prev, torch.float32),
            ("count", count, torch.int8), ("var_ids", var_ids, torch.int64),
            ("var_valid", var_valid, torch.bool),
            ("cycle", cycle, torch.int32), ("stable", stable, torch.bool),
            ("var_ids32", var_ids32, torch.int32),
            ("edge_valid", edge_valid, torch.uint8)], dev)
    _check_edges(prev, count, var_ids, var_valid, cycle, stable,
                 var_ids32, edge_valid, var_side=False)
    if cand.shape != prev.shape:
        raise ValueError(f"cand {tuple(cand.shape)} must match prev "
                         f"{tuple(prev.shape)}")
    if dev.type == "cpu":
        return send_update_reference(
            cand, prev, count, var_ids, var_valid, cycle, stable,
            damping=damping, stability=stability)
    return _launch(None, None, cand, prev, count, var_ids32, edge_valid,
                   var_valid, cycle, stable, damping, stability, False)
