"""The lane layout's per-edge update: CUDA kernel wrapper and plain version.

Two entry points, one launch each, on the current stream with no host
read, for one lane-major bucket (messages ``[D, a, F]``):

- :func:`lane_v2f_update` is the whole variable side of the reference
  (``pydcop_tpu/ops/maxsum_lane.py:332 var_to_factor``, ``:359 _damp``,
  ``:286 _send_or_suppress``, ``:277 _edge_match``): for each edge its
  variable's beliefs and sums (one row of ``ops/lane_sum.py``'s table),
  belief minus own message, the mean over the valid slots summed over
  the domain left to right (in windows of 32 above 32), BIG on invalid
  slots, damping, approx-match, SAME_COUNT suppression, the counts, and
  the bucket's all-match ANDed into ``stable``;
- :func:`lane_send_update` is the same epilogue alone for the factor
  side's candidates.

Every floating-point operation flushes a subnormal result to zero, as
XLA:CPU does for the reference (``ops/flush.py``).  On a CUDA tensor the
wrappers launch ``csrc/lane_var_update.cu`` and raise if the launch
fails; on a CPU tensor they run the plain version.  The kernel reads
the bucket's placement arrays (``device.TorchLaneBucket``): ``var_ids32``
and, at D <= 8, ``edge_valid``; the plain versions take validity from
``var_valid[:, var_ids]``, the reference's form.
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
from pydcop_tpu_torch.ops.lane_sum import row_floats, table_halves
from pydcop_tpu_torch.ops.var_update import SAME_COUNT, _damp_mode, damp

KERNEL = "lane_var_update"
# Launch counters, one per entry.
V2F = f"{KERNEL}:v2f"
SEND = f"{KERNEL}:send"
# The widest domain the kernel takes (its per-thread arrays).
MAX_D = 256


def sum_domain(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading domain axis, kept, in XLA's order: left to
    right, in windows of 32 above 32 slots."""
    d = x.shape[0]
    if d > WINDOW:
        return window_sum(x, 0)
    acc = x[:1]
    for k in range(1, d):
        acc = ftz(acc + x[k:k + 1])
    return acc


def edge_match(new, old, stability, valid):
    """Per-edge approx_match over the domain axis (axis 0 here), the
    edge layout's algebra with every float op flushed.  Returns [a, F]."""
    delta = torch.abs(ftz(new - old))
    s = torch.abs(ftz(new + old))
    ok = (2 * delta < ftz(stability * s)) | (delta == 0)
    return torch.all(ok | ~valid, dim=0)


def send_or_suppress(cand, prev, count, stability, valid, first):
    """SAME_COUNT send-suppression, lane-major (match flags [a, F])."""
    match = edge_match(cand, prev, stability, valid) & ~first
    send = ~match | (count < SAME_COUNT)
    sent = torch.where(send[None], cand, prev)
    new_count = torch.where(
        match, torch.clamp(count + 1, max=SAME_COUNT + 1),
        torch.ones_like(count))
    return sent, new_count, match


def var_messages(beliefs: torch.Tensor, sums: torch.Tensor,
                 msgs: torch.Tensor, var_ids: torch.Tensor,
                 var_valid: torch.Tensor) -> torch.Tensor:
    """One bucket's variable->factor candidates [D, a, F]: belief minus
    own contribution, mean-normalized over the valid domain slots, BIG
    on invalid slots (``beliefs``/``sums``/``var_valid`` [D, V+1])."""
    valid = var_valid[:, var_ids]                   # [D, a, F]
    raw = ftz(beliefs[:, var_ids] - msgs)
    factor_sum = ftz(sums[:, var_ids] - msgs)
    n_valid = torch.clamp(torch.sum(valid, dim=0, keepdim=True,
                                    dtype=torch.int32), min=1)
    avg = ftz(sum_domain(torch.where(valid, factor_sum, 0.0)) / n_valid)
    return torch.where(valid, ftz(raw - avg), float(BIG))


def lane_send_update_reference(cand: torch.Tensor, prev: torch.Tensor,
                               count: torch.Tensor, var_ids: torch.Tensor,
                               var_valid: torch.Tensor, cycle: torch.Tensor,
                               stable: torch.Tensor, *, damping: float,
                               stability: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain epilogue: damp ``cand`` against ``prev`` (``damping`` 0:
    none), send or keep, and AND the bucket's all-match over live edges
    into ``stable`` (in place).  Returns (sent, counts)."""
    first = cycle == 0
    valid = var_valid[:, var_ids]
    if damping > 0:
        cand = damp(cand, prev, damping, first)
    sent, new_count, match = send_or_suppress(cand, prev, count, stability,
                                              valid, first)
    stable.logical_and_(torch.all(match | ~torch.any(valid, dim=0)))
    return sent, new_count


def lane_v2f_update_reference(table: torch.Tensor, f2v: torch.Tensor,
                              prev: torch.Tensor, count: torch.Tensor,
                              var_ids: torch.Tensor, var_valid: torch.Tensor,
                              cycle: torch.Tensor, stable: torch.Tensor, *,
                              damping: float, stability: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain variable side of one bucket: :func:`var_messages` of
    its factor messages ``f2v`` against the beliefs and sums of the
    ``table`` [V+1, 2P], then :func:`lane_send_update_reference`
    against the last sent ``prev``."""
    cand = var_messages(*table_halves(table, f2v.shape[0]), f2v, var_ids,
                        var_valid)
    return lane_send_update_reference(cand, prev, count, var_ids, var_valid,
                                      cycle, stable, damping=damping,
                                      stability=stability)


def _check(named, dev):
    for name, t, dtype in named:
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"lane_var_update: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"lane_var_update: {name} on {t.device} but "
                             f"the messages on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"lane_var_update: {name} is not contiguous")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")


def _check_edges(prev, count, var_ids, var_valid, cycle, stable,
                 var_ids32, edge_valid, var_side):
    if var_ids.dim() != 2 or tuple(prev.shape[1:]) != tuple(var_ids.shape):
        raise ValueError(
            f"messages must be [D, arity, F] over var_ids [arity, F], got "
            f"{tuple(prev.shape)} and {tuple(var_ids.shape)}")
    for name, t in (("counts", count), ("var_ids32", var_ids32),
                    ("edge_valid", edge_valid)):
        if t is not None and t.shape != var_ids.shape:
            raise ValueError(f"{name} must be {tuple(var_ids.shape)}, got "
                             f"{tuple(t.shape)}")
    d = prev.shape[0]
    if var_valid.dim() != 2 or var_valid.shape[0] != d:
        raise ValueError(f"var_valid must be [D={d}, V+1], "
                         f"got {tuple(var_valid.shape)}")
    if cycle.numel() != 1 or stable.numel() != 1:
        raise ValueError("cycle and stable must be 0-d tensors")
    small = d <= EDGE_VALID_MAX_D
    if edge_valid is not None and not small:
        raise ValueError(f"edge_valid is for D <= {EDGE_VALID_MAX_D}, "
                         f"got D={d}")
    if prev.device.type == "cuda":
        if d > MAX_D:
            raise ValueError(f"lane_var_update takes D <= {MAX_D}, got {d}")
        missing = [name for name, t, need in (
            ("var_ids32", var_ids32, var_side or not small),
            ("edge_valid", edge_valid, small)) if need and t is None]
        if missing:
            raise ValueError(
                f"lane_var_update on the card needs the bucket's "
                f"{' and '.join(missing)} (device.to_lane_device_graph)")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load(KERNEL).lane_var_update_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(table, f2v, prev, count, var_ids32, edge_valid, var_valid,
            cycle, stable, damping, stability):
    """One kernel launch; ``table is None`` takes ``f2v`` as the
    candidates (the epilogue alone)."""
    d, arity, f = prev.shape
    if prev.numel() >= 2 ** 31 or var_valid.numel() >= 2 ** 31:
        raise ValueError(f"bucket too large for one launch: F={f}, "
                         f"arity={arity}, D={d}")
    out = torch.empty_like(prev)
    out_count = torch.empty_like(count)
    if f * arity == 0:
        return out, out_count
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(prev.device):
        err = _launcher()(
            ptr(table), f2v.data_ptr(), prev.data_ptr(), count.data_ptr(),
            ptr(var_ids32), ptr(edge_valid), var_valid.data_ptr(),
            cycle.data_ptr(), out.data_ptr(), out_count.data_ptr(),
            stable.data_ptr(), f * arity, var_valid.shape[1], d,
            row_floats(d), _damp_mode(damping), float(np.float32(damping)),
            float(np.float32(1.0 - damping)), float(np.float32(stability)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"lane_var_update launch failed: CUDA error {err}")
    _build.launch_counts[V2F if table is not None else SEND] += 1
    return out, out_count


def lane_v2f_update(table: torch.Tensor, f2v: torch.Tensor,
                    prev: torch.Tensor, count: torch.Tensor,
                    var_ids: torch.Tensor, var_valid: torch.Tensor,
                    cycle: torch.Tensor, stable: torch.Tensor, *,
                    damping: float, stability: float,
                    var_ids32: Optional[torch.Tensor] = None,
                    edge_valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One bucket's sent variable->factor messages [D, a, F] f32 and
    counts [a, F] int8 from the beliefs/sums table [V+1, 2P] f32
    (``ops/lane_sum.py::lane_sum_table``), the bucket's last factor
    messages ``f2v`` and last sent ``prev`` [D, a, F] f32, its counts,
    ``var_ids`` [a, F] int64, ``var_valid`` [D, V+1] bool and the 0-d
    int32 ``cycle``; ANDs the bucket's all-match into the 0-d bool
    ``stable`` in place.  ``damping`` 0 damps nothing.  The bucket's
    ``var_ids32`` [a, F] int32 and, at D <= 8, ``edge_valid`` [a, F]
    uint8 are what the kernel reads: a CUDA call without them raises.
    Equal to :func:`lane_v2f_update_reference` bit for bit."""
    dev = prev.device
    _check([("table", table, torch.float32), ("f2v", f2v, torch.float32),
            ("prev", prev, torch.float32), ("count", count, torch.int8),
            ("var_ids", var_ids, torch.int64),
            ("var_valid", var_valid, torch.bool),
            ("cycle", cycle, torch.int32), ("stable", stable, torch.bool),
            ("var_ids32", var_ids32, torch.int32),
            ("edge_valid", edge_valid, torch.uint8)], dev)
    _check_edges(prev, count, var_ids, var_valid, cycle, stable, var_ids32,
                 edge_valid, var_side=True)
    p = row_floats(prev.shape[0])
    if f2v.shape != prev.shape or tuple(table.shape) != (
            var_valid.shape[1], 2 * p):
        raise ValueError(
            f"f2v {tuple(f2v.shape)} must match prev {tuple(prev.shape)} "
            f"and the table {tuple(table.shape)} be [V+1, 2P = {2 * p}] "
            f"for var_valid {tuple(var_valid.shape)}")
    if dev.type == "cpu":
        return lane_v2f_update_reference(
            table, f2v, prev, count, var_ids, var_valid, cycle, stable,
            damping=damping, stability=stability)
    return _launch(table, f2v, prev, count, var_ids32, edge_valid,
                   var_valid, cycle, stable, damping, stability)


def lane_send_update(cand: torch.Tensor, prev: torch.Tensor,
                     count: torch.Tensor, var_ids: torch.Tensor,
                     var_valid: torch.Tensor, cycle: torch.Tensor,
                     stable: torch.Tensor, *, damping: float,
                     stability: float,
                     var_ids32: Optional[torch.Tensor] = None,
                     edge_valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The epilogue alone for one bucket's factor->variable candidates
    ``cand`` [D, a, F] f32 (arguments as :func:`lane_v2f_update`; at
    D <= 8 the kernel reads ``edge_valid`` and no index, above 8
    ``var_ids32`` and ``var_valid``).  Equal to
    :func:`lane_send_update_reference` bit for bit."""
    dev = prev.device
    _check([("cand", cand, torch.float32), ("prev", prev, torch.float32),
            ("count", count, torch.int8), ("var_ids", var_ids, torch.int64),
            ("var_valid", var_valid, torch.bool),
            ("cycle", cycle, torch.int32), ("stable", stable, torch.bool),
            ("var_ids32", var_ids32, torch.int32),
            ("edge_valid", edge_valid, torch.uint8)], dev)
    _check_edges(prev, count, var_ids, var_valid, cycle, stable, var_ids32,
                 edge_valid, var_side=False)
    if cand.shape != prev.shape:
        raise ValueError(f"cand {tuple(cand.shape)} must match prev "
                         f"{tuple(prev.shape)}")
    if dev.type == "cpu":
        return lane_send_update_reference(
            cand, prev, count, var_ids, var_valid, cycle, stable,
            damping=damping, stability=stability)
    return _launch(None, cand, prev, count, var_ids32, edge_valid,
                   var_valid, cycle, stable, damping, stability)
