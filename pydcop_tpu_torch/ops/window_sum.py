"""Whole-graph float32 totals in XLA:CPU's order.

The reference's totals (``pydcop_tpu/ops/localsearch.py:139
assignment_cost``, ``ops/maxsum.py:559 assignment_constraint_cost`` and
the trace's variable-side sum, ``observability/engine_probe.py``'s cost
and residual) are ``jnp.sum``s of float32 operands.  The optimised HLO
of each, jitted (jax 0.9.0), reduces the operand read in row-major
order:

- with an axis longer than 32, as a chain of windowed reductions
  (``reduce-window``): each axis longer than 32 padded with zeros to a
  multiple of 32, half the padding (rounded down) in front, and cut
  into windows of 32, each shorter axis taken whole; each window box
  summed in row-major order from +0.0; again while an axis is longer
  than 32; then what is left summed left to right from +0.0 (a
  ``[1.5M]`` vector: 46,875, 1,465, 46 and 2 values; an
  ``[F, 2, 3]`` message residual: windows of 32 x 2 x 3);
- with no axis longer than 32, directly, in row-major order: left to
  right, except for <= 32 values inside the loop fusion that gathers them,
  where LLVM may vectorise the sum: lanes of 4, 8 or 16 strided slots,
  each lane from +0.0 (lane 0 from the running sum), folded by halves,
  then the rest left to right.  Which form depends on the site, the
  gather's arity, the domain size and the count (:func:`gather_stages`,
  from probes of each site over arity 1-4, D 1-8, 1-33 values);
- a one-value sum is a copy: no add, no flush.

XLA:CPU treats subnormal inputs as zeros of their sign and flushes every
subnormal result.  Bucket totals are chained in the reference's source
order with :func:`add`.  CUDA's ``torch.sum`` follows no fixed order, so
no torch call gives these bits: :func:`window_tree_sum` runs the chain
itself, as plain torch for a CPU tensor and as the hand kernel
``csrc/window_sum.cu`` (one thread a window, one launch a level, then one
thread for the last values) for a CUDA tensor.
"""

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops.flush import ftz

WINDOW = 32
KERNEL = "window_sum"
COUNTER = f"{KERNEL}:window_tree_sum"

# The head of a direct (<= 32 values) sum: (lanes, end) stages, each
# summing slots [previous end, end) into ``lanes`` strided lanes (lane 0
# from the running sum, the others from +0.0) folded by halves; the
# slots after the last stage are added left to right.  () is left to
# right throughout.
Stages = Tuple[Tuple[int, int], ...]
MAX_STAGES = 2
_L4x8: Stages = ((4, 8),)
_L8x16: Stages = ((8, 16),)
_L8x24: Stages = ((8, 24),)
_L8x32: Stages = ((8, 32),)
_L16x32: Stages = ((16, 32),)
_L4x16_2x20: Stages = ((4, 16), (2, 20))
_L8x16_2x20: Stages = ((8, 16), (2, 20))


def gather_stages(site: str, arity: int, d: int, n: int,
                  widest: int = 2) -> Stages:
    """The head of the reference's sum of ``n`` gathered costs at
    ``site``, for a bucket of ``arity`` (0: the variable costs) with
    domain size ``d`` in a graph whose widest bucket has arity
    ``widest``.  Sites: ``"localsearch"`` (``assignment_cost``'s
    per-position gathers), ``"maxsum"`` (``assignment_constraint_cost``'s
    flat-index gather and the trace's variable-side gather, the graph a
    jit argument) and ``"probe"`` (the same sums jitted with the graph
    closed over as constants, as the engine probe does).  Above 32
    values the window chain decides and the head is unused.  Probed at
    arity 0-4, D in 1..8, n in 1..33 (jax 0.9.0, XLA:CPU, optimised
    HLO and the sums' bits).  Open (ROADMAP Queue C): D = 1 with arity
    >= 2 and arity above 4 (taken left to right), and at ``"probe"`` a
    binary bucket of 20-23 factors beside a bucket of arity >= 3, where
    LLVM's choice follows no rule found (lanes of 8 taken; lanes of 4
    in 3 of 24 probed cases)."""
    if n > WINDOW or n < 8 or d < 2:
        return ()
    if n == 8:
        if arity >= 3 and (site == "maxsum" or (arity >= 4 and (
                site == "probe" or d >= 3))):
            return _L4x8
        return ()
    if arity <= 1:
        if d == 2:
            first = 25
        elif site == "localsearch" and arity == 0 and d == 3:
            first = 23
        else:
            first = 22
        if n < first:
            return ()
        if n < 24:
            return _L4x16_2x20
        return _L8x24 if n < 32 else _L8x32
    if arity > 4 or n < 16:
        return ()
    if n < 20 or (n < 24 and site == "localsearch" and arity >= 3):
        return _L8x16
    if n < 24:
        if site == "probe" or (site == "maxsum" and arity == 2
                               and d & (d - 1) and widest <= 2):
            return _L8x16_2x20
        return _L4x16_2x20
    if n < 32:
        return _L8x24
    return _L16x32 if site == "localsearch" and arity >= 3 else _L8x32


def residual_lanes(shape) -> int:
    """The row lanes of the reference's ``jnp.sum(jnp.abs(b - a))`` over
    [F, arity, D] messages (the engine probe's residual): LLVM
    vectorises each row over the arity axis when it is 2, 4 or 8 and
    2 <= D <= 8, in the windows of the first level (F > 32), and in a
    direct sum (F <= 32) only at arity 4 or 8 (optimised IR of the
    jitted reference, jax 0.9.0); else the row is left to right."""
    f, arity, d = shape
    if arity not in (2, 4, 8) or not 2 <= d <= 8:
        return 1
    if f > WINDOW or arity > 2:
        return arity
    return 1


def _levels(shape):
    """XLA's windowed levels of a sum over every axis of ``shape`` (at
    most three axes, read as [n0, n1, n2] with leading ones): while an
    axis is longer than 32, each axis longer than 32 is padded to a
    multiple of 32 (half the padding in front) and cut into windows of
    32, each shorter axis taken whole, and each window box reduces to
    one value.  Returns ``([(shape, front, window, out)], last shape)``."""
    if len(shape) > 3:
        raise ValueError(f"window_tree_sum takes at most 3 axes, got "
                         f"{tuple(shape)}")
    shape = (1,) * (3 - len(shape)) + tuple(int(s) for s in shape)
    levels = []
    if 0 in shape:
        return levels, (0, 0, 0)
    while any(s > WINDOW for s in shape):
        pads = [(-s) % WINDOW if s > WINDOW else 0 for s in shape]
        window = tuple(WINDOW if s > WINDOW else s for s in shape)
        out = tuple((s + p) // w for s, p, w in zip(shape, pads, window))
        levels.append((shape, tuple(p // 2 for p in pads), window, out))
        shape = out
    return levels, shape


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` as XLA:CPU adds: subnormal operands read as zeros of
    their sign, a subnormal result flushed."""
    return ftz(ftz(a) + ftz(b))


def _head_sum(x: torch.Tensor, head: Stages) -> torch.Tensor:
    """The plain direct sum of the <= 32 flushed values ``x``."""
    n = x.numel()
    acc = torch.zeros((), dtype=x.dtype, device=x.device)
    start = 0
    for lanes, end in head:
        end = min(end, n)
        sums = [acc] + [torch.zeros_like(acc)] * (lanes - 1)
        for i in range(start, end):
            k = (i - start) % lanes
            sums[k] = ftz(sums[k] + x[i])
        while len(sums) > 1:
            half = len(sums) // 2
            sums = [ftz(sums[i] + sums[i + half]) for i in range(half)]
        acc, start = sums[0], end
    for i in range(start, n):
        acc = ftz(acc + x[i])
    return acc


def _plan(shape, lanes: int):
    """``(levels, last shape)`` of :func:`_levels`, with a direct sum in
    row lanes (``lanes > 1`` and no axis longer than 32) taken as one
    level whose window is the whole operand."""
    levels, last = _levels(shape)
    if lanes > 1 and not levels and 0 not in last:
        levels = [(last, (0, 0, 0), last, (1, 1, 1))]
        last = (1, 1, 1)
    return levels, last


def _level_sum(boxes: torch.Tensor, lanes: int) -> torch.Tensor:
    """[M] sums of the [M, w0, w1, w2] window boxes in row-major order
    from +0.0; with ``lanes > 1`` (= w1) each row of a box is summed in
    ``lanes`` lanes, one an axis-1 slot (lane 0 from the running sum,
    the others from -0.0, each over axis 2 in order), folded by halves
    into the running sum."""
    acc = torch.zeros(boxes.shape[:1], dtype=boxes.dtype,
                      device=boxes.device)
    w0, w1, w2 = boxes.shape[1:]
    for i0 in range(w0):
        if lanes == 1:
            for i1 in range(w1):
                for i2 in range(w2):
                    acc = ftz(acc + boxes[:, i0, i1, i2])
            continue
        sums = [acc] + [torch.full_like(acc, -0.0)] * (lanes - 1)
        for k in range(lanes):
            for i2 in range(w2):
                sums[k] = ftz(sums[k] + boxes[:, i0, k, i2])
        while len(sums) > 1:
            half = len(sums) // 2
            sums = [ftz(sums[i] + sums[i + half]) for i in range(half)]
        acc = sums[0]
    return acc


def window_tree_sum_plain(x: torch.Tensor, head: Stages = (),
                          lanes: int = 1) -> torch.Tensor:
    """The plain torch version of :func:`window_tree_sum`: a 0-d float32
    tensor on ``x``'s device."""
    if x.numel() == 1:
        return x.reshape(-1)[0].clone()
    levels, _ = _plan(x.shape, lanes)
    x = ftz(x.reshape(levels[0][0] if levels else -1))
    for level, (shape, front, window, out) in enumerate(levels):
        pad = []
        for n, f, w, m in reversed(list(zip(shape, front, window, out))):
            pad += [f, m * w - n - f]
        boxes = F.pad(x, pad).view(
            out[0], window[0], out[1], window[1], out[2], window[2])
        boxes = boxes.permute(0, 2, 4, 1, 3, 5).reshape(-1, *window)
        x = _level_sum(boxes, lanes if level == 0 else 1).view(out)
    return _head_sum(x.reshape(-1), () if levels else head)


def _stage_args(head: Stages):
    """``head`` as the kernel's ``MAX_STAGES`` (lanes, end) int pairs
    (unused stages (1, 0))."""
    if len(head) > MAX_STAGES or any(
            lanes not in (1, 2, 4, 8, 16) for lanes, _ in head):
        raise ValueError(f"unsupported sum head {head!r}")
    padded = list(head) + [(1, 0)] * (MAX_STAGES - len(head))
    return [v for stage in padded for v in stage]


def window_tree_sum(x: torch.Tensor, head: Stages = (),
                    lanes: int = 1) -> torch.Tensor:
    """Sum of every element of float32 ``x`` (at most three axes) in
    XLA:CPU's order for ``jnp.sum(x)``, as a 0-d float32 tensor on
    ``x``'s device.  ``head`` is the form of a direct sum of <= 32
    gathered values (:func:`gather_stages`); ``lanes`` > 1 sums each
    row of the first level's windows (or of a direct sum) in that many
    lanes over axis 1 (:func:`residual_lanes`).  On the CPU the plain
    version runs; on a CUDA tensor the kernel launches (it raises rather
    than fall back)."""
    if x.dtype != torch.float32:
        raise TypeError(f"window_tree_sum takes float32, got {x.dtype}")
    if x.device.type == "cpu":
        return window_tree_sum_plain(x, head, lanes)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.numel() == 1:
        return x.reshape(-1)[0].clone()
    levels, last = _plan(x.shape, lanes)
    if levels and lanes > 1 and levels[0][2][1] != lanes:
        raise ValueError(f"lanes={lanes} needs axis 1 of that length, "
                         f"got {tuple(x.shape)}")
    shape = levels[0][0] if levels else last
    stage_args = _stage_args(() if levels else head)
    scratch = torch.empty(
        (sum(o[0] * o[1] * o[2] for *_, o in levels) + 1,),
        dtype=torch.float32, device=x.device)
    x = x.contiguous()
    lib = _build.load(KERNEL)
    fn = lib.window_tree_sum
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * (2 * MAX_STAGES) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), *shape, lanes, scratch.data_ptr(),
                 *stage_args, stream)
    if err != 0:
        raise RuntimeError(
            f"window_sum kernel launch failed: CUDA error {err}")
    _build.launch_counts[COUNTER] += 1
    return scratch[-1]
