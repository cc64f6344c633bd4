"""Whole-graph float32 totals in XLA:CPU's order.

The reference's totals (``pydcop_tpu/ops/localsearch.py:139
assignment_cost``, ``ops/maxsum.py:559 assignment_constraint_cost`` and
the trace's variable-side sum, ``observability/engine_probe.py``'s cost
and residual) are ``jnp.sum``s of float32 operands, each a gather of
cost-table entries at the assignment or a plain array, added in source
order.  The optimised HLO of each, jitted (jax 0.9.0), reduces the
operand read in row-major order:

- with an axis longer than 32, as a chain of windowed reductions
  (``reduce-window``): each axis longer than 32 padded with zeros to a
  multiple of 32, half the padding (rounded down) in front, and cut
  into windows of 32, each shorter axis taken whole; each window box
  summed in row-major order from +0.0; again while an axis is longer
  than 32; then what is left summed left to right from +0.0 (a
  ``[1.5M]`` vector: 46,875, 1,465, 46 and 2 values; an
  ``[F, 2, 3]`` message residual: windows of 32 x 2 x 3);
- with no axis longer than 32, directly, in row-major order: left to
  right, except where LLVM vectorised the sum.  A sum of <= 32 values
  inside the loop fusion that gathers them goes in lanes of 2, 4, 8 or
  16 strided slots, each lane from +0.0 (lane 0 from the running sum),
  folded by halves, then the rest left to right; which form depends on
  the site, the gather's arity, the domain size and the count
  (:func:`gather_stages`).  The residual's rows may go in lanes over
  their arity axis (:func:`residual_lanes`) or, where one of its inner
  axes is 1, its rows in lanes (:func:`residual_rows`);
- a one-value sum is a copy: no add, no flush.

XLA:CPU treats subnormal inputs as zeros of their sign and flushes every
subnormal result.  CUDA's ``torch.sum`` follows no fixed order, so no
torch call gives these bits: :func:`window_total` computes a whole total
(the operands' sums chained with :func:`add`), as plain torch for CPU
tensors and as the hand kernel ``csrc/window_sum.cu`` for CUDA tensors:
one launch a total, the gathers fused in.
"""

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops.flush import ftz

WINDOW = 32
KERNEL = "window_sum"
# Launches of csrc/window_sum.cu: one a total, whichever entry.
COUNTER = f"{KERNEL}:window_total"

# The head of a direct (<= 32 values) sum: (lanes, end) stages, each
# summing slots [previous end, end) into ``lanes`` strided lanes (lane 0
# from the running sum, the others from +0.0) folded by halves; the
# slots after the last stage are added left to right.  () is left to
# right throughout.
Stages = Tuple[Tuple[int, int], ...]
MAX_STAGES = 2
MAX_LANES = 16
_L2x4: Stages = ((2, 4),)
_L4x8: Stages = ((4, 8),)
_L4x16: Stages = ((4, 16),)
_L4x20: Stages = ((4, 20),)
_L8x16: Stages = ((8, 16),)
_L8x24: Stages = ((8, 24),)
_L8x32: Stages = ((8, 32),)
_L16x32: Stages = ((16, 32),)
_L4x16_2x20: Stages = ((4, 16), (2, 20))
_L8x16_2x20: Stages = ((8, 16), (2, 20))

# Rows in lanes over axis 0 of a box: (lanes, end), the box's rows
# [0, end) in ``lanes`` lanes, row r into lane r % lanes; (1, 0) none.
Rows = Tuple[int, int]
NO_ROWS: Rows = (1, 0)


def _two_at_4(site: str, arity: int, d: int) -> bool:
    """Whether four gathered values go in two lanes."""
    if site == "maxsum":
        return arity in (6, 7) if d >= 2 else arity == 7
    if site == "localsearch":
        if d < 2:
            return arity >= 6
        return arity == 8 or (arity in (6, 7) and d >= 3)
    return False


def _four_at_8(site: str, arity: int, d: int) -> bool:
    """Whether eight gathered values go in four lanes."""
    if site == "maxsum":
        return 3 <= arity <= 7 if d >= 2 else 4 <= arity <= 7
    if site == "localsearch":
        if d < 2:
            return arity >= 4
        return arity >= 6 or (arity >= 4 and d >= 3)
    return 4 <= arity <= 7 if d >= 2 else 5 <= arity <= 7


def _localsearch_unit_domain(arity: int, n: int) -> Stages:
    """``assignment_cost``'s head at D = 1, arity >= 2, 16 <= n <= 32:
    the vector loop leaves at least one value to the scalar loop (at
    arity >= 6 and 20-23 values, lanes of 8 at every variable count
    probed, 12-80)."""
    if n == 16:
        return _L4x8
    if n == 24:
        return _L8x16
    if n > 24:
        return _L8x24
    if n < 20:
        return _L8x16
    if arity >= 6:
        return _L8x16
    return _L4x16 if n == 20 else _L4x16_2x20


# The neighbours' arities (_eight_beside) that put a bucket of 8
# factors in lanes at the local search's site, by (arity, D >= 3).
_EIGHT_NEAR_LOCALSEARCH = {(3, True): 3, (4, False): 2, (5, False): 1}


def _eight_beside(site: str, arity: int, d: int, near) -> bool:
    """Whether the direct sums beside a bucket of 8 factors put its sum
    in lanes, where alone it is left to right: LLVM's SLP vectoriser
    takes the 8 gathered values as one vector when the same straight
    block holds enough other direct sums.  Counted as
    :func:`_near_arities`, plus 1 at the local search's site for its
    variable costs when they are a direct sum (2-32 values; ``near``
    holds them as arity 0): at ``"maxsum"`` with D = 1 a ternary
    bucket needs 2, at ``"localsearch"`` a ternary one 3 (D >= 3), a
    4-ary one 2 and a 5-ary one 1 (D = 2)."""
    if site == "maxsum":
        return arity == 3 and d == 1 and _near_arities(site, near) >= 2
    if site != "localsearch" or d < 2:
        return False
    need = _EIGHT_NEAR_LOCALSEARCH.get((arity, d >= 3))
    if need is None:
        return False
    variables = any(a == 0 and 2 <= m <= WINDOW for a, m in near)
    return _near_arities(site, near) + variables >= need


def _near_arities(site: str, near) -> int:
    """The arities, added up, of the buckets in ``near`` summed directly
    (2-32 factors), not counting 8-ary ones at ``"maxsum"``."""
    return sum(a for a, m in near if 2 <= m <= WINDOW
               and not (site == "maxsum" and a == 8))


def _near_any(near, arities, most: int) -> bool:
    """Whether ``near`` holds a bucket of one of ``arities`` with 2 to
    ``most`` factors."""
    return any(a in arities and 2 <= m <= most for a, m in near)


# The lane layout's gathers at D = 1: the count from which LLVM
# vectorises a bucket's direct sum, by arity (none at arity 2; 16 from
# arity 7).
_LANE_UNIT_DOMAIN_FIRST = {1: 20, 2: WINDOW + 1, 3: 28, 4: 23, 5: 20, 6: 18}


def _lane_stages(arity: int, d: int, n: int, trace: bool) -> Stages:
    """The head of the lane layout's sum of ``n`` gathered costs
    (``maxsum_lane.assignment_constraint_cost``: ``take_along_axis`` of
    the ``[D^a, F]`` table, the graph a jit argument), 16 <= n <= 32:
    lanes of 8 from 16 values (18 for a binary bucket), of 4 then 2
    from 20, of 8 from 24; at D = 1 only from the count of
    ``_LANE_UNIT_DOMAIN_FIRST``, the second stage ending at 22 from 22
    values at arity >= 4.  Inside the traced run (``trace``) every
    bucket at D = 1 is left to right (every selected value is 0, so the
    gathers read contiguous rows: the probes' object code shows a
    scalar ``vaddss`` chain), and a unary bucket differs: from 19 values
    at D = 2, and in lanes of 8 then 2 at 20-23 values for D >= 3."""
    if trace and (d < 2 or (arity == 1 and d == 2 and n < 19)):
        return ()
    if trace and arity == 1:
        if d >= 3 and 20 <= n < 24:
            return _L8x16_2x20
    if d < 2 and n < _LANE_UNIT_DOMAIN_FIRST.get(arity, 16):
        return ()
    if d >= 2 and arity == 2 and n < 18:
        return ()
    if n < 20:
        return _L8x16
    if n < 24:
        if d < 2 and arity >= 4 and n >= 22:
            return ((4, 16), (2, 22))
        return _L4x16_2x20
    return _L8x24 if n < 32 else _L8x32


def gather_stages(site: str, arity: int, d: int, n: int,
                  widest: int = 2, near: Sequence[Tuple[int, int]] = ()
                  ) -> Stages:
    """The head of the reference's sum of ``n`` gathered costs at
    ``site``, for a bucket of ``arity`` (0: the variable costs) with
    domain size ``d`` in a graph whose widest bucket has arity
    ``widest`` and whose other buckets have the (arity, factors) of
    ``near`` (for the variable costs: every bucket).  Sites:
    ``"localsearch"`` (``assignment_cost``'s per-position gathers),
    ``"maxsum"`` (``assignment_constraint_cost``'s flat-index gather and
    the trace's variable-side gather, the graph a jit argument),
    ``"probe"`` (the same sums jitted with the graph closed over as
    constants, as the engine probe does), ``"lane"`` (the lane layout's
    ``assignment_constraint_cost`` and variable-cost gather, the graph
    a jit argument: :func:`_lane_stages`, where no neighbouring bucket
    was seen to change a form), ``"lane_trace"`` (the same inside the
    lane layout's traced run) and ``"eager"`` (each sum its
    own program over the gathered values, as when the reference's
    ``assignment_cost`` runs outside a jit: no vectorised head, left to
    right).

    The buckets summed directly (2-32 factors) in the same loop fusion
    change three forms (at the local search's site ``near`` also holds
    the variable costs, as ``(0, V)``):

    - a sum of the variable costs (arity 0, ``"localsearch"``) or of a
      unary bucket (arity 1, ``"localsearch"`` and ``"maxsum"``) goes in
      lanes from 22 values at D = 2 and 20 at D >= 3 (25 and 22 alone)
      when their arities add up to 5 or more (at ``"maxsum"`` not
      counting 8-ary ones);
    - at ``"maxsum"``, beside a bucket of arity 3, 4, 6 or 7, a 5-ary
      bucket of 20-23 factors goes in lanes of 4 then 2, not 8, and one
      of 32 in lanes of 8, not 16;
    - a bucket of 8 factors goes in lanes when the other direct sums
      are enough (:func:`_eight_beside`: at ``"maxsum"`` with D = 1 a
      ternary bucket beside arities adding up to 2; at
      ``"localsearch"``, counting its variable costs as 1 while V <= 32,
      a ternary bucket at 3 with D >= 3, a 4-ary one at 2 and a 5-ary
      one at 1 with D = 2).

    Above 32 values the window chain decides and the head is unused.
    Probed at arity 0-8, D in 1..8 (tables up to 2**16 entries a
    factor), n in 1..33, one bucket beside the variable costs and one or
    two beside another (jax 0.9.0, XLA:CPU, optimised HLO and IR and the
    sums' bits).  Open (ROADMAP Queue C): at ``"probe"`` the graph's
    var_ids are constants and LLVM's choice for a bucket beside another
    one can follow their values."""
    if n > WINDOW or n < 2 or site == "eager":
        return ()
    if site in ("lane", "lane_trace") and arity >= 1:
        return (_lane_stages(arity, d, n, site == "lane_trace")
                if n >= 16 else ())
    if arity <= 1:
        if d < 2 or n <= 8:
            return ()
        if ((site == "localsearch" or (site == "maxsum" and arity == 1))
                and _near_arities(site, near) >= 5):
            first = 22 if d == 2 else 20
        elif site in ("lane", "lane_trace"):
            first = 28 if d == 2 else 22
        else:
            first = 25 if d == 2 else 22
        if n < first:
            return ()
        if n < 24:
            return _L4x16_2x20
        return _L8x24 if n < 32 else _L8x32
    if n < 8:
        return _L2x4 if n == 4 and _two_at_4(site, arity, d) else ()
    if n == 8:
        if _four_at_8(site, arity, d) or _eight_beside(site, arity, d,
                                                       near):
            return _L4x8
        return ()
    if n < 16:
        return ()
    if arity <= 4 and d >= 2:
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
    # Arity above 4, or one-value domains (the index needs no multiply).
    if site == "localsearch" and d < 2:
        return _localsearch_unit_domain(arity, n)
    if n < 20:
        return _L8x16
    if n < 24:
        if site == "maxsum" and arity == 5 and _near_any(
                near, (3, 4, 6, 7), WINDOW):
            return _L4x16_2x20
        if site == "probe" and arity <= 6:
            return _L8x16_2x20
        if site == "localsearch" and arity >= 7:
            return _L4x20
        return _L8x16
    if n < 32:
        return _L8x24
    if ((site == "probe" and arity <= 6 and d >= 2)
            or (site == "localsearch" and arity >= 7)
            or (site == "maxsum" and arity == 5
                and _near_any(near, (3, 4, 6, 7), WINDOW))):
        return _L8x32
    return _L16x32


# The widest domain at which LLVM vectorises a residual row over its
# arity axis, by arity: windowed (F > 32) and direct (F <= 32).
_LANES_MAX_D = {2: (8, 1), 4: (8, 9), 8: (8, 16)}


def residual_lanes(shape) -> int:
    """The row lanes of the reference's ``jnp.sum(jnp.abs(b - a))`` over
    [F, arity, D] messages (the engine probe's residual): LLVM
    vectorises each row over the arity axis when it is 2, 4 or 8 and
    2 <= D <= 8 in the windows of the first level (F > 32), and in a
    direct sum (F <= 32) at arity 4 for D <= 9 and at arity 8 for
    D <= 16; at arity 16 in 8 lanes (slots k and k + 8 in lane k) for
    D <= 6 windowed and D <= 18 direct, in 4 lanes for D = 7-8 windowed
    (optimised IR and bits of the jitted reference, jax 0.9.0); else
    the row is left to right (or in :func:`residual_rows`)."""
    f, arity, d = shape
    if d < 2:
        return 1
    if arity == 16:
        if f > WINDOW:
            return 8 if d <= 6 else 4 if d <= 8 else 1
        return 8 if d <= 18 else 1
    if arity not in _LANES_MAX_D:
        return 1
    windowed, direct = _LANES_MAX_D[arity]
    return arity if d <= (windowed if f > WINDOW else direct) else 1


def residual_rows(shape) -> Rows:
    """Rows in lanes of the residual over [F, arity, D] messages with a
    unit inner axis (arity 1, or D = 1), rows of R = arity * D values:
    LLVM vectorises the loop over a box's rows (each row's values in
    order into lane r % lanes), over the F rows of a direct sum (F <=
    32), over each window's 32 rows where F is a multiple of 32, or with
    the trip count known only at run time where F = 31 mod 32 (the
    windows end on padding); with other paddings the loop is not
    vectorised.  The form follows R and the trip count (probes of the
    jitted reference, jax 0.9.0, R in 1..16, F in 2..33 and 40..1,024)."""
    f, arity, d = shape
    r = arity * d
    if (arity > 1 and d > 1) or not 2 <= r <= 13:
        return NO_ROWS
    if r >= 12:
        return (8, 8) if f == 8 else NO_ROWS
    if f > WINDOW:
        if f % WINDOW == 0:
            if r >= 9:
                return NO_ROWS
            return (4, 32) if r >= 7 else (8, 32)
        if f % WINDOW == WINDOW - 1 and r <= 8:
            return (8, 24) if r == 2 else (4, 28)
        return NO_ROWS
    if f == 4:
        return (4, 4) if r <= 8 else NO_ROWS
    if f == 8:
        return (8, 8)
    if f < 16:
        return NO_ROWS
    if f < 20:
        return (8, 16)
    if f < 24:
        return (4, 20) if r <= 8 else (8, 16)
    if f < 28 or r == 2 or r >= 9:
        return (8, 24) if f < 32 else (8, 32)
    return (4, 28) if f < 32 else (8, 32)


def _levels(shape):
    """XLA's windowed levels of a sum over every axis of ``shape`` (at
    most three axes, read as [n0, n1, n2] with leading ones): while an
    axis is longer than 32, each axis longer than 32 is padded to a
    multiple of 32 (half the padding in front) and cut into windows of
    32, each shorter axis taken whole, and each window box reduces to
    one value.  Returns ``([(shape, front, window, out)], last shape)``."""
    if len(shape) > 3:
        raise ValueError(f"window sums take at most 3 axes, got "
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
    """The plain direct sum of the flushed values ``x``."""
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


def _plan(shape, lanes: int, rows: Rows):
    """``(levels, last shape)`` of :func:`_levels`, with a direct sum in
    lanes (``lanes > 1`` or ``rows``, and no axis longer than 32) taken
    as one level whose window is the whole operand."""
    levels, last = _levels(shape)
    if ((lanes > 1 or rows[0] > 1) and not levels and 0 not in last):
        levels = [(last, (0, 0, 0), last, (1, 1, 1))]
        last = (1, 1, 1)
    return levels, last


def _fold(sums):
    while len(sums) > 1:
        half = len(sums) // 2
        sums = [ftz(sums[i] + sums[i + half]) for i in range(half)]
    return sums[0]


def _level_sum(boxes: torch.Tensor, lanes: int,
               rows: Rows = NO_ROWS) -> torch.Tensor:
    """[M] sums of the [M, w0, w1, w2] window boxes in row-major order
    from +0.0.  With ``lanes > 1`` (dividing w1) each row of a box is
    summed in ``lanes`` lanes, axis-1 slot j into lane j % lanes (lane 0
    from the running sum, the others from -0.0; each slot's values over
    axis 2 in order, the slots of a lane in order), folded by halves
    into the running sum.  With ``rows = (k, e)``, k > 1, the box's rows
    [0, e) go first in k lanes (row r into lane r % k, its values in
    order; lane 0 from +0.0, the others from -0.0), folded by halves."""
    acc = torch.zeros(boxes.shape[:1], dtype=boxes.dtype,
                      device=boxes.device)
    w0, w1, w2 = boxes.shape[1:]
    first = 0
    if rows[0] > 1:
        sums = [acc] + [torch.full_like(acc, -0.0)] * (rows[0] - 1)
        for r in range(rows[1]):
            k = r % rows[0]
            for i1 in range(w1):
                for i2 in range(w2):
                    sums[k] = ftz(sums[k] + boxes[:, r, i1, i2])
        acc, first = _fold(sums), rows[1]
    for i0 in range(first, w0):
        if lanes == 1:
            for i1 in range(w1):
                for i2 in range(w2):
                    acc = ftz(acc + boxes[:, i0, i1, i2])
            continue
        sums = [acc] + [torch.full_like(acc, -0.0)] * (lanes - 1)
        for i1 in range(w1):
            for i2 in range(w2):
                sums[i1 % lanes] = ftz(sums[i1 % lanes]
                                       + boxes[:, i0, i1, i2])
        acc = _fold(sums)
    return acc


def _check_form(levels, lanes: int, rows: Rows):
    """Refuse row forms the first level's boxes cannot take: ``lanes``
    must divide axis 1's length, ``rows`` fit the box's rows."""
    if not levels:
        return
    window = levels[0][2]
    if lanes > 1 and window[1] % lanes:
        raise ValueError(f"lanes={lanes} must divide axis 1, got a box "
                         f"of {window}")
    if rows[0] > 1 and rows[1] > window[0]:
        raise ValueError(f"rows={rows} needs {rows[1]} rows, got a box "
                         f"of {window}")
    if lanes > MAX_LANES or rows[0] > MAX_LANES:
        raise ValueError(f"at most {MAX_LANES} lanes")


def window_tree_sum_plain(x: torch.Tensor, head: Stages = (),
                          lanes: int = 1,
                          rows: Rows = NO_ROWS) -> torch.Tensor:
    """The plain torch version of :func:`window_tree_sum`: a 0-d float32
    tensor on ``x``'s device."""
    if x.numel() == 1:
        return x.reshape(-1)[0].clone()
    levels, _ = _plan(x.shape, lanes, rows)
    _check_form(levels, lanes, rows)
    x = ftz(x.reshape(levels[0][0] if levels else -1))
    for level, (shape, front, window, out) in enumerate(levels):
        pad = []
        for n, f, w, m in reversed(list(zip(shape, front, window, out))):
            pad += [f, m * w - n - f]
        boxes = F.pad(x, pad).view(
            out[0], window[0], out[1], window[1], out[2], window[2])
        boxes = boxes.permute(0, 2, 4, 1, 3, 5).reshape(-1, *window)
        first = level == 0
        x = _level_sum(boxes, lanes if first else 1,
                       rows if first else NO_ROWS).view(out)
    return _head_sum(x.reshape(-1), () if levels else head)


def folded_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of float32 values that XLA computes while compiling: a
    ``jnp.sum`` whose operand is a constant of the jitted program (the
    cost trace's variable-side sum at D = 1, where every value is 0 and
    the engine closes the costs over).  The tree-reduction rewrite runs
    once before the constant folder evaluates the sum on the host: above
    32 values, the first level of :func:`_levels` (windows of 32, each
    left to right in float32 from +0.0), then one reduce of what is left,
    which the folder sums left to right in float64 from 0.0 and rounds
    once to float32 (read off the optimised HLO after each pass and the
    bits of the jitted reference, jax 0.9.0, 1 to 40,000 values).
    Returns a [1] float32 tensor on ``x``'s device: a one-value operand
    of :func:`window_total` (a copy, no add)."""
    x = x.reshape(-1).to(torch.float32)
    levels, _ = _levels(x.shape)
    if levels:
        shape, front, _window, out = levels[0]
        n, f, m = shape[2], front[2], out[2]
        boxes = F.pad(x, [f, m * WINDOW - n - f]).view(m, WINDOW)
        x = torch.zeros((m,), dtype=torch.float32, device=x.device)
        for k in range(WINDOW):
            x = x + boxes[:, k]
    if not x.numel():
        return torch.zeros((1,), dtype=torch.float32, device=x.device)
    return _sum64(x[:, None])


def _sum64(rows: torch.Tensor) -> torch.Tensor:
    """Each column of ``rows`` summed down its rows left to right in
    float64 from 0.0, rounded once to float32."""
    acc = torch.zeros(rows.shape[1:], dtype=torch.float64,
                      device=rows.device)
    for r in rows:
        acc = acc + r.to(torch.float64)
    return acc.to(torch.float32)


class Gather(NamedTuple):
    """A cost-gather operand: factor f's entry ``table[f, sum_p
    values[ids[f, p]] * d ** (arity - 1 - p)]`` for f < ``count``
    (``ids`` [count, arity]; an id past the values reads 0), or
    ``table[f, values[f]]`` with ``ids`` None (the variable costs).
    ``table`` is [rows >= count, row length] float32 and contiguous;
    ``head`` the form of its direct sum (:func:`gather_stages`)."""

    table: torch.Tensor
    ids: Optional[torch.Tensor]
    count: int
    d: int
    head: Stages = ()


class Plain(NamedTuple):
    """A float32 operand of at most three axes, summed whole: ``head``
    for a direct sum, ``lanes`` row lanes over axis 1 and ``rows`` rows
    in lanes over axis 0 at the first level (:func:`residual_lanes`,
    :func:`residual_rows`)."""

    x: torch.Tensor
    head: Stages = ()
    lanes: int = 1
    rows: Rows = NO_ROWS


Operand = Union[Gather, Plain]


def gathered(op: Gather, values: torch.Tensor) -> torch.Tensor:
    """The plain torch [count] vector of ``op``'s entries at ``values``."""
    vals = values.to(torch.int64).reshape(-1)
    n_values = vals.shape[0]
    if op.ids is None:
        flat = vals[:op.count]
    else:
        ids = op.ids[:op.count].to(torch.int64)
        picked = torch.where(
            ids < n_values, vals[ids.clamp(max=max(n_values - 1, 0))]
            if n_values else torch.zeros_like(ids), 0)
        flat = torch.zeros((op.count,), dtype=torch.int64,
                           device=ids.device)
        for p in range(ids.shape[1]):
            flat = flat * op.d + picked[:, p]
    table = op.table[:op.count]
    return torch.gather(table, 1, flat[:, None]).reshape(-1)


def _operand_sum_plain(op: Operand, values) -> torch.Tensor:
    if isinstance(op, Gather):
        return window_tree_sum_plain(gathered(op, values), op.head)
    return window_tree_sum_plain(op.x, op.head, op.lanes, op.rows)


def window_total_plain(operands: Sequence[Operand],
                       values: Optional[torch.Tensor] = None,
                       from_zero: bool = False) -> torch.Tensor:
    """The plain torch version of :func:`window_total`."""
    parts = [_operand_sum_plain(op, values) for op in operands]
    if not parts:
        return torch.zeros((), dtype=torch.float32)
    total = add(torch.zeros_like(parts[0]), parts[0]) if from_zero \
        else parts[0]
    for part in parts[1:]:
        total = add(total, part)
    return total


# The kernel's descriptor (csrc/window_sum.cu Operand and Desc).
_DIRECT, _ROWS, _GENERAL = 0, 1, 2
MAX_OPERANDS = 16


class _Operand(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_void_p), ("ids", ctypes.c_void_p),
        ("n", ctypes.c_longlong * 3), ("row", ctypes.c_longlong),
        ("item0", ctypes.c_longlong), ("items", ctypes.c_longlong),
        ("part", ctypes.c_longlong), ("fin", ctypes.c_longlong),
        ("gather", ctypes.c_int), ("arity", ctypes.c_int),
        ("d", ctypes.c_int), ("lanes1", ctypes.c_int),
        ("lanes0", ctypes.c_int), ("end0", ctypes.c_int),
        ("head_lanes", ctypes.c_int * MAX_STAGES),
        ("head_end", ctypes.c_int * MAX_STAGES),
        ("path", ctypes.c_int), ("unused", ctypes.c_int),
    ]


class _Desc(ctypes.Structure):
    _fields_ = [
        ("n_ops", ctypes.c_int), ("from_zero", ctypes.c_int),
        ("n_values", ctypes.c_longlong), ("n_items", ctypes.c_longlong),
        ("op", _Operand * MAX_OPERANDS),
    ]


def _check_head(head: Stages):
    if len(head) > MAX_STAGES or any(
            lanes not in (1, 2, 4, 8, 16) for lanes, _ in head):
        raise ValueError(f"unsupported sum head {head!r}")


def _layout(shape):
    """``(path, items, partials, finishing floats)`` of an operand of
    ``shape``: a direct sum is one item; with only axis 0 longer than 32
    an item is one second-level window (its partial in scratch; with at
    most 32 first-level windows one item makes the total); else an item
    is 32 first-level boxes, in the finishing area."""
    levels, last = _levels(shape)
    if not levels:
        return _DIRECT, 1, 1, 0
    (n, _, _, out1), rest = levels[0], levels[1:]
    if n[1] <= WINDOW and n[2] <= WINDOW:
        m1 = out1[0]
        if m1 <= WINDOW:
            return _ROWS, 1, 1, 0
        m2 = rest[0][3][0]
        return _ROWS, m2, m2, sum(o[0] for *_, o in rest[1:])
    m1 = out1[0] * out1[1] * out1[2]
    return (_GENERAL, -(-m1 // WINDOW), 0,
            m1 + sum(o[0] * o[1] * o[2] for *_, o in rest))


def _describe(operands: Sequence[Operand], values, from_zero: bool):
    """The kernel's descriptor and scratch floats for ``operands``."""
    if len(operands) > MAX_OPERANDS:
        raise ValueError(f"window_total takes at most {MAX_OPERANDS} "
                         f"operands, got {len(operands)}")
    desc = _Desc()
    desc.n_ops = len(operands)
    desc.from_zero = int(from_zero)
    if values is not None:
        desc.n_values = values.numel()
    item = scratch = 0
    for k, op in enumerate(operands):
        o = desc.op[k]
        head = op.head
        _check_head(head)
        if isinstance(op, Gather):
            o.gather, o.x, o.d = 1, op.table.data_ptr(), op.d
            o.row = op.table.shape[1]
            o.arity = 0 if op.ids is None else op.ids.shape[1]
            o.ids = 0 if op.ids is None else op.ids.data_ptr()
            shape, lanes, rows = (op.count, 1, 1), 1, NO_ROWS
        else:
            o.x = op.x.data_ptr()
            shape = (1,) * (3 - op.x.dim()) + tuple(op.x.shape)
            lanes, rows = op.lanes, op.rows
            if lanes == 1 and rows == NO_ROWS:
                # Leading ones last: the same boxes read in the same
                # order, with the long axis first (the kernel's fast path).
                body = tuple(shape)
                while len(body) > 1 and body[0] == 1:
                    body = body[1:]
                shape = body + (1,) * (3 - len(body))
        _check_form(_plan(shape, lanes, rows)[0], lanes, rows)
        if _levels(shape)[0]:
            head = ()
        elif head and shape[0] * shape[1] * shape[2] > WINDOW:
            raise ValueError("a sum head is for at most 32 values")
        path, items, parts, fin = _layout(shape)
        for i, s in enumerate(shape):
            o.n[i] = s
        o.lanes1, (o.lanes0, o.end0) = lanes, rows
        stages = list(head) + [(1, 0)] * (MAX_STAGES - len(head))
        for s, (lanes_s, end_s) in enumerate(stages):
            o.head_lanes[s], o.head_end[s] = lanes_s, end_s
        o.path, o.item0, o.items = path, item, items
        o.part, o.fin = scratch, scratch + parts
        item += items
        scratch += parts + fin
    desc.n_items = item
    return desc, scratch


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load(KERNEL)
    size = lib.window_total_desc_bytes()
    if size != ctypes.sizeof(_Desc):
        raise RuntimeError(f"window_sum descriptor is {size} bytes in the "
                           f"kernel, {ctypes.sizeof(_Desc)} here")
    fn = lib.window_total_launch
    fn.argtypes = [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    return fn


# Descriptors by operands (each tensor by address, shape, dtype, device
# and contiguity), and the scratch and ticket counter of each (device,
# stream): launches on one stream run in order, so they share one;
# another stream's launches get their own.  A buffer outgrown is kept,
# since a captured CUDA graph may still point at it.
_DESCS: dict = {}
_MAX_DESCS = 256
_SCRATCH: dict = {}


def _tensor_key(t: Optional[torch.Tensor]):
    if t is None:
        return None
    return (t.data_ptr(), tuple(t.shape), t.dtype, t.device,
            t.is_contiguous())


def _key(operands, values, from_zero):
    parts = [from_zero, None if values is None else
             (values.dtype, values.numel(), values.device)]
    for op in operands:
        if isinstance(op, Gather):
            parts.append((_tensor_key(op.table), _tensor_key(op.ids),
                          op.count, op.d, op.head))
        else:
            parts.append((_tensor_key(op.x), op.head, op.lanes, op.rows))
    return tuple(parts)


def _scratch(device: torch.device, index: int, stream: int, floats: int):
    held = _SCRATCH.get((index, stream))
    if held is None or held[0].numel() < floats:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "window_total: call it once on this stream at this size "
                "before capturing it in a CUDA graph (its ticket counter "
                "is zeroed outside the capture)")
        ticket = held[1] if held is not None else torch.zeros(
            (1,), dtype=torch.int32, device=device)
        retired = held[2] + [held[0]] if held is not None else []
        held = (torch.empty((max(floats, 1024) * 2,), dtype=torch.float32,
                            device=device), ticket, retired)
        _SCRATCH[(index, stream)] = held
    return held


def _check_operand(op: Operand, device):
    tensors = [op.table, op.ids] if isinstance(op, Gather) else [op.x]
    for t in tensors:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"window_total operands on {t.device} and "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError("window_total takes contiguous operands")
    if isinstance(op, Gather):
        if op.table.dtype != torch.float32 or op.table.dim() != 2:
            raise TypeError("a Gather table is [rows, row] float32")
        if op.ids is not None and op.ids.dtype != torch.int32:
            raise TypeError("a Gather's ids are int32")
    elif op.x.dtype != torch.float32:
        raise TypeError(f"window_total takes float32, got {op.x.dtype}")


def window_total(operands: Sequence[Operand],
                 values: Optional[torch.Tensor] = None,
                 from_zero: bool = False,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's total of ``operands`` (:class:`Gather` costs at
    ``values``, int32 or int64, and :class:`Plain` arrays), each summed
    in XLA:CPU's order and chained in order with :func:`add`: from the
    first operand's sum, or from +0.0 with ``from_zero``.  Returns a 0-d
    float32 tensor, or writes the total into ``out`` (a one-element
    float32 tensor, e.g. ``costs[n]``) and returns it.  On the CPU the
    plain version runs; on CUDA tensors one launch of the kernel
    computes the whole total (it raises rather than fall back)."""
    first = operands[0] if operands else None
    device = (values.device if values is not None else
              first.x.device if first is not None else
              out.device if out is not None else torch.device("cpu"))
    for op in operands:
        if isinstance(op, Plain) and op.x.dtype != torch.float32:
            raise TypeError(f"window_total takes float32, got {op.x.dtype}")
    if device.type == "cpu":
        total = window_total_plain(operands, values, from_zero)
        if out is None:
            return total
        out.copy_(total)
        return out
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if values is not None:
        if values.dtype not in (torch.int32, torch.int64):
            raise TypeError("window_total takes int32 or int64 values")
        # The kernel reads int32 (the port's assignments): another type
        # costs one conversion.
        if values.dtype != torch.int32 or not values.is_contiguous():
            values = values.to(torch.int32).contiguous()
    key = _key(operands, values, from_zero)
    held = _DESCS.get(key)
    if held is None:
        for op in operands:
            _check_operand(op, device)
            if isinstance(op, Gather) and values is None:
                raise ValueError("a Gather operand needs values")
        held = _describe(operands, values, from_zero)
        if len(_DESCS) >= _MAX_DESCS:
            _DESCS.pop(next(iter(_DESCS)))
        _DESCS[key] = held
    desc, floats = held
    if out is None:
        out = torch.empty((), dtype=torch.float32, device=device)
    elif (out.dtype != torch.float32 or out.numel() != 1
          or out.device != device):
        raise ValueError("out must be one float32 on the operands' card")
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    scratch, ticket, _ = _scratch(device, index, stream, floats)
    fn = _launcher()
    args = (ctypes.addressof(desc),
            0 if values is None else values.data_ptr(),
            scratch.data_ptr(), ticket.data_ptr(), out.data_ptr(), stream)
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"window_sum kernel launch failed: CUDA error {err}")
    _build.launch_counts[COUNTER] += 1
    return out


def window_tree_sum(x: torch.Tensor, head: Stages = (), lanes: int = 1,
                    rows: Rows = NO_ROWS) -> torch.Tensor:
    """Sum of every element of float32 ``x`` (at most three axes) in
    XLA:CPU's order for ``jnp.sum(x)``, as a 0-d float32 tensor on
    ``x``'s device: :func:`window_total` of one :class:`Plain` operand.
    ``head`` is the form of a direct sum of <= 32 gathered values
    (:func:`gather_stages`); ``lanes`` > 1 sums each row of the first
    level's windows (or of a direct sum) in that many lanes over axis 1
    (:func:`residual_lanes`), ``rows`` a box's rows in lanes over axis 0
    (:func:`residual_rows`)."""
    if x.dtype != torch.float32:
        raise TypeError(f"window_tree_sum takes float32, got {x.dtype}")
    if x.device.type == "cpu":
        return window_tree_sum_plain(x, head, lanes, rows)
    return window_total([Plain(x.contiguous(), head, lanes, rows)])
