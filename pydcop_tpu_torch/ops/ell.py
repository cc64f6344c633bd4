"""The ELL (padded edge-list) gather-reduce of the belief aggregation.

Port of ``pydcop_tpu/ops/ell.py``.  A graph compiled with
``aggregation='ell'`` carries ``agg_ell``, each variable's edge indices
padded to the largest degree K with dummy slots that hold E (one past
the last edge).  The gather clips the index and the mask replaces a
dummy slot's value with the reduction's identity.

The K-way sum adds in the order the reference's jitted ``gather_reduce``
adds in on the CPU (XLA, jax 0.9.0), found by probing its reduction tree
and pinned by ``tests/test_torch_ell.py``: left to right up to K = 18
(19 for [E] values and at D = 1); for larger K up to 32, LLVM's
vectorised forms of the fully unrolled chain (lanes of 8 or 4 strided slots, each lane from
zero, lanes folded by halves, then the rest added one by one); above
32, XLA's tree rewrite:
K padded with zeros to a multiple of 32 (half the padding in front),
each window of 32 summed left to right, the window sums left to right.
With several buckets the reference reads a concatenation of the
buckets' messages, which XLA fuses into the reduce, and at K = 16..18
LLVM then vectorises the sum as lanes of 8 over the first 16 slots
and the rest one by one (:func:`multi_bucket_form`, probed on a grid of
1-3 buckets, D in {1, 2, 3, 4, 8}, K = 16..24); shapes outside what
was probed, or where no form matched, are refused when the lists are
built (ROADMAP Queue C).
Every add is a separate elementwise torch add, flushed to zero like the
reference's (``ops/flush.py``), so the order is fixed by construction
and the card gives the CPU's bits.  This is plain torch on
both devices, not a hand kernel.
"""

from typing import List, Optional

import torch

from pydcop_tpu_torch.ops.flush import ftz

# XLA's tree-reduction rewrite splits a reduced axis longer than this.
WINDOW = 32


def _left_to_right(x: torch.Tensor, dim: int, slots,
                   acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc`` (or zero) plus each of ``slots`` along ``dim``, one add
    at a time; the axis is kept with length 1."""
    for k in slots:
        term = x.narrow(dim, k, 1)
        acc = ftz(term + 0.0 if acc is None else acc + term)
    return acc


def window_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in XLA's tree-reduction form for an axis longer
    than :data:`WINDOW`: the axis padded with zeros to a multiple of 32
    (half the padding, rounded down, in front), each window summed left
    to right from zero, the window sums added left to right.  The axis
    is kept with length 1."""
    k = x.shape[dim]
    acc = None
    for lo in range(-(((-k) % WINDOW) // 2), k, WINDOW):
        window = _left_to_right(x, dim, range(max(lo, 0),
                                               min(lo + WINDOW, k)))
        acc = window if acc is None else ftz(acc + window)
    return acc


def _lanes(x: torch.Tensor, lo: int, hi: int, width: int,
           first: torch.Tensor) -> List[torch.Tensor]:
    """``width`` lane sums of slots lo..hi-1 along axis 1, lane j taking
    slots lo + j, lo + j + width, ...; lane 0 starts from ``first``,
    the others from zero."""
    return [_left_to_right(x, 1, range(lo + j, hi, width),
                           first if j == 0 else None)
            for j in range(width)]


def _fold(lanes: List[torch.Tensor]) -> torch.Tensor:
    """Fold lanes by halves: lane i += lane i + n/2, until one is left."""
    while len(lanes) > 1:
        half = len(lanes) // 2
        lanes = [ftz(lanes[i] + lanes[i + half]) for i in range(half)]
    return lanes[0]


# Domains at which the multi-bucket forms were probed against the
# reference (jax 0.9.0, CPU), and the K range where they differ from the
# one-bucket form.
PROBED_DOMAINS = (1, 2, 3, 4, 8)
MULTI_BUCKET_KS = range(16, 24)


def multi_bucket_form(n_buckets: int, d: int, k: int) -> str:
    """The form of the reference's ELL sum over K slots with
    ``n_buckets`` buckets at domain size ``d``: ``"lanes"`` (lanes of 8
    over the first 16 slots, then one by one) or ``"one_bucket"``
    (:func:`ordered_sum`'s).  Two buckets take the lanes at K = 17..19
    (18..19 at D = 1), three at K = 16..19 (at K = 19 above D = 1 that
    is the one-bucket form too).  Raises ValueError
    naming ROADMAP Queue C where the form is unknown: more than three
    buckets or a D outside :data:`PROBED_DOMAINS` at K = 16..23, and
    three buckets at D = 3, K = 20..23 (no probed form matched there at
    K = 20, and K = 22 matched only the lanes)."""
    if n_buckets < 2 or k not in MULTI_BUCKET_KS:
        return "one_bucket"
    if (n_buckets > 3 or d not in PROBED_DOMAINS
            or (n_buckets == 3 and d == 3 and k >= 20)):
        raise ValueError(
            f"aggregation='ell' with {n_buckets} buckets at D={d} and max "
            f"degree K={k}: the reference's sum order at this shape is "
            "unknown (ROADMAP Queue C: ELL above one bucket at max degree "
            "16..23) — use aggregation='scatter' or 'sorted'")
    if n_buckets == 2:
        lanes = (18, 19) if d == 1 else (17, 18, 19)
    else:
        lanes = (16, 17, 18, 19)
    return "lanes" if k in lanes else "one_bucket"


def ordered_sum(x: torch.Tensor, n_buckets: int = 1) -> torch.Tensor:
    """Sum over axis 1 of ``x`` ([N, K] or [N, K, D]) in the order of the
    reference's jitted gather_reduce over ``n_buckets`` buckets' messages
    (module docstring)."""
    k = x.shape[1]
    if k > WINDOW:
        return window_sum(x, 1).squeeze(1)
    zero = torch.zeros_like(x.narrow(1, 0, 1))
    d = x.shape[2] if x.dim() == 3 else 1
    if multi_bucket_form(n_buckets, d, k) == "lanes":
        acc = _left_to_right(x, 1, range(16, k),
                             _fold(_lanes(x, 0, 16, 8, zero)))
    elif k <= 18 or (k == 19 and d == 1):
        acc = _left_to_right(x, 1, range(k), zero)
    elif k == 19:
        acc = _left_to_right(x, 1, range(16, 19),
                             _fold(_lanes(x, 0, 16, 8, zero)))
    elif k <= 23:
        acc = _fold(_lanes(x, 0, 16, 4, zero))
        acc = _left_to_right(x, 1, range(20, k),
                             _fold(_lanes(x, 16, 20, 2, acc)))
    else:
        head = 32 if k == 32 else 24
        acc = _left_to_right(x, 1, range(head, k),
                             _fold(_lanes(x, 0, head, 8, zero)))
    return acc.squeeze(1)


def gather_reduce(ell: torch.Tensor, edge_vals: torch.Tensor,
                  n_buckets: int = 1) -> torch.Tensor:
    """Sum per-edge values into per-variable values through the ELL
    lists, in the reference's order (:func:`ordered_sum`).
    ``edge_vals`` is [E] or [E, D] in the flattened (bucket, factor,
    position) edge order the lists index, from ``n_buckets`` buckets;
    returns [V+1] or [V+1, D].
    Dummy slots add zero.  (The reference's ``fill``/``reduce_fn``
    arguments serve the local-search reductions, not ported yet.)"""
    n_edges = edge_vals.shape[0]
    safe = torch.clamp(ell, max=max(n_edges - 1, 0)).to(torch.int64)
    mask = ell < n_edges
    if edge_vals.dim() == 2:
        mask = mask[..., None]
    return ordered_sum(torch.where(mask, edge_vals[safe], 0.0), n_buckets)
