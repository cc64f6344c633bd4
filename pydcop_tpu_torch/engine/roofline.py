"""Achieved-FLOPs / memory-traffic accounting for the device engine.

Port of ``pydcop_tpu/engine/roofline.py``.  Given a compiled graph it
counts, from the bucket shapes alone, the arithmetic and memory
traffic one MaxSum superstep performs (``ops/maxsum.py superstep``),
so a run can report achieved FLOP/s, an MFU against the card's dense
peak and — the meaningful roofline for this op mix — the HBM bandwidth
utilization.  The FLOP and byte models are the reference's, unchanged,
so on the same compiled graph the counts are the reference's integers
(``tests/test_torch_roofline.py``); they take the port's numpy
``CompiledFactorGraph`` or its placed ``TorchFactorGraph``.

The counts are *models*: they assume each logical array is read and
written once per use and count one FLOP per add/multiply/compare.
MaxSum's op mix is min-plus gathers and scatters on tiny minor
dimensions and uses no tensor core, so the MFU is honestly tiny.

``hbm_util`` is claimed only when the working set does not fit in the
card's L2 cache (50 MiB on the H100): below half of it (room for the
transients of a superstep), the state stays in L2 across supersteps,
the byte model is a ceiling rather than traffic, and ``hbm_util`` is
None with ``l2_resident: True`` (the reference's VMEM rule).  The
10k-variable flagship fits; the 1M-variable scale graph does not.

Peaks are keyed on ``torch.cuda.get_device_name()``; an unknown card
and the CPU get ``None`` peaks, and the report then gives achieved
numbers without a utilization claim.
"""

from typing import Dict, Optional, Tuple

# device name -> (peak dense bf16 tensor-core FLOP/s, HBM bytes/s):
# NVIDIA's H100 SXM datasheet specifications (989.4 TFLOP/s dense
# bf16, 3.35 TB/s HBM3), not measurements.
H100_SXM_PEAK_FLOPS_BF16 = 989.4e12
H100_SXM_HBM_BYTES_PER_S = 3.35e12
CUDA_PEAKS: Dict[str, Tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (H100_SXM_PEAK_FLOPS_BF16,
                              H100_SXM_HBM_BYTES_PER_S),
}

# L2 cache of the H100 (50 MiB, datasheet).  A working set below half
# of it stays resident across supersteps.
H100_L2_BYTES = 50 << 20


def _numel(x) -> int:
    """Element count of a numpy array or a torch tensor."""
    numel = getattr(x, "numel", None)
    return int(numel() if callable(numel) else x.size)


def _itemsize(x) -> int:
    return int(x.dtype.itemsize)


def maxsum_superstep_flops(graph) -> int:
    """Arithmetic ops in one superstep (adds + mins + compares).

    Derivation per bucket of F factors, arity a, padded domain D:

    - factor->var: broadcast-add a messages into the [F, D^a] table
      (a·F·D^a), then per position a min-reduction over the table
      (a·F·D^a) and a subtract (a·F·D).
    - damping on both sides: damped = d·old + (1-d)·new -> 3 ops per
      element over two [F, a, D] arrays.
    - belief segment-sum: one add per message element (F·a·D) plus the
      var-cost add over [V, D].
    - var->factor: two subtracts, masked mean (sum + divide ≈ 2), and
      the normalization subtract -> ≈5 ops per [F, a, D] element.
    - convergence test: |Δ|, |Σ|, two compares on both message arrays
      -> ≈8 ops per element, twice.
    """
    v_plus_1, d = graph.var_costs.shape
    total = v_plus_1 * d  # belief var-cost add
    for b in graph.buckets:
        f, a = b.var_ids.shape
        table = _numel(b.costs)  # F * D^a
        total += 2 * a * table          # broadcast adds + min reductions
        per_msg = f * a * d
        total += per_msg * (1 + 6 + 1 + 5 + 16)  # sub, damp, seg, v2f, conv
    return int(total)


def maxsum_superstep_bytes(graph) -> int:
    """Memory traffic (bytes) one fused superstep must move at minimum:
    read every factor cost table once, read old + write new messages on
    both sides (4 × [F, a, D]), read/write the [V, D] belief/sum
    tables a handful of times.

    With the ell aggregation the variable-side sum reads messages
    through the padded [V+1, K] edge lists instead of one scatter
    pass: V·K message rows (padding included) plus the index array
    itself, replacing one of the six message passes.  Indices count
    4 bytes each, as in the reference's int32 layout."""
    itemsize = _itemsize(graph.var_costs)
    d = graph.var_costs.shape[1]
    total = 4 * _numel(graph.var_costs) * itemsize
    msg_passes = 6
    ell = getattr(graph, "agg_ell", None)
    if ell is not None:
        total += _numel(ell) * 4                  # edge-list reads
        total += _numel(ell) * d * itemsize       # padded gather
        msg_passes = 5                            # replaces one pass
    for b in graph.buckets:
        f, a = b.var_ids.shape
        total += _numel(b.costs) * itemsize       # cost tables (read)
        total += msg_passes * f * a * d * itemsize  # v2f/f2v old+new
        total += _numel(b.var_ids) * 4            # gather indices
    return int(total)


def working_set_bytes(graph) -> int:
    """Persistent solve state: graph tensors + both message arrays and
    their suppression counters (``ops/maxsum.MaxSumState``)."""
    itemsize = _itemsize(graph.var_costs)
    total = _numel(graph.var_costs) * itemsize
    total += _numel(graph.var_valid)  # bool
    ell = getattr(graph, "agg_ell", None)
    if ell is not None:
        total += _numel(ell) * 4
    d = graph.var_costs.shape[1]
    for b in graph.buckets:
        f, a = b.var_ids.shape
        total += _numel(b.costs) * _itemsize(b.costs)
        total += _numel(b.var_ids) * 4
        # v2f + f2v messages carry the var_costs dtype (init_state)
        total += 2 * f * a * d * itemsize
        total += 2 * f * a * 1       # send-suppression counters (int8)
    return int(total)


def device_peaks(platform: str, device_kind: Optional[str] = None
                 ) -> Tuple[Optional[float], Optional[float]]:
    """(peak FLOP/s, HBM bytes/s) of the named card, (None, None) for
    an unknown card or the CPU.  On ``cuda`` with no ``device_kind``
    the current card's name is read."""
    if platform != "cuda":
        return None, None
    if device_kind is None:
        import torch

        if not torch.cuda.is_available():
            return None, None
        device_kind = torch.cuda.get_device_name()
    return CUDA_PEAKS.get(device_kind, (None, None))


def roofline_report(graph, cycles_per_s: float, platform: str,
                    device_kind: Optional[str] = None,
                    ) -> Dict[str, Optional[float]]:
    """Achieved FLOP/s + utilizations for a measured superstep rate.

    ``platform`` is the tensors' device type (``"cuda"`` or
    ``"cpu"``); ``device_kind`` the card's name (default: the current
    card's).  The counts are always the model's (``cost_source:
    "model"``): the reference's ``measured=`` takes XLA's counts, and
    the port's profiler measures kernel times, not counts.

    Utilization claims (``mfu``/``hbm_util``) need a card in
    :data:`CUDA_PEAKS`.  On ``cuda`` the L2 rule decides residency; a
    working set below half the L2 gets ``l2_resident: True`` and no
    ``hbm_util``.  ``hbm_util_exceeds_peak`` flags a rate that, with
    the modelled traffic, would exceed the HBM peak: the rate is then
    wrong (an unsynchronised clock), not the card fast."""
    flops = maxsum_superstep_flops(graph)
    bytes_moved = maxsum_superstep_bytes(graph)
    ws = working_set_bytes(graph)
    achieved_flops = flops * cycles_per_s
    achieved_bw = bytes_moved * cycles_per_s
    l2_resident: Optional[bool] = None
    peak_flops, peak_bw = device_peaks(platform, device_kind)
    if platform == "cuda":
        l2_resident = ws < H100_L2_BYTES // 2
    return {
        "cost_source": "model",
        "flops_per_cycle": float(flops),
        "bytes_per_cycle": float(bytes_moved),
        "working_set_bytes": float(ws),
        "l2_resident": l2_resident,
        "achieved_gflops": round(achieved_flops / 1e9, 3),
        "achieved_gbps": (
            None if l2_resident else round(achieved_bw / 1e9, 3)
        ),
        # Not rounded: on small graphs these are ~1e-9.
        "mfu": (
            achieved_flops / peak_flops if peak_flops else None
        ),
        "hbm_util": (
            achieved_bw / peak_bw
            if peak_bw and l2_resident is False else None
        ),
        "hbm_util_exceeds_peak": (
            achieved_bw > peak_bw
            if peak_bw and l2_resident is False else None
        ),
        "peaks_source": ("datasheet" if peak_flops else None),
    }
