"""Carry a compiled graph and a MaxSum state between numpy and torch.

This system has no weights: its "parameters" are the compiled factor
graph and the solver state.  These functions take and give plain numpy
arrays — for example ``np.asarray`` of the JAX reference's
``CompiledFactorGraph`` and ``MaxSumState`` — so both packages can
compute on the same graph from the same messages.  They import nothing
of the JAX package.
"""

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.device import (
    DeviceLike,
    TorchFactorGraph,
    resolve_device,
    to_device_graph,
)
from pydcop_tpu_torch.engine.compile import (
    CompiledFactorGraph,
    FactorBucket,
    build_aggregation_arrays,
)
from pydcop_tpu_torch.ops.maxsum import MaxSumState


def graph_from_numpy(var_costs, var_valid,
                     buckets: Iterable[Tuple[np.ndarray, np.ndarray]],
                     device: DeviceLike = "cuda",
                     aggregation: str = "scatter") -> TorchFactorGraph:
    """``buckets`` is a sequence of ``(costs, var_ids)`` pairs in
    bucket order.  ``aggregation`` builds that strategy's arrays as
    ``compile_dcop(aggregation=...)`` does (the reference's
    ``build_aggregation_arrays``)."""
    var_costs = np.asarray(var_costs)
    fb = tuple(FactorBucket(np.asarray(c), np.asarray(ids))
               for c, ids in buckets)
    perm, sorted_seg, starts, ends, ell = build_aggregation_arrays(
        fb, var_costs.shape[0], aggregation, d=var_costs.shape[1])
    graph = CompiledFactorGraph(
        var_costs=var_costs,
        var_valid=np.asarray(var_valid),
        buckets=fb,
        agg_perm=perm, agg_sorted_seg=sorted_seg, agg_starts=starts,
        agg_ends=ends, agg_ell=ell,
    )
    return to_device_graph(graph, device)


def state_from_numpy(v2f: Sequence, f2v: Sequence, v2f_count: Sequence,
                     f2v_count: Sequence, stable, cycle,
                     device: DeviceLike = "cuda") -> MaxSumState:
    """The port's ``MaxSumState`` from per-bucket numpy arrays (float32
    messages, int8 counts, scalar bool ``stable`` and int ``cycle``)."""
    dev = resolve_device(device)

    def put(arrays, dtype):
        return tuple(torch.tensor(np.asarray(a), dtype=dtype, device=dev)
                     for a in arrays)

    return MaxSumState(
        v2f=put(v2f, torch.float32),
        f2v=put(f2v, torch.float32),
        v2f_count=put(v2f_count, torch.int8),
        f2v_count=put(f2v_count, torch.int8),
        stable=torch.tensor(bool(np.asarray(stable)), device=dev),
        cycle=torch.tensor(int(np.asarray(cycle)), dtype=torch.int32,
                           device=dev),
    )


def state_to_numpy(state: MaxSumState) -> Dict[str, object]:
    """The reverse of :func:`state_from_numpy`: a dict with the same
    keyword names, each field as numpy (tuples of arrays per bucket)."""
    def get(tensors):
        return tuple(t.detach().cpu().numpy() for t in tensors)

    return {
        "v2f": get(state.v2f),
        "f2v": get(state.f2v),
        "v2f_count": get(state.v2f_count),
        "f2v_count": get(state.f2v_count),
        "stable": bool(state.stable),
        "cycle": int(state.cycle),
    }
