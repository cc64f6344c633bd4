"""Carry a compiled graph and a solver state between numpy and torch.

This system has no weights: its "parameters" are the compiled factor
graph and the solver state.  These functions take and give plain numpy
arrays — for example ``np.asarray`` of the JAX reference's
``CompiledFactorGraph`` and ``MaxSumState`` — so both packages can
compute on the same graph from the same messages.  The local-search
states (DSA, MGM, MGM2, DBA, GDBA, MixedDSA) carry their values (and
DBA's weights and counters, GDBA's modifiers) as tensors and their key
on the host; DBA's cycle is a tensor on the device (its stop is decided
there), the others' a host int.  They import nothing of the JAX
package.
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
from pydcop_tpu_torch.ops.dba import DbaState
from pydcop_tpu_torch.ops.dsa import DsaState
from pydcop_tpu_torch.ops.gdba import GdbaState
from pydcop_tpu_torch.ops.maxsum import MaxSumState
from pydcop_tpu_torch.ops.mgm import MgmState
from pydcop_tpu_torch.ops.mgm2 import Mgm2State
from pydcop_tpu_torch.ops.mixeddsa import MixedDsaState

LOCALSEARCH_STATES = {"dsa": DsaState, "mgm": MgmState, "mgm2": Mgm2State,
                      "dba": DbaState, "gdba": GdbaState,
                      "mixeddsa": MixedDsaState}


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


def localsearch_state_from_numpy(kind: str, values, key, cycle,
                                 device: DeviceLike = "cuda",
                                 weights: Sequence = (),
                                 term_counter=None,
                                 modifiers: Sequence = ()):
    """The port's local-search state of ``kind`` (a key of
    ``LOCALSEARCH_STATES``) from the reference's fields as numpy:
    ``values`` [V+1] int, ``key`` the two uint32 key words, ``cycle`` a
    scalar int; for ``"dba"`` also ``weights`` (per bucket [F, arity]
    float32) and ``term_counter`` [V+1] float32, for ``"gdba"``
    ``modifiers`` (per bucket [F, arity, D, ..., D] float32)."""
    dev = resolve_device(device)
    words = np.asarray(key).astype(np.int64).reshape(2)
    fields = dict(
        values=torch.tensor(np.asarray(values), dtype=torch.int32,
                            device=dev),
        key=(int(words[0]), int(words[1])),
        cycle=int(np.asarray(cycle)))

    def put(arrays):
        return tuple(torch.tensor(np.asarray(a), dtype=torch.float32,
                                  device=dev) for a in arrays)

    if kind == "dba":
        fields.update(
            weights=put(weights), term_counter=put([term_counter])[0],
            cycle=torch.tensor(fields["cycle"], dtype=torch.int32,
                               device=dev))
    elif kind == "gdba":
        fields["modifiers"] = put(modifiers)
    return LOCALSEARCH_STATES[kind](**fields)


def localsearch_state_to_numpy(state) -> Dict[str, object]:
    """A local-search state as numpy: ``values`` [V+1] int32, ``key``
    [2] uint32, ``cycle`` int — the reference's fields — and DBA's
    ``weights`` and ``term_counter``, GDBA's ``modifiers``."""
    out = {
        "values": state.values.detach().cpu().numpy(),
        "key": np.asarray(state.key, dtype=np.uint32),
        "cycle": int(state.cycle),
    }
    for name in ("weights", "modifiers"):
        if hasattr(state, name):
            out[name] = tuple(t.detach().cpu().numpy()
                              for t in getattr(state, name))
    if hasattr(state, "term_counter"):
        out["term_counter"] = state.term_counter.detach().cpu().numpy()
    return out
