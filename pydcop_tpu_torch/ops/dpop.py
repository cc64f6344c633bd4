"""DPOP's level-batched UTIL/VALUE sweeps, on a torch device.

Port of ``pydcop_tpu/ops/dpop.py``.  The host planning is copied
verbatim (``MAX_NODE_ELEMENTS``, ``UtilTooLargeError``, ``_NodePlan``,
``_transpose_to_axes``, ``_tree_layout``, ``tree_stats``,
``cec_survivors``, ``compile_tree``, ``var_index``); the UTIL step of a
signature bucket (``_kernel_for``) is torch on the components' device,
and ``solve_sweep`` moves each bucket's stacked components there and
reads the joined tables back once per call.

Reference semantics: pydcop/algorithms/dpop.py:313-439 — every node
joins its assigned constraints with its children's UTIL tables and
projects its own variable out (min/max-eliminate), leaves→root; then
assignments flow root→leaves with first-optimum tie-breaking
(relations.py:1554 find_arg_optimal).  All nodes at the same depth of
the pseudo-tree are independent, so nodes sharing a *signature*

    (joined-shape, (axes of component 0, axes of component 1, ...))

are stacked on a leading batch axis and joined + projected by one UTIL
call: broadcast-add every component into the joined hypercube, then
min/max over the node's own axis.  The VALUE sweep stays on the host.

The UTIL arithmetic is the reference's jitted kernel's, bit for bit
(optimised HLO and its bits, jax 0.9.0, XLA:CPU): XLA drops the
``zeros + `` of the first component, so the joined table is the first
component broadcast (a copy: a lone component keeps its -0.0s and
subnormals) plus each further component in ``sorted(plan.components)``
order, each add reading subnormals as zeros and flushing a subnormal
result; the min (max) orders -0.0 below (above) +0.0 and propagates
NaN.  Eager torch compiles nothing, so there is no signature cache;
the engine's warm-key set still splits first calls from warm ones.

Raggedness guards: a single node whose UTIL table exceeds
``MAX_NODE_ELEMENTS`` raises ``UtilTooLargeError`` (mirrors the
reference's footprint accounting, dpop.py:80-85 / pseudotree
computation_memory); callers fall back to the host-numpy path when the
*total* work is too small to amortize device dispatch (see
algorithms/dpop.py).

Cross-edge consistency (arXiv 1909.06537): before building node plans,
``cec_survivors`` prunes domain values that are *soft-dominated* — value
``a`` of variable ``x`` is removed when some earlier value ``b`` costs
no more than ``a`` under every completion of the rest of the problem,
certified by the bound  u(b) - u(a) + sum over constraints containing x
of max over other coordinates of (c[b,..] - c[a,..]) <= 0  (min mode;
reductions and inequality flip for max).  Because the dominator has a
*smaller* domain index, first-optimum tie-breaking always lands on a
surviving value, so the final assignment is bit-identical with CEC on
or off — pruning only shrinks every hypercube axis the variable touches
and thereby raises the width ceiling under ``MAX_NODE_ELEMENTS``.
"""

import math
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.ops.flush import ftz

# Per-node UTIL element cap: beyond this the separator is so wide that
# the problem needs a different algorithm (or more devices), and one
# table would dominate device memory anyway.
MAX_NODE_ELEMENTS = 2 ** 26


class UtilTooLargeError(MemoryError):
    """A UTIL table exceeds the per-node element cap."""


# -- host-side compilation: tree -> level-bucketed dense components ---- #


class _NodePlan:
    """Static plan for one pseudo-tree node's UTIL computation."""

    __slots__ = (
        "name", "dims", "shape", "components", "parent", "depth",
    )

    def __init__(self, name, dims, shape, parent, depth):
        self.name = name
        self.dims = dims          # (own, sep...) variable names
        self.shape = shape        # domain sizes, same order
        self.parent = parent
        self.depth = depth
        # axes-tuple -> summed dense array (axes ascending in dims).
        self.components: Dict[Tuple[int, ...], np.ndarray] = {}

    def add_component(self, axes: Tuple[int, ...], array: np.ndarray):
        if axes in self.components:
            self.components[axes] = self.components[axes] + array
        else:
            self.components[axes] = array


def _transpose_to_axes(array: np.ndarray, positions: List[int]
                       ) -> Tuple[Tuple[int, ...], np.ndarray]:
    """Reorder ``array`` (one axis per entry of ``positions``, positions
    being indices into the node's dims) into ascending-position order."""
    order = sorted(range(len(positions)), key=lambda i: positions[i])
    axes = tuple(positions[i] for i in order)
    return axes, np.ascontiguousarray(np.transpose(array, order))


def _tree_layout(graph, survivors: Optional[Dict[str, np.ndarray]] = None):
    """Shared host-side layout pass: nodes, depths, separator sets and
    per-node (dims, shape) with survivor-shrunk domain sizes."""
    from pydcop_tpu_torch.computations_graph.pseudotree import node_depths

    nodes = {n.name: n for n in graph.nodes}
    depth = node_depths(graph)

    # Separator sets, bottom-up: sep(n) = (U sep(children) U scopes) - n.
    sep: Dict[str, set] = {}
    for name in sorted(nodes, key=lambda n: -depth[n]):
        node = nodes[name]
        s = set()
        for c in node.constraints:
            s.update(v.name for v in c.dimensions)
        for child in node.children:
            s.update(sep[child])
        s.discard(name)
        sep[name] = s

    def dom_size(name: str) -> int:
        if survivors is not None and name in survivors:
            return int(len(survivors[name]))
        return len(nodes[name].variable.domain)

    layout: Dict[str, Tuple[Tuple[str, ...], Tuple[int, ...]]] = {}
    for name in nodes:
        # Deterministic dim order: own variable first, then separator
        # variables shallowest-first (ties by name) — ancestors of the
        # node by the pseudo-tree property.
        sep_sorted = sorted(sep[name], key=lambda v: (depth[v], v))
        dims = (name,) + tuple(sep_sorted)
        shape = tuple(dom_size(d) for d in dims)
        layout[name] = (dims, shape)
    return nodes, depth, sep, layout


def tree_stats(graph, survivors: Optional[Dict[str, np.ndarray]] = None
               ) -> Dict[str, int]:
    """Width/size accounting for a pseudo-tree *without* materializing
    any table — safe to call on arbitrarily wide problems.

    Returns node count, level count, induced width (largest separator,
    in variables), the largest per-node UTIL element count and the total
    across nodes.  Callers compare ``max_elements`` against
    ``MAX_NODE_ELEMENTS`` to decide whether exact inference is feasible
    (optionally after CEC shrinkage via ``survivors``).
    """
    nodes, depth, sep, layout = _tree_layout(graph, survivors)
    max_elements = 0
    total_elements = 0
    for name, (dims, shape) in layout.items():
        with np.errstate(over="ignore"):
            n = np.prod(shape, dtype=np.float64)
        # Past float64's range, the exact product (the reference raises
        # there: the flagship's separators reach hundreds of variables).
        n = int(n) if np.isfinite(n) else math.prod(shape)
        max_elements = max(max_elements, n)
        total_elements += n
    return {
        "nodes": len(nodes),
        "levels": (max(depth.values()) + 1) if depth else 0,
        "induced_width": max((len(s) for s in sep.values()), default=0),
        "max_elements": max_elements,
        "total_elements": total_elements,
    }


def cec_survivors(graph, mode: str = "min", max_rounds: int = 8
                  ) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """Cross-edge consistency: per-variable surviving domain indices.

    A value ``a`` is pruned when an earlier value ``b`` soft-dominates
    it: ``u(b) - u(a) + sum_c reduce_ctx(c[b] - c[a])`` is ``<= 0`` with
    ``reduce = max`` in min mode (``>= 0`` / ``min`` in max mode), the
    context ranging over current survivors of the other scope variables.
    Iterated to a bounded fixpoint — each round's shrinkage tightens the
    neighbour contexts and can unlock further pruning.

    Returns ``(survivors, meta)`` where ``survivors`` maps variable name
    to a sorted int array of original domain indices and ``meta`` holds
    ``{"rounds", "pruned", "values"}``.
    """
    nodes = {n.name: n for n in graph.nodes}
    variables = {name: node.variable for name, node in nodes.items()}

    # Every constraint is assigned to exactly one pseudo-tree node;
    # bucket the dense form by incident variable.
    from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation

    incident: Dict[str, List[Tuple[Tuple[str, ...], np.ndarray]]] = {
        name: [] for name in nodes
    }
    for node in nodes.values():
        for c in node.constraints:
            dense = NAryMatrixRelation.from_func_relation(c)
            dims = tuple(v.name for v in dense.dimensions)
            mat = np.asarray(dense.matrix, dtype=np.float64)
            for d in dims:
                incident[d].append((dims, mat))

    unary = {
        name: np.asarray(var.cost_vector(), dtype=np.float64)
        for name, var in variables.items()
    }
    survivors: Dict[str, np.ndarray] = {
        name: np.arange(len(var.domain), dtype=np.int64)
        for name, var in variables.items()
    }

    total_values = sum(len(v.domain) for v in variables.values())
    rounds = 0
    changed = True
    while changed and rounds < max_rounds:
        changed = False
        rounds += 1
        for name in sorted(nodes):
            keep_idx = survivors[name]
            k = len(keep_idx)
            if k <= 1:
                continue
            u = unary[name][keep_idx]
            # D[b, a]: certified worst-case cost(b) - cost(a) bound.
            D = u[:, None] - u[None, :]
            for dims, mat in incident[name]:
                sub = mat
                for ax, d in enumerate(dims):
                    sub = np.take(sub, survivors[d], axis=ax)
                ax_x = dims.index(name)
                sub = np.moveaxis(sub, ax_x, 0).reshape(k, -1)
                diff = sub[:, None, :] - sub[None, :, :]
                D = D + (
                    diff.max(axis=2) if mode == "min"
                    else diff.min(axis=2)
                )
            keep = np.ones(k, dtype=bool)
            for a in range(1, k):
                col = D[:a, a]
                dominated = (
                    bool((col <= 0.0).any()) if mode == "min"
                    else bool((col >= 0.0).any())
                )
                if dominated:
                    keep[a] = False
            if not keep.all():
                survivors[name] = keep_idx[keep]
                changed = True
    kept_values = sum(len(s) for s in survivors.values())
    meta = {
        "rounds": rounds,
        "pruned": total_values - kept_values,
        "values": total_values,
    }
    return survivors, meta


def compile_tree(graph, mode: str,
                 survivors: Optional[Dict[str, np.ndarray]] = None
                 ) -> Dict[str, _NodePlan]:
    """Build per-node static plans: dims, shapes, local components.

    ``graph`` is a ComputationPseudoTree; child-UTIL components are
    added level by level during the sweep (their arrays are produced by
    the previous level's kernels).  When ``survivors`` is given (from
    ``cec_survivors``) every table axis is sliced to the surviving
    domain indices before planning, so the element cap is checked
    against the *shrunk* hypercubes.
    """
    from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation

    nodes, depth, sep, layout = _tree_layout(graph, survivors)

    plans: Dict[str, _NodePlan] = {}
    for name, node in nodes.items():
        var = node.variable
        dims, shape = layout[name]
        n_elements = int(np.prod(shape, dtype=np.int64))
        if n_elements > MAX_NODE_ELEMENTS:
            raise UtilTooLargeError(
                f"UTIL table for {name} has {n_elements} elements "
                f"(> {MAX_NODE_ELEMENTS}); separator too wide"
            )
        plan = _NodePlan(name, dims, shape, node.parent, depth[name])
        pos = {d: i for i, d in enumerate(dims)}
        u = np.asarray(var.cost_vector(), dtype=np.float32)
        if survivors is not None:
            u = u[survivors[name]]
        plan.add_component((0,), u)
        for c in node.constraints:
            dense = NAryMatrixRelation.from_func_relation(c)
            mat = np.asarray(dense.matrix, dtype=np.float32)
            if survivors is not None:
                for ax, v in enumerate(dense.dimensions):
                    mat = np.take(mat, survivors[v.name], axis=ax)
            positions = [pos[v.name] for v in dense.dimensions]
            axes, arr = _transpose_to_axes(mat, positions)
            plan.add_component(axes, arr)
        plans[name] = plan
    return plans


# -- the UTIL step of one signature bucket ------------------------------ #


def _kernel_for(signature: Tuple) -> Callable:
    """signature = (shape, axes_tuples, mode, want_util).  Returns
    ``kernel(*comps) -> (acc, util)`` over torch tensors on one device
    (comps[i]: [n, ...] over ``axes_tuples[i]``; acc: [n, *shape]
    float32; util: acc's min or max over axis 1, or None)."""
    shape, axes_tuples, mode, want_util = signature
    k = len(shape)

    def kernel(*comps):
        n = comps[0].shape[0]
        acc = None
        for comp, axes in zip(comps, axes_tuples):
            newshape = (n,) + tuple(
                shape[i] if i in axes else 1 for i in range(k)
            )
            term = comp.reshape(newshape)
            if acc is None:
                acc = term.expand((n,) + shape).clone()
            else:
                acc = ftz(ftz(acc) + ftz(term))
        if not want_util:
            return acc, None
        return acc, _project(acc, mode)

    return kernel


def _project(acc: torch.Tensor, mode: str) -> torch.Tensor:
    """``acc``'s min (max) over axis 1 as XLA's reduce gives it:
    subnormals read as zeros of their sign, -0.0 below (above) +0.0,
    and a NaN of the row (its first) where one is present — torch's
    ``amin``/``amax`` keep the first of equal zeros and return a
    canonical NaN."""
    acc = ftz(acc)
    zero = acc == 0
    if mode == "min":
        util = torch.amin(acc, dim=1)
        signed = torch.any(zero & torch.signbit(acc), dim=1)
    else:
        util = torch.amax(acc, dim=1)
        signed = ~torch.any(zero & ~torch.signbit(acc), dim=1)
    util = torch.where(util == 0, torch.where(signed, -0.0, 0.0).to(
        acc.dtype), util)
    nan = torch.isnan(acc)
    first_nan = torch.gather(
        acc, 1, torch.argmax(nan.to(torch.uint8), dim=1, keepdim=True))
    return torch.where(torch.isnan(util), first_nan.squeeze(1), util)


def solve_sweep(graph, mode: str = "min", cec: bool = False,
                call: Optional[Any] = None,
                precomputed_survivors: Optional[Tuple] = None,
                device: torch.device = torch.device("cpu")
                ) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """Run the full DPOP solve with level-batched UTIL calls on
    ``device``.

    ``cec`` enables cross-edge consistency preprocessing (assignment is
    bit-identical either way; tables shrink).  ``call`` is an optional
    invocation hook ``call(signature, fn) -> fn()``, ``fn`` a thunk that
    copies the bucket's stacked components (``fn.stacked``, host arrays)
    to ``device`` and runs its UTIL step (``fn.kernel``) — the engine
    passes a ``timed_engine_call`` wrapper here
    so compile/run accounting, tracing and efficiency ledgers see every
    dispatch.
    ``precomputed_survivors`` short-circuits the (host-heavy) dominance
    pass with a cached ``cec_survivors`` result for repeat solves of a
    static problem.

    Returns (assignment, stats).
    """
    survivors = None
    cec_meta = {"rounds": 0, "pruned": 0, "values": 0}
    if cec:
        if precomputed_survivors is not None:
            survivors, cec_meta = precomputed_survivors
        else:
            survivors, cec_meta = cec_survivors(graph, mode)
    plans = compile_tree(graph, mode, survivors=survivors)
    nodes = {n.name: n for n in graph.nodes}
    by_level: Dict[int, List[str]] = defaultdict(list)
    for name, plan in plans.items():
        by_level[plan.depth].append(name)
    max_depth = max(by_level) if by_level else 0

    joined: Dict[str, np.ndarray] = {}
    n_kernel_calls = 0
    msg_count = 0
    msg_size = 0

    # UTIL sweep, deepest level first; each level is one batched kernel
    # call per signature bucket.
    for level in range(max_depth, -1, -1):
        buckets: Dict[Tuple, List[str]] = defaultdict(list)
        for name in by_level[level]:
            plan = plans[name]
            axes_tuples = tuple(sorted(plan.components))
            want_util = plan.parent is not None
            key = (plan.shape, axes_tuples, mode, want_util)
            buckets[key].append(name)
        for key, names in sorted(buckets.items()):
            shape, axes_tuples, _, want_util = key
            stacked = [
                np.stack(
                    [plans[n].components[axes] for n in names]
                )
                for axes in axes_tuples
            ]
            kernel = _kernel_for(key)

            def fn(kernel=kernel, stacked=stacked):
                return kernel(*(torch.from_numpy(a).to(device)
                                for a in stacked))

            # For a hook that times the UTIL step apart from its copies.
            fn.kernel, fn.stacked = kernel, stacked
            acc, util = fn() if call is None else call(key, fn)
            n_kernel_calls += 1
            acc_np = acc.cpu().numpy()
            util_np = None if util is None else util.cpu().numpy()
            for i, name in enumerate(names):
                plan = plans[name]
                joined[name] = acc_np[i]
                if want_util:
                    parent_plan = plans[plan.parent]
                    ppos = {
                        d: j for j, d in enumerate(parent_plan.dims)
                    }
                    positions = [ppos[d] for d in plan.dims[1:]]
                    axes, arr = _transpose_to_axes(
                        util_np[i], positions
                    )
                    parent_plan.add_component(axes, arr)
                    msg_count += 1
                    msg_size += arr.size

    # VALUE sweep, root level down: slice on ancestors' values, pick
    # the first optimum (reference find_arg_optimal order).  With CEC
    # active, table axes index *surviving* values, so ancestor values
    # map through the survivor list and the chosen row maps back to the
    # original domain.
    assignment: Dict[str, Any] = {}
    chosen_pos: Dict[str, int] = {}
    argopt = np.argmin if mode == "min" else np.argmax
    for level in range(0, max_depth + 1):
        for name in sorted(by_level[level]):
            plan = plans[name]
            var = nodes[name].variable
            idx = tuple(chosen_pos[d] for d in plan.dims[1:])
            vec = joined[name][(slice(None),) + idx]
            pos = int(argopt(vec))
            orig = pos if survivors is None else int(survivors[name][pos])
            chosen_pos[name] = pos
            assignment[name] = var.domain[orig]
            msg_count += len(nodes[name].children)
    stats = {
        "msg_count": msg_count,
        "msg_size": msg_size,
        "kernel_calls": n_kernel_calls,
        "levels": max_depth + 1,
        "cec_rounds": cec_meta["rounds"],
        "cec_pruned": cec_meta["pruned"],
    }
    return assignment, stats


def var_index(variable, value) -> int:
    return variable.domain.index(value)
