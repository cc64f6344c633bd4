"""Dynamic-DCOP execution on the device engine.

Port of ``pydcop_tpu/engine/dynamic.py``.  The graph lives in a few
dense arrays, so a dynamic problem becomes array surgery:

- **Padding slack.** Buckets are compiled with spare factor rows
  (``slack`` fraction, zero cost, sentinel var ids).  Adding a factor
  writes one row; removing one resets it.  Shapes stay the same.
- **Warm start.** The message state survives every event; after an
  edit the run continues from the previous fixpoint
  (``ops/maxsum.py::run_maxsum_from``).
- **Recompile fallback.** An edit that outgrows the slack (or adds a
  variable) recompiles with fresh slack; the messages of surviving
  factors are copied row by row into the new buckets.
- **Placement bookkeeping.** A computation -> agent map; ``remove_agent``
  re-homes the departed agent's computations onto the least-loaded
  survivors.  The device math never moves.

The reference keeps numpy copies and hands the whole graph to its
jitted run on every call.  Here the engine keeps a host copy (the
reference's, row for row) and the placed :class:`TorchFactorGraph` on
the device, and an edit writes the patched rows into the placed
tensors in place (``device.place_bucket_rows``/``place_var_rows``),
zeroes the message rows of a removed or reused factor in place, and,
when a scope changed, rebuilds the fields that follow the var ids
(``device.replace_scope``: the belief sum's CSR and plan, the
positional order), once per :meth:`DynamicMaxSumEngine.batch_edits`
flush.  The placed graph then equals ``to_device_graph`` of the host
copy, field by field.  A recompile places the rebuilt graph anew.
"""

import contextlib
import logging
import math
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.dcop.objects import Variable, _stable_noise
from pydcop_tpu_torch.dcop.relations import Constraint
from pydcop_tpu_torch.device import (
    DeviceLike,
    place_bucket_rows,
    place_var_rows,
    replace_scope,
    resolve_device,
    to_device_graph,
)
from pydcop_tpu_torch.engine.compile import (
    BIG,
    CompiledFactorGraph,
    FactorBucket,
)
from pydcop_tpu_torch.engine.runner import DeviceRunResult, _host
from pydcop_tpu_torch.engine.timing import timed_engine_call
from pydcop_tpu_torch.observability import efficiency
from pydcop_tpu_torch.observability.profiler import key_str, profiler
from pydcop_tpu_torch.ops import maxsum as ops

logger = logging.getLogger("pydcop_tpu_torch.engine.dynamic")


class DynamicMaxSumEngine:
    """MaxSum engine whose factor graph can be edited between runs, on
    ``device`` (default ``"cuda"``; without a card it raises unless
    ``device="cpu"``).

    Always uses the scatter aggregation.  ``donate`` (default True):
    an edit zeroes the live state's message rows in place; with False
    it writes into copies of the touched tensors (the same values).
    ``edit_stats`` accumulates the host seconds of the row patches and
    of the scope rebuilds, and their counts."""

    def __init__(self, variables: List[Variable],
                 constraints: List[Constraint], mode: str = "min",
                 noise_level: float = 0.01,
                 noise_seed: Optional[int] = None,
                 slack: float = 0.25,
                 damping: float = 0.5, damping_nodes: str = "both",
                 stability: float = 0.1, donate: bool = True,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.mode = mode
        self.donate = donate
        self.sign = 1.0 if mode == "min" else -1.0
        self.noise_level = noise_level
        self.noise_seed = noise_seed
        self.slack = slack
        self.damping = damping
        self.damp_vars = damping_nodes in ("vars", "both")
        self.damp_factors = damping_nodes in ("factors", "both")
        self.stability = stability

        self.variables: List[Variable] = list(variables)
        self.var_index = {v.name: i for i, v in enumerate(self.variables)}
        # constraint name -> (bucket index, row) for live factors.
        self.slots: Dict[str, Tuple[int, int]] = {}
        self.factors: Dict[str, Constraint] = {}
        self.recompile_count = 0
        # Decimation clamps: variable name -> frozen domain index (its
        # unary row BIG everywhere else).
        self.clamps: Dict[str, int] = {}
        # computation name -> agent, and the live agents.
        self.placement: Dict[str, Optional[str]] = {}
        self.agents: set = set()
        self._warm = set()
        self._state: Optional[ops.MaxSumState] = None
        # Cycle counter at the last efficiency record (the state's
        # counter is cumulative across warm-started runs).
        self._cycles_recorded = 0
        self.efficiency_class = "dynamic"
        # Deferred-edit session (batch_edits): None outside a batch.
        self._edit_session = None
        self.edit_stats = {"rows_s": 0.0, "row_patches": 0,
                           "scope_s": 0.0, "scope_rebuilds": 0}
        # The last run's host seconds and the cycles it added.
        self.last_run_s = 0.0
        self.last_run_cycles = 0
        self._build(list(constraints))

    # ------------------------------------------------------------- #
    # compilation / array surgery
    # ------------------------------------------------------------- #

    def _slacked(self, n: int) -> int:
        return max(n + 1, int(math.ceil(n * (1.0 + self.slack))))

    def _build(self, constraints: List[Constraint]):
        """(Re)compile buckets with slack rows, reset the slots and
        place the graph on the device."""
        self.dmax = max(
            (len(v.domain) for v in self.variables), default=1)
        v_count = len(self.variables)
        var_costs = np.full((v_count + 1, self.dmax), BIG, np.float32)
        var_valid = np.zeros((v_count + 1, self.dmax), bool)
        for i, v in enumerate(self.variables):
            d = len(v.domain)
            var_costs[i, :d] = self._var_base_row(v)
            var_valid[i, :d] = True
        # Clamps survive a recompile (on variables that still exist).
        self.clamps = {
            name: idx for name, idx in self.clamps.items()
            if name in self.var_index
            and idx < len(self.variables[self.var_index[name]].domain)
        }
        for name, idx in self.clamps.items():
            i = self.var_index[name]
            kept = var_costs[i, idx]
            var_costs[i, :] = BIG
            var_costs[i, idx] = kept

        by_arity: Dict[int, List[Constraint]] = {}
        for c in constraints:
            by_arity.setdefault(c.arity, []).append(c)

        buckets = []
        self.slots = {}
        self.factors = {}
        self._free: Dict[int, List[int]] = {}
        for bi, arity in enumerate(sorted(by_arity)):
            facs = by_arity[arity]
            n_rows = self._slacked(len(facs))
            shape = (n_rows,) + (self.dmax,) * arity
            costs = np.zeros(shape, np.float32)
            var_ids = np.full((n_rows, arity), v_count, np.int32)
            for fi, c in enumerate(facs):
                self._write_row(costs, var_ids, fi, c)
                self.slots[c.name] = (bi, fi)
                self.factors[c.name] = c
            self._free[bi] = list(range(len(facs), n_rows))
            buckets.append(FactorBucket(costs, var_ids))
        self._arity_bucket = {
            b.arity: i for i, b in enumerate(buckets)
        }
        self.graph = CompiledFactorGraph(
            var_costs=var_costs, var_valid=var_valid,
            buckets=tuple(buckets),
        )
        self.placed = to_device_graph(self.graph, self.device)
        self.recompile_count += 1
        self._warm = set()

    def _write_row(self, costs: np.ndarray, var_ids: np.ndarray,
                   row: int, c: Constraint):
        costs[row], var_ids[row] = self._render_row(
            costs.shape[1:], c)

    def _patch_bucket(self, bi: int, row: int,
                      c: Optional[Constraint]):
        """Replace one bucket row, on the host copy and on the device.
        Inside :meth:`batch_edits` the write is deferred (the last
        write per row wins) and applied at the flush.  The row is
        rendered at once either way, so a malformed constraint fails
        its own action, never the flush."""
        bucket = self.graph.buckets[bi]
        payload = (None if c is None
                   else self._render_row(bucket.costs.shape[1:], c))
        if self._edit_session is not None:
            self._edit_session["buckets"].setdefault(
                bi, {})[row] = payload
            return
        self._apply_bucket_edits({bi: {row: payload}})

    def _apply_bucket_edits(self, bucket_edits: Dict[int, Dict]):
        """Write pre-rendered rows: one host copy and one in-place
        patch per touched bucket, then one scope rebuild when any
        row's var ids changed."""
        t0 = time.perf_counter()
        new_buckets = list(self.graph.buckets)
        moved = False
        for bi, rows in bucket_edits.items():
            bucket = new_buckets[bi]
            costs = np.asarray(bucket.costs).copy()
            var_ids = np.asarray(bucket.var_ids).copy()
            self._materialize_bucket_rows(costs, var_ids, rows)
            at = sorted(rows)
            moved = moved or not np.array_equal(
                np.asarray(bucket.var_ids)[at], var_ids[at])
            new_buckets[bi] = FactorBucket(costs, var_ids)
        self.graph = self.graph._replace(buckets=tuple(new_buckets))
        for bi, rows in bucket_edits.items():
            place_bucket_rows(self.placed, self.graph, bi, rows)
        t1 = time.perf_counter()
        self.edit_stats["rows_s"] += t1 - t0
        self.edit_stats["row_patches"] += 1
        if moved:
            self.placed = replace_scope(self.placed, self.graph)
            self.edit_stats["scope_s"] += time.perf_counter() - t1
            self.edit_stats["scope_rebuilds"] += 1

    def _render_row(self, cell_shape, c: Constraint):
        """One factor's cost row and scope ids in a bucket's cell
        shape; every way a constraint can be malformed raises here."""
        table = self.sign * np.asarray(c.to_array(), np.float32)
        full = np.full(cell_shape, BIG, np.float32)
        idx = tuple(slice(0, s) for s in table.shape)
        full[idx] = table
        ids = np.array([self.var_index[v.name] for v in c.dimensions],
                       np.int32)
        return full, ids

    def _materialize_bucket_rows(self, costs: np.ndarray,
                                 var_ids: np.ndarray, rows: Dict):
        """Assign pre-rendered rows onto copied bucket arrays: a
        ``(costs_row, ids)`` tuple writes a factor, None resets the row
        to slack (zero cost, sentinel ids).  Cannot fail on malformed
        input."""
        for row, payload in rows.items():
            if payload is None:
                costs[row] = 0.0
                var_ids[row] = len(self.variables)
            else:
                costs[row], var_ids[row] = payload

    # -- deferred-edit batching -------------------------------------- #

    @contextlib.contextmanager
    def batch_edits(self):
        """Accumulate the edits of the block and apply them at its exit:
        one copy and one patch per touched bucket, var table and state
        tensor, and at most one scope rebuild.  Edits that force a
        recompile flush the pending set first.  Reentrant: an inner
        block is a no-op, the outermost flushes."""
        if self._edit_session is not None:
            yield self
            return
        self._edit_session = {
            "buckets": {},      # bi -> {row: payload|None}
            "var_rows": {},     # var index -> row values
            "zero_rows": [],    # (bi, row) state-message resets
        }
        try:
            yield self
        finally:
            # The session clears even if the flush raises.
            try:
                self._flush_pending_edits()
            finally:
                self._edit_session = None

    def _flush_pending_edits(self):
        """Apply the deferred edits; leaves the session open but
        empty."""
        sess = self._edit_session
        if sess is None:
            return
        bucket_edits, sess["buckets"] = sess["buckets"], {}
        var_rows, sess["var_rows"] = sess["var_rows"], {}
        zero_rows, sess["zero_rows"] = sess["zero_rows"], []
        if bucket_edits:
            self._apply_bucket_edits(bucket_edits)
        if var_rows:
            self._apply_var_rows(var_rows)
        if zero_rows and self._state is not None:
            by_bucket: Dict[int, List[int]] = {}
            for bi, row in zero_rows:
                by_bucket.setdefault(bi, []).append(row)
            self._state = self._zero_state_rows(self._state, by_bucket)

    def _queue_zero_row(self, bi: int, row: int):
        """Neutralise one factor's stale message rows, now or at the
        batch's flush."""
        if self._state is None:
            return
        if self._edit_session is not None:
            self._edit_session["zero_rows"].append((bi, row))
            return
        self._state = self._zero_state_rows(self._state, {bi: [row]})

    def _var_base_row(self, v: Variable) -> np.ndarray:
        """The variable's unclamped unary cost slice (sign-folded, with
        its name-seeded noise)."""
        d = len(v.domain)
        costs = self.sign * v.cost_vector()[:d]
        if self.noise_level:
            costs = costs + _stable_noise(
                v.name, d, self.noise_level, self.noise_seed)
        return np.asarray(costs, np.float32)

    def _patch_var_rows(self, rows: Dict[int, np.ndarray]):
        """Replace unary cost rows (deferred under :meth:`batch_edits`)."""
        if self._edit_session is not None:
            self._edit_session["var_rows"].update(rows)
            return
        self._apply_var_rows(rows)

    def _apply_var_rows(self, rows: Dict[int, np.ndarray]):
        t0 = time.perf_counter()
        var_costs = np.asarray(self.graph.var_costs).copy()
        for i, row in rows.items():
            var_costs[i, :] = row
        self.graph = self.graph._replace(var_costs=var_costs)
        place_var_rows(self.placed, self.graph, rows)
        self.edit_stats["rows_s"] += time.perf_counter() - t0
        self.edit_stats["row_patches"] += 1

    # ------------------------------------------------------------- #
    # decimation clamps
    # ------------------------------------------------------------- #

    def clamp_variables(self, clamps: Dict[str, int]) -> None:
        """Freeze variables at a domain index: the unary row turns BIG
        everywhere else.  Every entry is validated before any is
        recorded."""
        rows: Dict[int, np.ndarray] = {}
        validated: Dict[str, int] = {}
        for name, idx in clamps.items():
            i = self.var_index[name]
            v = self.variables[i]
            idx = int(idx)
            if not 0 <= idx < len(v.domain):
                raise ValueError(
                    f"clamp index {idx} out of domain for {name}")
            row = np.full(self.dmax, BIG, np.float32)
            row[idx] = self._var_base_row(v)[idx]
            rows[i] = row
            validated[name] = idx
        if rows:
            self.clamps.update(validated)
            self._patch_var_rows(rows)
            self._unfreeze()

    def release_clamps(self, names: Iterable[str]) -> List[str]:
        """Release the clamps on exactly ``names`` (others ignored);
        returns the names released."""
        rows: Dict[int, np.ndarray] = {}
        released = []
        for name in names:
            if name not in self.clamps or name not in self.var_index:
                self.clamps.pop(name, None)
                continue
            del self.clamps[name]
            i = self.var_index[name]
            v = self.variables[i]
            row = np.full(self.dmax, BIG, np.float32)
            row[:len(v.domain)] = self._var_base_row(v)
            rows[i] = row
            released.append(name)
        if rows:
            self._patch_var_rows(rows)
            self._unfreeze()
        return released

    def beliefs(self) -> np.ndarray:
        """Host float64 beliefs ``[V, dmax]``: unary costs (clamps
        included) plus every incident factor->variable message (fetched
        from the device).  Before the first run, the unary table."""
        bel = np.asarray(
            self.graph.var_costs, np.float64)[:-1].copy()
        if self._state is None:
            return bel
        padded = np.zeros(
            (len(self.variables) + 1, self.dmax), np.float64)
        padded[:-1] = bel
        for bi, bucket in enumerate(self.graph.buckets):
            var_ids = np.asarray(bucket.var_ids).reshape(-1)
            msgs = _host(self._state.f2v[bi]).astype(
                np.float64).reshape(-1, self.dmax)
            np.add.at(padded, var_ids, msgs)
        return padded[:-1]

    def decimate(self, margin: float = 0.0,
                 max_fraction: float = 0.25) -> List[str]:
        """Clamp the most-decided unclamped variables (belief margin at
        least ``margin``; at most ``max_fraction`` of the unclamped
        ones, most confident first) to their best value.  Returns the
        clamped names."""
        bel = self.beliefs()
        valid = np.asarray(self.graph.var_valid)[:-1]
        candidates = []
        for i, v in enumerate(self.variables):
            if v.name in self.clamps:
                continue
            row = np.where(valid[i], bel[i], np.inf)
            if np.count_nonzero(np.isfinite(row)) < 2:
                continue
            order = np.argsort(row)
            m = float(row[order[1]] - row[order[0]])
            if m >= margin:
                candidates.append((m, v.name, int(order[0])))
        if not candidates:
            return []
        budget = max(
            1, int(math.ceil(
                max_fraction
                * (len(self.variables) - len(self.clamps)))))
        candidates.sort(reverse=True)
        chosen = {name: idx for _, name, idx in candidates[:budget]}
        self.clamp_variables(chosen)
        return list(chosen)

    # ------------------------------------------------------------- #
    # placement bookkeeping (agent events)
    # ------------------------------------------------------------- #

    def set_placement(self, mapping: Dict[str, str]) -> None:
        """Computation-name -> agent hosting map."""
        self.placement = dict(mapping)
        self.agents = {a for a in mapping.values() if a is not None}

    def add_agent(self, name: str) -> None:
        self.agents.add(name)

    def remove_agent(self, name: str) -> Dict[str, Optional[str]]:
        """Re-home the departed agent's computations onto the
        least-loaded survivors (``None`` when there is none, with a
        warning).  Returns the moved computations and their hosts."""
        self.agents.discard(name)
        moved: Dict[str, Optional[str]] = {}
        loads: Dict[str, int] = {a: 0 for a in self.agents}
        for comp, agent in self.placement.items():
            if agent in loads:
                loads[agent] += 1
        for comp, agent in list(self.placement.items()):
            if agent != name:
                continue
            if loads:
                target = min(loads, key=lambda a: (loads[a], a))
                loads[target] += 1
            else:
                target = None
            self.placement[comp] = target
            moved[comp] = target
        if moved and not self.agents:
            logger.warning(
                "remove_agent(%s): no surviving agents; %d "
                "computation(s) orphaned", name, len(moved))
        return moved

    # ------------------------------------------------------------- #
    # dynamic edits
    # ------------------------------------------------------------- #

    def _unfreeze(self):
        """Every edit clears convergence, so the warm-started loop runs
        until the new costs have propagated."""
        if self._state is not None:
            self._state = self._state._replace(
                stable=torch.tensor(False, device=self.device))

    def change_factor(self, name: str, new_constraint: Constraint):
        """Swap a live factor's cost function in place; its messages
        stay.  The scope must be the same."""
        if name not in self.slots:
            raise KeyError(f"No live factor named {name}")
        old = self.factors[name]
        if [v.name for v in new_constraint.dimensions] != \
                [v.name for v in old.dimensions]:
            raise ValueError(
                "change_factor requires the same variable scope; use "
                "remove_factor + add_factor for topology changes"
            )
        bi, row = self.slots[name]
        self._patch_bucket(bi, row, new_constraint)
        self.factors[name] = new_constraint
        self._unfreeze()

    def remove_factor(self, name: str):
        """Delete a factor; its row becomes slack and its messages are
        zeroed."""
        bi, row = self.slots.pop(name)
        del self.factors[name]
        self._patch_bucket(bi, row, None)
        self._free[bi].append(row)
        self._queue_zero_row(bi, row)

    def add_factor(self, c: Constraint):
        """Insert a factor into a slack row of its arity when one is
        free and its domains fit; otherwise recompile, carrying the
        messages."""
        if c.name in self.slots:
            raise ValueError(f"Factor {c.name} already exists")
        new_vars = [
            v for v in c.dimensions if v.name not in self.var_index
        ]
        # New variables change the shapes: flush the deferred edits
        # first (their sentinel index is the old variable count).
        if new_vars:
            self._flush_pending_edits()
        for v in new_vars:
            self.variables.append(v)
            self.var_index[v.name] = len(self.variables) - 1
        bi = self._arity_bucket.get(c.arity)
        fits = (
            not new_vars
            and bi is not None and self._free.get(bi)
            and all(len(v.domain) <= self.dmax for v in c.dimensions)
        )
        self.factors[c.name] = c
        if fits:
            row = self._free[bi].pop(0)
            self._patch_bucket(bi, row, c)
            self.slots[c.name] = (bi, row)
            self._queue_zero_row(bi, row)
        else:
            self._flush_pending_edits()
            self._recompile_carrying_messages(
                list(self.factors.values()))

    def add_variable(self, v: Variable):
        """Add a variable (no incident factor yet): a recompile."""
        if v.name in self.var_index:
            return
        self._flush_pending_edits()
        self.variables.append(v)
        self.var_index[v.name] = len(self.variables) - 1
        self._recompile_carrying_messages(list(self.factors.values()))

    def _zero_state_rows(self, state: ops.MaxSumState,
                         rows_by_bucket: Dict[int, List[int]]
                         ) -> ops.MaxSumState:
        """Zero the message and count rows of a set of edges (one
        write per touched tensor), clear ``stable``."""
        def zero(msgs):
            out = list(msgs)
            for bi, rows in rows_by_bucket.items():
                arr = out[bi] if self.donate else out[bi].clone()
                arr[torch.tensor(sorted(set(rows)), dtype=torch.int64,
                                 device=arr.device)] = 0
                out[bi] = arr
            return tuple(out)

        return ops.MaxSumState(
            v2f=zero(state.v2f), f2v=zero(state.f2v),
            v2f_count=zero(state.v2f_count),
            f2v_count=zero(state.f2v_count),
            stable=torch.tensor(False, device=self.device),
            cycle=state.cycle,
        )

    def _state_from_numpy(self, v2f, f2v, v2f_c, f2v_c, stable: bool,
                          cycle: int) -> ops.MaxSumState:
        def put(arrs):
            return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device) for a in arrs)

        return ops.MaxSumState(
            v2f=put(v2f), f2v=put(f2v), v2f_count=put(v2f_c),
            f2v_count=put(f2v_c),
            stable=torch.tensor(bool(stable), device=self.device),
            cycle=torch.tensor(int(cycle), dtype=torch.int32,
                               device=self.device),
        )

    def _empty_rows(self):
        d = self.dmax
        shapes = [b.var_ids.shape for b in self.graph.buckets]
        return ([np.zeros(s + (d,), np.float32) for s in shapes],
                [np.zeros(s + (d,), np.float32) for s in shapes],
                [np.zeros(s, np.int8) for s in shapes],
                [np.zeros(s, np.int8) for s in shapes])

    def _recompile_carrying_messages(self, constraints):
        """Full rebuild; surviving factors' message rows are copied
        into their new slots so the run continues warm."""
        old_state = self._state
        old_slots = dict(self.slots)
        old_d = self.dmax
        self._build(constraints)
        if old_state is None:
            return
        v2f, f2v, v2f_c, f2v_c = self._empty_rows()
        old_v2f = [_host(a) for a in old_state.v2f]
        old_f2v = [_host(a) for a in old_state.f2v]
        old_v2f_c = [_host(a) for a in old_state.v2f_count]
        old_f2v_c = [_host(a) for a in old_state.f2v_count]
        dcopy = min(self.dmax, old_d)
        for name, (bi, row) in self.slots.items():
            old = old_slots.get(name)
            if old is None:
                continue
            obi, orow = old
            v2f[bi][row, :, :dcopy] = old_v2f[obi][orow, :, :dcopy]
            f2v[bi][row, :, :dcopy] = old_f2v[obi][orow, :, :dcopy]
            v2f_c[bi][row] = old_v2f_c[obi][orow]
            f2v_c[bi][row] = old_f2v_c[obi][orow]
        self._state = self._state_from_numpy(
            v2f, f2v, v2f_c, f2v_c, False, int(old_state.cycle))

    # ------------------------------------------------------------- #
    # running
    # ------------------------------------------------------------- #

    def run(self, max_cycles: int = 1000,
            stop_on_convergence: bool = True) -> DeviceRunResult:
        """Continue the trajectory for up to ``max_cycles`` more
        cycles on the placed graph."""
        key = (max_cycles, stop_on_convergence,
               tuple(b.costs.shape for b in self.graph.buckets),
               self.graph.var_costs.shape)
        if self._state is None:
            self._state = ops.init_state(self.placed)
        state0 = self._state
        (state, values), compile_s, run_s = timed_engine_call(
            self._warm, key, lambda: ops.run_maxsum_from(
                self.placed, state0, max_cycles,
                damping=self.damping, damp_vars=self.damp_vars,
                damp_factors=self.damp_factors,
                stability=self.stability,
                stop_on_convergence=stop_on_convergence),
            self.device, max_cycles)
        self._state = state
        values = _host(values)
        assignment = {
            v.name: v.domain[int(values[i])]
            for i, v in enumerate(self.variables)
        }
        metrics = {"recompiles": self.recompile_count - 1,
                   "cold_start": compile_s > 0}
        cycle = int(state.cycle)
        ran = max(cycle - self._cycles_recorded, 0)
        self._cycles_recorded = cycle
        self.last_run_s, self.last_run_cycles = run_s, ran
        if efficiency.tracker.enabled:
            record = efficiency.tracker.record_dispatch(
                key=str(key),
                structure=efficiency.structure_label(self.graph),
                backend=efficiency.backend_name(),
                time_s=run_s, compile_s=compile_s, cycles=ran,
                n_real=1, batch_size=1,
                packing=self.efficiency_class,
                cost_entry=(profiler.get(key)
                            if profiler.enabled else None),
            )
            if record is not None:
                metrics["efficiency"] = record
        if profiler.enabled:
            entry = profiler.get(key)
            if entry is not None:
                metrics["xla_cost"] = {key_str(key): entry}
        return DeviceRunResult(
            assignment=assignment,
            cycles=cycle,
            converged=bool(state.stable),
            time_s=run_s,
            compile_time_s=compile_s,
            metrics=metrics,
        )

    def cost(self, assignment: Dict) -> float:
        """Host solution cost of an assignment: unary costs plus every
        live factor, hard violations counted as 0 (the
        ``DCOP.solution_cost`` convention)."""
        total = 0.0
        for v in self.variables:
            total += float(v.cost_for_val(assignment[v.name]))
        for c in self.factors.values():
            value = float(c(**{
                v.name: assignment[v.name] for v in c.dimensions
            }))
            if abs(value) != float("inf"):
                total += value
        return total

    # ------------------------------------------------------------- #
    # checkpoint / resume (the reference's NPZ layout: either package
    # reads the other's snapshots)
    # ------------------------------------------------------------- #

    def checkpoint(self, path: str) -> None:
        """Dump the solver state to an .npz file (messages by factor
        name; the graph layout is not saved)."""
        if self._state is None:
            raise ValueError("Nothing to checkpoint: engine never ran")
        state = self._state
        names = sorted(self.slots)
        arrays = {
            "cycle": np.asarray(int(state.cycle), np.int32),
            "stable": np.asarray(bool(state.stable)),
            "slot_names": np.array(names),
            "slot_pos": np.array(
                [self.slots[n] for n in names], dtype=np.int64),
        }
        for bi in range(len(self.graph.buckets)):
            arrays[f"v2f_{bi}"] = _host(state.v2f[bi])
            arrays[f"f2v_{bi}"] = _host(state.f2v[bi])
            arrays[f"v2f_count_{bi}"] = _host(state.v2f_count[bi])
            arrays[f"f2v_count_{bi}"] = _host(state.f2v_count[bi])
        np.savez(path, **arrays)

    def restore(self, path: str) -> None:
        """Load a checkpoint written by :meth:`checkpoint` (either
        package's); message rows are remapped by factor name."""
        data = np.load(path)
        saved_names = [str(n) for n in data["slot_names"]]
        if saved_names != sorted(self.slots):
            only_saved = sorted(set(saved_names) - set(self.slots))
            only_engine = sorted(set(self.slots) - set(saved_names))
            raise ValueError(
                "Checkpoint does not match this engine's factors: "
                f"only in checkpoint {only_saved}, only in engine "
                f"{only_engine}"
            )
        saved_pos = {
            name: tuple(pos)
            for name, pos in zip(saved_names, data["slot_pos"])
        }
        v2f, f2v, v2f_c, f2v_c = self._empty_rows()
        for name, (bi, row) in self.slots.items():
            sbi, srow = saved_pos[name]
            saved_row = data[f"v2f_{sbi}"][srow]
            if saved_row.shape != v2f[bi][row].shape:
                raise ValueError(
                    f"Checkpoint row for {name} has shape "
                    f"{saved_row.shape}, engine expects "
                    f"{v2f[bi][row].shape}"
                )
            v2f[bi][row] = saved_row
            f2v[bi][row] = data[f"f2v_{sbi}"][srow]
            v2f_c[bi][row] = data[f"v2f_count_{sbi}"][srow]
            f2v_c[bi][row] = data[f"f2v_count_{sbi}"][srow]
        self._state = self._state_from_numpy(
            v2f, f2v, v2f_c, f2v_c, bool(data["stable"]),
            int(data["cycle"]))
        self._cycles_recorded = int(data["cycle"])


# --------------------------------------------------------------------- #
# Scenario event vocabulary (dcop/scenario.py actions -> engine edits)
# --------------------------------------------------------------------- #

EVENT_ACTIONS = ("change_factor", "add_factor", "remove_factor",
                 "add_variable", "remove_agent", "add_agent")


def _constraint_from_args(engine: DynamicMaxSumEngine, name: str,
                          args: Dict[str, Any],
                          default_scope: Optional[List[Variable]] = None
                          ) -> Constraint:
    """A Constraint from action args: a dense cost ``table`` over
    ``variables`` (names resolved against the engine; change_factor
    defaults to the live factor's scope) or an ``expression``."""
    from pydcop_tpu_torch.dcop.relations import (
        NAryMatrixRelation,
        constraint_from_str,
    )

    if "expression" in args:
        return constraint_from_str(
            name, args["expression"], engine.variables)
    if "table" not in args:
        raise ValueError(
            f"action for factor {name!r} needs a 'table' (dense cost "
            "hypercube) or an 'expression'")
    var_names = args.get("variables")
    if var_names:
        scope = []
        for vn in var_names:
            if vn not in engine.var_index:
                raise ValueError(
                    f"unknown variable {vn!r} in factor {name!r} "
                    "(add_variable it first)")
            scope.append(engine.variables[engine.var_index[vn]])
    elif default_scope is not None:
        scope = list(default_scope)
    else:
        raise ValueError(
            f"factor {name!r} needs a 'variables' list")
    return NAryMatrixRelation(
        scope, np.asarray(args["table"], float), name)


def apply_action(engine: DynamicMaxSumEngine, action_type: str,
                 args: Dict[str, Any]) -> Dict[str, Any]:
    """Apply one scenario action to a live engine.  Returns ``{"type",
    "touched"}`` (the variables whose clamps the caller should
    release); raises ``ValueError``/``KeyError`` on malformed or
    unknown actions."""
    args = dict(args or {})
    if action_type == "change_factor":
        name = args["name"]
        if name not in engine.factors:
            raise KeyError(f"No live factor named {name}")
        old_scope = engine.factors[name].dimensions
        c = _constraint_from_args(engine, name, args,
                                  default_scope=old_scope)
        engine.change_factor(name, c)
        return {"type": action_type,
                "touched": [v.name for v in c.dimensions]}
    if action_type == "add_factor":
        name = args["name"]
        c = _constraint_from_args(engine, name, args)
        engine.add_factor(c)
        return {"type": action_type,
                "touched": [v.name for v in c.dimensions]}
    if action_type == "remove_factor":
        name = args["name"]
        if name not in engine.slots:
            raise KeyError(f"No live factor named {name}")
        touched = [v.name
                   for v in engine.factors[name].dimensions]
        engine.remove_factor(name)
        return {"type": action_type, "touched": touched}
    if action_type == "add_variable":
        from pydcop_tpu_torch.dcop.objects import Domain

        name = args["name"]
        values = args.get("domain")
        if not values:
            raise ValueError(
                f"add_variable {name!r} needs a 'domain' value list")
        engine.add_variable(Variable(
            name, Domain(f"{name}_dom", "", list(values))))
        return {"type": action_type, "touched": [name]}
    if action_type == "remove_agent":
        moved = engine.remove_agent(args["agent"])
        return {"type": action_type, "touched": [],
                "moved": moved}
    if action_type == "add_agent":
        engine.add_agent(args["agent"])
        return {"type": action_type, "touched": []}
    raise ValueError(
        f"unknown scenario action {action_type!r}; valid: "
        f"{', '.join(EVENT_ACTIONS)}")


def build_dynamic_engine(dcop, params: Optional[Dict[str, Any]] = None,
                         device: DeviceLike = "cuda"
                         ) -> DynamicMaxSumEngine:
    """A DynamicMaxSumEngine over a DCOP with the maxsum parameter
    names (damping, damping_nodes, stability, noise, slack), and a
    round-robin hosting map over the DCOP's agents."""
    params = params or {}
    engine = DynamicMaxSumEngine(
        list(dcop.variables.values()),
        list(dcop.constraints.values()),
        mode=dcop.objective,
        noise_level=float(params.get("noise", 0.01)),
        damping=float(params.get("damping", 0.5)),
        damping_nodes=params.get("damping_nodes", "both"),
        stability=float(params.get("stability", 0.1)),
        slack=float(params.get("slack", 0.25)),
        device=device,
    )
    agents = sorted(dcop.agents) or ["a0"]
    comps = ([v.name for v in engine.variables]
             + sorted(engine.factors))
    engine.set_placement({
        comp: agents[i % len(agents)]
        for i, comp in enumerate(comps)
    })
    return engine


def replay_scenario(dcop, scenario,
                    params: Optional[Dict[str, Any]] = None,
                    max_cycles: int = 1000,
                    event_cycles: Optional[int] = None,
                    decimation_margin: Optional[float] = None,
                    on_event=None,
                    device: DeviceLike = "cuda",
                    engine: Optional[DynamicMaxSumEngine] = None
                    ) -> Dict[str, Any]:
    """Replay a dcop/scenario.py event script through a
    DynamicMaxSumEngine (the ``solve --scenario`` engine).

    The initial problem is solved to convergence, then each event's
    actions are applied between engine segments, in one
    :meth:`DynamicMaxSumEngine.batch_edits` (a delay is a segment
    boundary: replay is logical time), and the run re-converges warm,
    releasing decimation clamps on the touched variables only.
    ``engine``, when given, is a :func:`build_dynamic_engine` of
    ``dcop`` to replay on (its ``edit_stats`` then stay readable).
    Returns the final assignment and cost plus a record per event."""
    if engine is None:
        engine = build_dynamic_engine(dcop, params, device=device)
    budget = event_cycles or max_cycles
    res = engine.run(max_cycles=max_cycles)
    events: List[Dict[str, Any]] = []
    for event in scenario:
        t0 = time.perf_counter()
        if event.is_delay:
            res = engine.run(max_cycles=budget)
            events.append({
                "id": event.id, "delay": event.delay,
                "cost": engine.cost(res.assignment),
                "cycles": res.cycles,
                "recompiles": 0,
                "wall_s": time.perf_counter() - t0,
            })
            continue
        before = engine.recompile_count
        touched: List[str] = []
        applied = []
        # One patch (and at most one scope rebuild) an event: the same
        # state as the reference's action by action.
        with engine.batch_edits():
            for action in (event.actions or []):
                info = apply_action(engine, action.type, action.args)
                touched.extend(info["touched"])
                applied.append(info["type"])
        if touched:
            engine.release_clamps(touched)
        res = engine.run(max_cycles=budget)
        if decimation_margin is not None:
            engine.decimate(margin=decimation_margin)
        rec = {
            "id": event.id,
            "actions": applied,
            "touched": sorted(set(touched)),
            "recompiles": engine.recompile_count - before,
            "cost": engine.cost(res.assignment),
            "cycles": res.cycles,
            "converged": res.converged,
            "wall_s": time.perf_counter() - t0,
        }
        events.append(rec)
        if on_event is not None:
            on_event(rec)
    assignment = res.assignment
    return {
        "assignment": assignment,
        "cost": engine.cost(assignment),
        "cycles": res.cycles,
        "converged": res.converged,
        "events": events,
        "event_count": sum(
            1 for e in scenario if not e.is_delay),
        "recompiles": engine.recompile_count - 1,
        "clamped": sorted(engine.clamps),
        "factors": sorted(engine.factors),
        "violations": sum(
            1 for c in engine.factors.values()
            if abs(c(**{v.name: assignment[v.name]
                        for v in c.dimensions})) == float("inf")),
        "orphaned": sorted(
            c for c, a in engine.placement.items() if a is None),
    }
