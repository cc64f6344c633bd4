"""Dynamic-DCOP scenario generators.

Ported copy of ``pydcop_tpu/generators/scenario_gen.py``:
the port keeps its own copy, behaviour unchanged.

:func:`generate_scenario` — reference parity:
pydcop/commands/generators/scenario.py — evts_count events of
actions_count remove_agent actions each, separated by fixed delays;
never removes the orchestrator or already-removed agents.

:func:`generate_factor_scenario` — problem-mutation events for the
incremental device engine (``pydcop solve --scenario``, stateful
serve sessions — docs/sessions.md): seeded change_factor /
remove_factor / add_factor / add_variable actions over a concrete
DCOP's binary constraints, the test-input factory for the session
plane and the dynamic bench leg.
"""

from typing import List, Optional

import numpy as np

from pydcop_tpu_torch.dcop.scenario import DcopEvent, EventAction, Scenario


def generate_scenario(
    evts_count: int,
    actions_count: int,
    delay: float,
    agents: List[str],
    initial_delay: float = 20,
    end_delay: float = 20,
    seed: Optional[int] = None,
) -> Scenario:
    rng = np.random.default_rng(seed)
    available = list(agents)
    events = [DcopEvent("init_delay", delay=initial_delay)]
    for e in range(evts_count):
        if len(available) < actions_count:
            break
        chosen = rng.choice(
            len(available), size=actions_count, replace=False)
        removed = [available[i] for i in sorted(chosen, reverse=True)]
        for name in removed:
            available.remove(name)
        events.append(DcopEvent(
            f"e{e}",
            actions=[
                EventAction("remove_agent", agent=a) for a in removed
            ],
        ))
        events.append(DcopEvent(f"d{e}", delay=delay))
    events.append(DcopEvent("end_delay", delay=end_delay))
    return Scenario(events)


def generate_factor_scenario(
    dcop,
    evts_count: int,
    seed: Optional[int] = None,
    change_weight: float = 0.7,
    churn_weight: float = 0.2,
    grow_weight: float = 0.1,
    cost_range: int = 10,
) -> Scenario:
    """Seeded problem-mutation scenario over ``dcop``'s binary
    constraints.

    Each event holds one action, drawn by weight: ``change_factor``
    (fresh integer cost table, same scope — the in-shape path the
    session plane serves with zero recompiles), ``churn`` (a
    remove_factor followed next event by an add_factor reusing the
    name — the slack-row ladder), or ``grow`` (add_variable + a
    factor tying it in — the recompile-carrying-messages path).
    Tables are integer-valued so replay comparisons can demand exact
    cost equality."""
    rng = np.random.default_rng(seed)
    binary = [
        c for c in dcop.constraints.values()
        if c.arity == 2 and hasattr(c, "matrix")
    ]
    if not binary:
        raise ValueError(
            "generate_factor_scenario needs binary matrix "
            "constraints to mutate")
    removed: List = []
    events: List[DcopEvent] = []
    new_var_count = 0
    var_names = [v.name for v in dcop.variables.values()]
    weights = np.asarray(
        [change_weight, churn_weight, grow_weight], float)
    weights = weights / weights.sum()
    for e in range(evts_count):
        kind = rng.choice(3, p=weights)
        if removed and (kind == 1 or len(binary) == 0):
            # Re-add a previously removed factor under its old name
            # (name-reuse on a freed slack row) with a fresh table.
            c = removed.pop(0)
            d0, d1 = (len(v.domain) for v in c.dimensions)
            table = rng.integers(
                0, cost_range, size=(d0, d1)).astype(float)
            events.append(DcopEvent(f"e{e}", actions=[EventAction(
                "add_factor", name=c.name,
                variables=[v.name for v in c.dimensions],
                table=table.tolist())]))
            binary.append(c)
        elif kind == 1 and len(binary) > 1:
            c = binary.pop(int(rng.integers(len(binary))))
            removed.append(c)
            events.append(DcopEvent(f"e{e}", actions=[EventAction(
                "remove_factor", name=c.name)]))
        elif kind == 2:
            dom = list(dcop.variables.values())[0].domain
            name = f"sv{new_var_count}"
            new_var_count += 1
            anchor = var_names[int(rng.integers(len(var_names)))]
            d = len(dom)
            table = rng.integers(
                0, cost_range, size=(d, d)).astype(float)
            events.append(DcopEvent(f"e{e}", actions=[
                EventAction("add_variable", name=name,
                            domain=list(dom.values)),
                EventAction("add_factor", name=f"sc_{name}",
                            variables=[anchor, name],
                            table=table.tolist()),
            ]))
            var_names.append(name)
        else:
            c = binary[int(rng.integers(len(binary)))]
            d0, d1 = (len(v.domain) for v in c.dimensions)
            table = rng.integers(
                0, cost_range, size=(d0, d1)).astype(float)
            events.append(DcopEvent(f"e{e}", actions=[EventAction(
                "change_factor", name=c.name,
                variables=[v.name for v in c.dimensions],
                table=table.tolist())]))
    return Scenario(events)
