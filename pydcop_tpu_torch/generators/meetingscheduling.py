"""Meeting-scheduling benchmark generator (PEAV model).

Ported copy of ``pydcop_tpu/generators/meetingscheduling.py``:
the port keeps its own copy, behaviour unchanged.

Reference parity: pydcop/commands/generators/meetingscheduling.py
(peav_model :317): Private-Events-As-Variables — one variable per
(resource, event) pair over the slot domain (0 = not scheduled);
intra-resource constraints penalize overlapping schedules and reward
valued slots (:528-585); inter-resource constraints force all
participants of an event to agree on its slot (:589-600, -penalty when
different).  Objective: max (utilities, penalties negative).
"""

from typing import Dict, List, Optional, Tuple

import numpy as np

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation


def generate_meetings(
    slots_count: int,
    events_count: int,
    resources_count: int,
    max_resources_event: int,
    max_length_event: int = 1,
    max_resource_value: int = 10,
    penalty: int = 100,
    no_agents: bool = False,
    capacity: Optional[int] = None,
    seed: Optional[int] = None,
) -> DCOP:
    rng = np.random.default_rng(seed)
    # Slot 0 means "not scheduled"; real slots are 1..slots_count.
    domain = Domain("slots", "slots", list(range(slots_count + 1)))

    # Events: length + the resources they request.
    events: List[Dict] = []
    for e in range(events_count):
        n_res = int(rng.integers(1, max_resources_event + 1))
        events.append({
            "id": e,
            "length": int(rng.integers(1, max_length_event + 1)),
            "resources": sorted(
                rng.choice(resources_count, size=min(
                    n_res, resources_count), replace=False).tolist()
            ),
        })

    # Resource r's value for holding event e at slot t.
    value = rng.integers(
        1, max_resource_value + 1,
        size=(resources_count, events_count, slots_count + 1),
    ).astype(float)

    dcop = DCOP(
        f"meetings_{slots_count}_{events_count}_{resources_count}",
        objective="max",
    )

    # PEAV variables: one per (resource, event in which it participates).
    res_events: Dict[int, List[Dict]] = {r: [] for r in
                                         range(resources_count)}
    variables: Dict[Tuple[int, int], Variable] = {}
    for ev in events:
        for r in ev["resources"]:
            v = Variable(f"v_r{r}_e{ev['id']}", domain)
            variables[(r, ev["id"])] = v
            res_events[r].append(ev)
            dcop.add_variable(v)

    # Intra-resource constraints: overlap penalty + slot utilities.
    for r, evs in res_events.items():
        n = len(evs)
        if n == 1:
            ev = evs[0]
            v = variables[(r, ev["id"])]
            table = value[r, ev["id"], :].copy()
            table[0] = 0  # no utility when unscheduled
            dcop.add_constraint(
                NAryMatrixRelation([v], table, f"cu_{v.name}"))
            continue
        for i in range(n):
            for j in range(i + 1, n):
                e1, e2 = evs[i], evs[j]
                v1 = variables[(r, e1["id"])]
                v2 = variables[(r, e2["id"])]
                table = np.zeros((len(domain), len(domain)))
                for t1 in range(len(domain)):
                    for t2 in range(len(domain)):
                        overlap = (
                            t1 != 0 and t2 != 0 and (
                                t1 <= t2 <= t1 + e1["length"] - 1
                                or t2 <= t1 <= t2 + e2["length"] - 1
                            )
                        )
                        if overlap:
                            table[t1, t2] = -penalty
                        else:
                            u1 = value[r, e1["id"], t1] if t1 else 0
                            u2 = value[r, e2["id"], t2] if t2 else 0
                            table[t1, t2] = (u1 + u2) / (n - 1)
                dcop.add_constraint(NAryMatrixRelation(
                    [v1, v2], table, f"ci_{v1.name}_{v2.name}"))

    # Inter-resource constraints: all participants agree on the slot.
    for ev in events:
        participants = ev["resources"]
        for i in range(len(participants)):
            for j in range(i + 1, len(participants)):
                v1 = variables[(participants[i], ev["id"])]
                v2 = variables[(participants[j], ev["id"])]
                table = np.where(
                    np.eye(len(domain), dtype=bool), 0.0, -penalty
                )
                dcop.add_constraint(NAryMatrixRelation(
                    [v1, v2], table, f"ce_{v1.name}_{v2.name}"))

    if not no_agents:
        extra = {"capacity": capacity} if capacity else {}
        dcop.add_agents([
            AgentDef(f"a_r{r}", **extra) for r in range(resources_count)
        ])
    return dcop
