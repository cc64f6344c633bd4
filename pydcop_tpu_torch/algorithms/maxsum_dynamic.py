"""Dynamic MaxSum: factor functions and scopes that change at run time.

Port of the device path of ``pydcop_tpu/algorithms/maxsum_dynamic.py``.
A problem solved through this module has its external (read-only)
variables frozen at their current values — every constraint over them
sliced — and the writable problem is solved by MaxSum's engine.
"""

from pydcop_tpu_torch.algorithms import maxsum as _maxsum
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import ExternalVariable

algo_params = _maxsum.algo_params

GRAPH_TYPE = "factor_graph"

# Delegates to the maxsum engine after slicing externals, so the
# partitioned-sharding knob (shards=) flows through **kwargs.
SUPPORTS_SHARDS = True


def _slice_externals(dcop: DCOP) -> DCOP:
    """DCOP with every external variable frozen at its current value:
    constraints over externals are sliced, others pass through."""
    if not dcop.external_variables:
        return dcop
    sliced = DCOP(dcop.name, objective=dcop.objective)
    for v in dcop.variables.values():
        sliced.add_variable(v)
    for c in dcop.constraints.values():
        ext = {
            v.name: v.value for v in c.dimensions
            if isinstance(v, ExternalVariable)
        }
        sliced.add_constraint(c.slice(ext) if ext else c)
    for a in dcop.agents.values():
        sliced.add_agents([a])
    return sliced


def solve_on_device(dcop: DCOP, algo_def, **kwargs):
    """Freeze external variables at their current values, then run the
    MaxSum engine on the writable problem."""
    return _maxsum.solve_on_device(_slice_externals(dcop), algo_def,
                                   **kwargs)
