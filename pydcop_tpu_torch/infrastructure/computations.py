"""Computation model of the agent runtime.

Ported copy of the part of ``pydcop_tpu/infrastructure/computations.py``
that the device solvers import: ``ComputationException``, which NCBB
raises on a constraint it cannot take.  The messages, computations and
their runtime are not ported yet.
"""


class ComputationException(Exception):
    pass
