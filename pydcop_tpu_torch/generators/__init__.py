"""Benchmark problem generators.

Ported copy of ``pydcop_tpu/generators/__init__.py``:
the port keeps its own copy, behaviour unchanged.

Reference parity: pydcop/commands/generators/ (graphcoloring.py,
ising.py, meetingscheduling.py, secp.py, agents.py, iot.py, scenario.py,
smallworld.py — CLI glue in commands/generate.py).

All generators here accept an explicit ``seed`` (the reference uses the
unseeded global ``random`` module; deterministic generation is required
for reproducible benchmarks and parity runs).
"""
