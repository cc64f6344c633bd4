"""``chip_smoke.py``'s ``generated`` phase rehearsed on the CPU at reduced
sizes (``card="cpu"``: the CPU against itself, nothing timed): each of
the six generated families solved with maxsum, dsa and mgm and held to
a second solve, the MaxSum messages of the unary-and-binary problems
held bit for bit, and the CLI leg (``generate``, ``graph -a maxsum``,
``solve``) on the file it writes — run to the end (the phase's own
checks raise otherwise).  The launch counts and ``factor_to_var``'s
times are the card's business and are not checked here.
"""

import pytest
import torch

import chip_smoke
from pydcop_tpu_torch import api
from pydcop_tpu_torch.ops import _build


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# The phase's problems with their sizes cut for the CPU; the shapes
# (domains, arities, graph models) are the card's.
SMALL = {
    "graph_coloring": (120, 3, "scalefree"),
    "ising": (8,),
    "meetings": (10, 20, 8, 4),
    "secp": (60, 12, 12),
    "iot": (120,),
    "small_world": (80,),
}


def test_generated_phase_runs_on_the_cpu():
    problems = [(label, module, func, SMALL[label], kwargs)
                for label, module, func, _, kwargs
                in chip_smoke.GENERATED_PROBLEMS]
    assert [p[0] for p in problems] == list(SMALL)
    out = chip_smoke.phase_generated(dict(
        torch=torch, _build=_build, api=api, problems=problems),
        card="cpu")
    rows = out["problems"]
    assert list(rows) == list(SMALL)
    for label, row in rows.items():
        assert list(row["solves"]) == list(chip_smoke.GENERATED_ALGOS)
        assert all(s["cycles"] <= chip_smoke.GENERATED_CYCLES
                   for s in row["solves"].values())
    assert rows["secp"]["arities"] == [1, 2, 3, 4]
    assert "messages_bit_equal" not in rows["secp"]
    for label in ("graph_coloring", "ising", "iot", "small_world"):
        assert rows[label]["messages_bit_equal"] > 0
    assert out["cli"]["graph"]["variables"] == 100
    assert out["cli"]["cycle"] == chip_smoke.GENERATED_CYCLES
    assert out["factor_to_var"] == {}
