"""On the card: problems made by the port's generators, solved by the
card, equal the CPU's solves.

This file imports neither JAX nor the JAX package.  Every test is
marked ``gpu`` and decides inside itself whether a card is present;
without one it skips.  Where JAX is missing run:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu_generated.py

- A soft graph colouring on a scale-free graph (binary factors, D = 3)
  and a SECP problem (arities 1-4, D = 5), each solved with ``maxsum``,
  ``dsa`` and ``mgm`` on the card and on the CPU: the same assignment,
  cost, violations, cycles and status.  The MaxSum solves launch
  ``binary_factor_update`` on the colouring (one launch a cycle), the
  local search the positional sum.
- ``generate`` then ``graph`` then ``solve --device cuda`` through the
  port's CLI on the file it wrote, in this process: the card's answer
  equals ``solve --device cpu``'s.
"""

import contextlib
import io
import json

import pytest
import torch

from pydcop_tpu_torch import dcop_cli
from pydcop_tpu_torch.api import solve
from pydcop_tpu_torch.generators.graphcoloring import generate_graph_coloring
from pydcop_tpu_torch.generators.secp import generate_secp
from pydcop_tpu_torch.ops import _build


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


PROBLEMS = {
    "coloring": lambda: generate_graph_coloring(
        2_000, 3, "scalefree", soft=True, m_edge=2, seed=0),
    "secp": lambda: generate_secp(300, 60, 60, seed=0),
}


def same_solve(card, cpu):
    for key in ("assignment", "cost", "violations", "cycles", "status"):
        assert card[key] == cpu[key], key


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["maxsum", "dsa", "mgm"])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_generated_card_solve_equals_cpu(name, algo):
    _need_card()
    dcop = PROBLEMS[name]()
    cpu = solve(dcop, algo, max_cycles=60, device="cpu")
    _build.launch_counts.clear()
    card = solve(dcop, algo, max_cycles=60, device="cuda")
    launches = dict(_build.launch_counts)
    same_solve(card, cpu)
    if algo == "maxsum" and name == "coloring":
        assert launches.get("binary_factor_update", 0) >= card["cycles"]
    if algo == "maxsum":
        assert launches.get("segment_sum", 0) > 0
    else:
        assert any(k.startswith("segment_sum:positional")
                   for k, n in launches.items() if n), launches


def run_cli(args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = dcop_cli.main(args)
    return rc, out.getvalue()


@pytest.mark.gpu
def test_generate_graph_and_solve_through_the_cli(tmp_path):
    _need_card()
    path = str(tmp_path / "gc.yaml")
    rc, _ = run_cli(["--output", path, "generate", "graph_coloring", "-v",
                     "100", "-c", "3", "-g", "scalefree", "-m", "2",
                     "--seed", "0"])
    assert rc == 0
    rc, text = run_cli(["graph", "-a", "maxsum", path])
    assert rc == 0
    graph = json.loads(text)
    assert graph["nodes"] == graph["variables"] + graph["constraints"]
    answers = []
    for device in ("cuda", "cpu"):
        rc, text = run_cli(["solve", "-a", "maxsum", "-c", "60",
                            "--device", device, path])
        assert rc == 0
        answers.append(json.loads(text))
    card, cpu = answers
    for key in ("assignment", "cost", "violation", "cycle", "status"):
        assert card[key] == cpu[key], key
