"""The port's SyncBB and NCBB (algorithms/syncbb.py, algorithms/ncbb.py)
against ``pydcop_tpu`` on the CPU.

Both are host searches that touch no tensor.  On every fixture that
``tests/api/test_golden_parity.py`` calls tractable (a joint space of at
most 50,000 assignments), ``api.solve(dcop, algo, device="cpu")`` equals
``pydcop_tpu.api.solve(dcop, algo)``: assignment, cost, violations,
``cycles``, status and every metric (``msg_count``, ``device_cost``,
NCBB's ``upper_bound``); on minimisation fixtures both reach DPOP's
optimum.  NCBB refuses a constraint of arity above 2 with the
reference's ``ComputationException``.  Random trees and width-bounded
graphs with integer tables (``tests/unit/test_exact_inference_battery
.py``'s cases) give the same results and land exactly on DPOP's
optimum; the CLI prints the same JSON; without ``device="cpu"`` and
without a card the solve raises.
"""

import contextlib
import io
import json
import os

import pytest
import torch

from pydcop_tpu import api as japi
from pydcop_tpu import dcop_cli as jcli
from pydcop_tpu.infrastructure.computations import (
    ComputationException as JaxComputationException,
)
from pydcop_tpu_torch import api as tapi
from pydcop_tpu_torch import dcop_cli as tcli
from pydcop_tpu_torch.infrastructure.computations import (
    ComputationException,
)
from test_torch_compile import INSTANCES, load_both
from test_torch_pseudotree import both, random_dcop


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# The repository's fixtures whose joint space is at most 50,000
# assignments (test_golden_parity.py's TRACTABLE, scenarios excluded).
TRACTABLE = ["coloring_3agents_10vars.yaml", "coloring_4agents_10vars.yaml",
             "coloring_chain.yaml", "coloring_chain_func.yaml",
             "coloring_chain_init.yaml", "coloring_ext_costs.yaml",
             "coloring_int_costs.yaml", "coloring_ring_hard.yaml",
             "pref_ring.yaml", "pref_ring_max.yaml", "secp_lamps.yaml"]


def test_tractable_list_is_the_golden_parity_one():
    from fixtures_paths import local_instances

    names = []
    for path in local_instances():
        jax_dcop, _ = load_both(os.path.basename(path))
        space = 1
        for v in jax_dcop.variables.values():
            space *= len(v.domain)
        if space <= 50_000:
            names.append(os.path.basename(path))
    assert names == TRACTABLE


def _same_result(out, ref):
    for key in ("assignment", "cost", "violations", "cycles", "status",
                "backend"):
        assert out[key] == ref[key], key
    assert out["metrics"] == ref["metrics"]


@pytest.mark.parametrize("algo", ["syncbb", "ncbb"])
@pytest.mark.parametrize("fixture", TRACTABLE)
def test_fixture_solves_equal_reference(fixture, algo):
    jax_dcop, torch_dcop = load_both(fixture)
    if algo == "ncbb" and any(c.arity > 2
                              for c in torch_dcop.constraints.values()):
        with pytest.raises(JaxComputationException):
            japi.solve(jax_dcop, algo)
        with pytest.raises(ComputationException):
            tapi.solve(torch_dcop, algo, device="cpu")
        return
    ref = japi.solve(jax_dcop, algo)
    out = tapi.solve(torch_dcop, algo, device="cpu")
    _same_result(out, ref)
    if torch_dcop.objective == "min":
        dpop = tapi.solve(torch_dcop, "dpop", device="cpu")
        assert out["cost"] == pytest.approx(dpop["cost"], abs=1e-9)


@pytest.mark.parametrize("algo", ["syncbb", "ncbb"])
@pytest.mark.parametrize("seed,extra", [(0, 0), (1, 0), (2, 0), (3, 4),
                                        (4, 4)])
def test_random_problems_equal_reference_and_dpop(seed, extra, algo):
    jax_dcop, torch_dcop = both(random_dcop, 10 if extra == 0 else 9, 3,
                                seed, extra_edges=extra, integer=True)
    ref = japi.solve(jax_dcop, algo)
    out = tapi.solve(torch_dcop, algo, device="cpu")
    _same_result(out, ref)
    dpop = tapi.solve(torch_dcop, "dpop", device="cpu")
    assert out["cost"] == dpop["cost"]


@pytest.mark.parametrize("algo", ["syncbb", "ncbb"])
def test_cli_and_missing_card(algo):
    path = os.path.join(INSTANCES, "coloring_chain.yaml")
    outs = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["solve", "--algo", algo, *extra, path])
        assert rc in (0, None)
        outs.append(json.loads(buf.getvalue()))
    ref, out = outs
    assert sorted(out) == sorted(ref)
    for key in ref:
        if key not in ("time", "compile_time"):
            assert out[key] == ref[key], key
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, torch_dcop = load_both("coloring_chain.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.solve(torch_dcop, algo)
