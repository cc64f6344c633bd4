"""``python -m pydcop_tpu_torch generate ...`` and ``graph ...`` against
the reference CLI (``pydcop_tpu.dcop_cli``), on the CPU.

Both CLIs run in this process (their ``main``), with the same
arguments: every ``generate`` subcommand must write the reference's
text byte for byte (stdout, ``--output`` and the Ising distribution
files), and ``graph`` must print the reference's JSON, exit codes and
error lines.  The cases are the ``generate`` cases of
``tests/cli/test_cli_generate_distribute.py`` and the ``graph`` cases
of ``test_cli_graph_consolidate.py`` and ``test_cli_errors.py``, with
more arguments.  One subprocess runs the port's CLI with networkx
hidden: neither command may need it.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from pydcop_tpu import dcop_cli as jcli
from pydcop_tpu_torch import dcop_cli as tcli

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
INSTANCES = os.path.join(HERE, "instances")
CHAIN = os.path.join(INSTANCES, "coloring_chain.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run(cli, args):
    """(exit code, stdout, stderr) of one in-process CLI run."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli.main(args)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def run_both(args):
    ref = run(jcli, args)
    port = run(tcli, args)
    return ref, port


GENERATE_CASES = [
    ["graph_coloring", "-v", "12", "-c", "3", "-g", "random", "-p", "0.3",
     "--seed", "1", "--allow_subgraph"],
    ["graph_coloring", "-v", "20", "-c", "4", "-g", "scalefree", "-m", "2",
     "--soft", "--seed", "3"],
    ["graph_coloring", "-v", "9", "-c", "3", "-g", "grid", "--intentional",
     "--noagents"],
    ["graph_coloring", "-v", "100", "-c", "3", "-g", "scalefree", "-m",
     "2", "--seed", "0"],
    ["ising", "--row_count", "3", "--col_count", "3", "--seed", "0"],
    ["ising", "--row_count", "2", "--col_count", "4", "--bin_range", "2.5",
     "--un_range", "0.1", "--intentional", "--seed", "4"],
    ["ising", "--row_count", "3", "--no_agents", "--seed", "2"],
    ["meetings", "--slots_count", "4", "--events_count", "3",
     "--resources_count", "3", "--max_resources_event", "2", "--seed", "0"],
    ["meetings", "--slots_count", "5", "--events_count", "6",
     "--resources_count", "4", "--max_resources_event", "3",
     "--max_length_event", "2", "--max_resource_value", "4",
     "--capacity", "30", "--seed", "8"],
    ["meetings", "--slots_count", "3", "--events_count", "2",
     "--resources_count", "2", "--max_resources_event", "1", "--no_agents",
     "--seed", "1"],
    ["secp", "--lights", "4", "--models", "2", "--rules", "2", "--seed",
     "3"],
    ["secp", "-l", "8", "-m", "3", "-r", "4", "-c", "40",
     "--max_model_size", "4", "--max_rule_size", "2", "--seed", "5"],
    ["iot", "-n", "15", "--seed", "0"],
    ["iot", "-n", "10", "-d", "4", "-m", "1", "-r", "6", "--seed", "2"],
    ["small_world", "-n", "12", "--seed", "0"],
    ["small_world", "-n", "16", "-d", "3", "-k", "6", "-p", "0.4", "-r",
     "5", "--seed", "7"],
    ["agents", "--mode", "count", "--count", "5", "--capacity", "50"],
    ["agents", "--mode", "count", "--count", "11", "--capacity", "5",
     "--agent_prefix", "ag", "--routes", "uniform", "--routes_default",
     "3"],
    ["agents", "--mode", "variables", "--capacity", "10", "--hosting",
     "name_mapping", "--hosting_default", "100", "--dcop_files", CHAIN],
    ["agents", "--mode", "variables", "--capacity", "10", "--routes",
     "graph", "--routes_default", "8", CHAIN],
    ["agents", "--mode", "count", "--count", "4", "--capacity", "10",
     "--hosting", "var_startswith", "--hosting_default", "5",
     "--dcop_files", CHAIN],
    ["scenario", "--evts_count", "3", "--actions_count", "1", "--delay",
     "2", "--initial_delay", "1", "--seed", "0", "--dcop_files",
     os.path.join(INSTANCES, "coloring_4agents_10vars.yaml")],
    ["scenario", "--evts_count", "2", "--actions_count", "2", "--delay",
     "1.5", "--end_delay", "4", "--seed", "3",
     os.path.join(INSTANCES, "coloring_12_3.yml")],
]


@pytest.mark.parametrize("args", GENERATE_CASES,
                         ids=[f"{a[0]}-{i}" for i, a in
                              enumerate(GENERATE_CASES)])
def test_generate_writes_the_reference_text(args):
    ref, port = run_both(["generate"] + args)
    assert ref[0] == 0 and ref[1]
    assert port == ref


def test_generate_to_an_output_file(tmp_path):
    args = ["generate", "secp", "-l", "5", "-m", "2", "-r", "3", "--seed",
            "1"]
    texts = []
    for cli, name in ((jcli, "ref.yaml"), (tcli, "port.yaml")):
        path = tmp_path / name
        rc, out, _ = run(cli, ["--output", str(path)] + args)
        assert (rc, out) == (0, "")
        texts.append(path.read_text(encoding="utf-8"))
    assert texts[0] == texts[1]


def test_generate_ising_distribution_files(tmp_path):
    outputs = []
    for cli, name in ((jcli, "ref"), (tcli, "port")):
        d = tmp_path / name
        d.mkdir()
        res = run(cli, ["generate", "ising", "--row_count", "3",
                        "--col_count", "2", "--fg_dist", "--var_dist",
                        "--dist_dir", str(d), "--seed", "5"])
        files = sorted(os.listdir(d))
        outputs.append((res, files, [(d / f).read_text(encoding="utf-8")
                                     for f in files]))
    assert outputs[0] == outputs[1]
    assert outputs[1][1] == ["Ising_3_2_1.6_0.05_fgdist.yaml",
                             "Ising_3_2_1.6_0.05_vardist.yaml"]


@pytest.mark.parametrize("args", [
    ["generate"],
    ["generate", "scenario", "--evts_count", "1", "--actions_count", "1",
     "--delay", "1"],
    ["generate", "graph_coloring", "-v", "10", "-c", "3", "-g", "random"],
    ["generate", "graph_coloring", "-v", "10", "-c", "3", "-g", "grid"],
    ["generate", "agents", "--mode", "count", "--capacity", "3"],
    ["generate", "agents", "--mode", "count", "--count", "3",
     "--capacity", "3", "--hosting", "name_mapping"],
    ["generate", "scenario", "--evts_count", "1", "--actions_count", "1",
     "--delay", "1", "--dcop_files", "/nonexistent/x.yaml"],
])
def test_generate_errors_equal_the_reference(args):
    ref, port = run_both(args)
    assert ref[0] != 0
    assert port[0] == ref[0]
    assert port[2] == ref[2]
    if args != ["generate"]:
        assert port[1] == ref[1]


GRAPH_CASES = [
    ["-g", "factor_graph", CHAIN],
    ["-a", "dsa", CHAIN],
    ["-g", "constraints_hypergraph", CHAIN],
    ["-a", "maxsum", CHAIN],
    ["-a", "amaxsum", os.path.join(INSTANCES, "coloring_12_3.yml")],
    ["-a", "maxsum_dynamic", os.path.join(INSTANCES, "secp_lamps.yaml")],
    ["-g", "pseudotree", os.path.join(INSTANCES, "coloring_12_3.yml")],
    ["-a", "syncbb", os.path.join(INSTANCES, "pref_ring.yaml")],
    ["-g", "factor_graph", os.path.join(INSTANCES, "loft_scene.yml")],
    ["-a", "mgm", "--display",
     os.path.join(INSTANCES, "coloring_ext_costs.yaml")],
]


@pytest.mark.parametrize("args", GRAPH_CASES)
def test_graph_prints_the_reference_json(args):
    ref, port = run_both(["graph"] + args)
    assert ref[0] == 0
    assert port == ref
    assert json.loads(port[1])["nodes"] > 0


@pytest.mark.parametrize("algo", ["maxsum", "dsa", "dpop"])
def test_graph_of_a_generated_file(tmp_path, algo):
    """``generate`` then ``graph`` on the file the port wrote, as the
    card's CLI leg runs them."""
    path = tmp_path / "gc.yaml"
    rc, _, _ = run(tcli, ["--output", str(path), "generate",
                          "graph_coloring", "-v", "100", "-c", "3", "-g",
                          "scalefree", "-m", "2", "--seed", "0"])
    assert rc == 0
    ref, port = run_both(["graph", "-a", algo, str(path)])
    assert port == ref
    res = json.loads(port[1])
    if algo == "maxsum":
        assert res["graph"] == "factor_graph"
        assert res["nodes"] == res["variables"] + res["constraints"]
        assert res["edges"] == 2 * res["constraints"]


@pytest.mark.parametrize("args", [
    ["graph", "--graph", "nosuchgraph", CHAIN],
    ["graph", "-a", "nosuchalgo", CHAIN],
    ["graph", CHAIN],
    ["graph", "-g", "factor_graph", "/nonexistent/x.yaml"],
])
def test_graph_errors_equal_the_reference(args):
    ref, port = run_both(args)
    assert ref[0] != 0
    assert port == ref
    assert "Traceback" not in port[2]


def test_generate_and_graph_run_without_networkx(tmp_path):
    """A fresh interpreter with networkx hidden imports the CLI and both
    commands, generates a problem and describes its graph; the text
    equals the reference's."""
    path = tmp_path / "iot.yaml"
    probe = (
        "import sys\n"
        "sys.modules['networkx'] = None\n"
        "import pydcop_tpu_torch.commands.generate\n"
        "import pydcop_tpu_torch.commands.graph\n"
        "import pydcop_tpu_torch.utils.graphs\n"
        "from pydcop_tpu_torch import dcop_cli\n"
        f"rc = dcop_cli.main(['--output', {str(path)!r}, 'generate', "
        "'iot', '-n', '30', '--seed', '4'])\n"
        "assert rc == 0, rc\n"
        f"rc = dcop_cli.main(['graph', '-a', 'maxsum', {str(path)!r}])\n"
        "assert rc == 0, rc\n"
        "assert sys.modules['networkx'] is None\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONHASHSEED="0",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    ref = run(jcli, ["generate", "iot", "-n", "30", "--seed", "4"])
    assert path.read_text(encoding="utf-8") == ref[1]
    want = run(jcli, ["graph", "-a", "maxsum", str(path)])
    assert proc.stdout == want[1]
