"""``python -m pydcop_tpu_torch batch`` (pydcop_tpu_torch/commands/batch.py)
against the JAX package's ``pydcop batch`` machinery, after
``tests/unit/test_batch_battery.py``.

Tolerance: none.  The job expansion (sets, iterations, file globs,
option sweeps, variable expansion, global options, current_dir) gives
the reference's job list, argument for argument; the progress file
reads and writes the same lines; ``--simulate`` prints one line per job
without running it; a real batch runs each job as ``python -m
pydcop_tpu_torch``, records it in ``progress_<file>``, skips it on a
restart and renames the file ``done_<file>`` when every job succeeded.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import pydcop_tpu.commands.batch as JB
import pydcop_tpu_torch.commands.batch as TB


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(REPO, "tests", "instances")


def _definitions(tmp_path):
    for n in ("p1.yaml", "p2.yaml"):
        (tmp_path / n).write_text("x")
    return [
        {"sets": {"s": {"iterations": 3}},
         "batches": {"b": {"command": "solve"}}},
        {"sets": {"s": {"path": str(tmp_path / "*.yaml")}},
         "batches": {"b": {"command": "solve",
                           "command_options": {
                               "output": "{file_name}_out.json"}}}},
        {"sets": {"s": {"path": str(tmp_path)}},
         "batches": {"b": {"command": "solve"}}},
        {"sets": {"s": {"iterations": 1, "env": {"tag": "v9"}}},
         "batches": {"b": {"command": "solve",
                           "command_options": {"output": "{tag}.json"}}}},
        {"global_options": {"timeout": 10},
         "sets": {"s": {"iterations": 1}},
         "batches": {"b": {"command": "solve",
                           "global_options": {"timeout": 99}}}},
        {"sets": {"s": {"iterations": 1}},
         "batches": {"b": {"command": "solve", "command_options": {
             "algo": ["dsa", "mgm"],
             "algo_params": {"variant": ["A", "B"], "seed": 0}}}}},
        {"sets": {"s": {"iterations": 2}},
         "batches": {"b1": {"command": "solve"},
                     "b2": {"command": "graph"}}},
        {"batches": {"b": {"command": "solve"}}},
        {"sets": {"s": {"iterations": 1,
                        "env": {"d": str(tmp_path / "run")}}},
         "batches": {"b": {"command": "solve", "current_dir": "{d}"}}},
    ]


def test_jobs_equal_reference(tmp_path):
    for definition in _definitions(tmp_path):
        assert (list(TB.iter_jobs(definition))
                == list(JB.iter_jobs(definition)))


@pytest.mark.parametrize("options", [
    {}, {"a": 1, "b": "x"}, {"algo": ["dsa", "mgm"]},
    {"a": [1, 2], "b": ["x", "y"]},
    {"algo_params": {"variant": ["A", "B"], "seed": 0}},
])
def test_option_combinations_equal_reference(options):
    assert (TB._expand_option_combinations(options)
            == JB._expand_option_combinations(options))


@pytest.mark.parametrize("template,context", [
    ("run_{set}_{iteration}", {"set": "s1", "iteration": 3}),
    ("{nope}", {}), ("{opts[k]}", {"opts": {"k": "v"}}),
])
def test_expand_equals_reference(template, context):
    assert TB._expand(template, context) == JB._expand(template, context)


def test_progress_file_equals_reference(tmp_path):
    for mod, name in ((TB, "port"), (JB, "ref")):
        pf = str(tmp_path / f"progress_{name}")
        mod._register_job(pf, "job one")
        mod._register_job(pf, "job two")
    port = (tmp_path / "progress_port").read_text()
    assert port == (tmp_path / "progress_ref").read_text()
    assert TB._load_progress(str(tmp_path / "progress_port")) == \
        {"job one", "job two"}
    (tmp_path / "blank").write_text("a\n\n  \nb\n")
    assert TB._load_progress(str(tmp_path / "blank")) == {"a", "b"}
    assert TB._load_progress(str(tmp_path / "nope")) == set()


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "pydcop_tpu_torch", "batch"]
                          + args, capture_output=True, text=True, env=env,
                          cwd=cwd, timeout=300)


def _write_batch(tmp_path, algos):
    import yaml

    definition = {
        "sets": {"fixtures": {"path": os.path.join(
            INSTANCES, "coloring_12_3.yml")}},
        "batches": {"solve": {
            "command": "solve",
            "command_options": {"algo": algos, "cycles": 30,
                                "device": "cpu"},
            "current_dir": str(tmp_path / "out"),
        }},
    }
    path = tmp_path / "bench.yaml"
    path.write_text(yaml.safe_dump(definition))
    return path, definition


def test_simulate_prints_the_jobs_and_runs_nothing(tmp_path):
    path, definition = _write_batch(tmp_path, ["maxsum", "dsa"])
    proc = _cli(["--simulate", str(path)], tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    jobs = list(TB.iter_jobs(definition))
    assert lines == ["python -m pydcop_tpu_torch " + " ".join(args)
                     for args, _, _ in jobs]
    assert not (tmp_path / "progress_bench.yaml").exists()
    assert not (tmp_path / "out").exists()


def test_batch_runs_each_job_and_resumes(tmp_path):
    path, definition = _write_batch(tmp_path, ["maxsum", "dsa"])
    jobs = list(TB.iter_jobs(definition))
    # One job already done: a restart skips it.
    (tmp_path / "progress_bench.yaml").write_text(jobs[1][2] + "\n")
    proc = _cli([str(path)], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert not (tmp_path / "progress_bench.yaml").exists()
    done = (tmp_path / "done_bench.yaml").read_text().splitlines()
    assert done == [jobs[1][2], jobs[0][2]]
    assert (tmp_path / "out").is_dir()


def test_a_failing_job_keeps_the_progress_file(tmp_path):
    path, definition = _write_batch(tmp_path, ["maxsum", "no_such_algo"])
    proc = _cli([str(path)], tmp_path)
    assert proc.returncode == 1
    assert "1 failed job" in proc.stdout
    progress = (tmp_path / "progress_bench.yaml").read_text().splitlines()
    assert progress == [list(TB.iter_jobs(definition))[0][2]]


def test_a_solve_job_prints_the_solve_result(tmp_path):
    """What a job runs: the port's own ``solve`` on the CPU."""
    path, definition = _write_batch(tmp_path, ["maxsum"])
    args, _, _ = list(TB.iter_jobs(definition))[0]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "pydcop_tpu_torch"] + args,
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["cycle"] == 30
