"""``python -m pydcop_tpu_torch batch``: run benchmark sweeps defined in
a YAML file (port of ``pydcop_tpu/commands/batch.py``; each job runs
``python -m pydcop_tpu_torch``).

Reference parity: pydcop/commands/batch.py (run_batches :149, progress
registration :501, ``--simulate``) and the format spec
docs/usage/file_formats/batch_format.yaml:

- ``sets``: named problem sets — a ``path`` glob of input files and/or
  an ``iterations`` count, plus optional ``env`` expansion variables;
- ``batches``: named commands — ``command`` (e.g. ``solve``),
  ``command_options`` (scalars, lists = cartesian sweep, dicts =
  repeated ``name:value`` options), ``global_options`` and an optional
  ``current_dir``;
- variable expansion in option strings: {set}, {batch}, {iteration},
  {file_path}, {dir_path}, {file_basename}, {file_name}, the set's
  ``env`` entries and every command-option name.

Jobs that ran without error are appended to a ``progress_<name>`` file
next to the definition file; on restart those jobs are skipped, which
makes interrupted batches resumable.  ``--simulate`` prints the
commands without running them.
"""

import itertools
import glob
import logging
import os
import subprocess
import sys
from typing import Dict, List, Tuple

import yaml

logger = logging.getLogger("pydcop_tpu_torch.cli.batch")


def set_parser(subparsers):
    parser = subparsers.add_parser(
        "batch", help="run benchmark batches from a yaml definition")
    parser.add_argument("bench_file", help="batches definition file")
    parser.add_argument("--simulate", action="store_true", default=False,
                        help="print the commands without running them")
    parser.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    with open(args.bench_file, encoding="utf-8") as f:
        definition = yaml.safe_load(f)
    progress_file = os.path.join(
        os.path.dirname(os.path.abspath(args.bench_file)),
        "progress_" + os.path.basename(args.bench_file),
    )
    done = _load_progress(progress_file)
    jobs = list(iter_jobs(definition))
    logger.info("%d jobs in batch (%d already done)", len(jobs),
                len(done))
    failures = 0
    for cli_args, current_dir, job_id in jobs:
        if job_id in done:
            continue
        display = "python -m pydcop_tpu_torch " + " ".join(cli_args)
        if args.simulate:
            print(display)
            continue
        logger.info("Running: %s", display)
        if current_dir:
            os.makedirs(current_dir, exist_ok=True)
        try:
            subprocess.run(
                [sys.executable, "-m", "pydcop_tpu_torch"]
                + cli_args,
                cwd=current_dir or None,
                check=True,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
        except subprocess.CalledProcessError as e:
            failures += 1
            logger.error("Job failed (rc %s): %s", e.returncode, display)
            continue
        _register_job(progress_file, job_id)
    if args.simulate:
        return 0
    if failures:
        print(f"batch finished with {failures} failed job(s)")
        return 1
    # Complete: mark the progress file as done (reference renames it).
    if os.path.exists(progress_file):
        os.replace(
            progress_file,
            progress_file.replace("progress_", "done_", 1),
        )
    return 0


def iter_jobs(definition: Dict):
    """Yield (cli_args, current_dir, job_id) for every job of the
    batch definition."""
    sets = definition.get("sets", {"default": {"iterations": 1}})
    batches = definition.get("batches", {})
    global_options = definition.get("global_options", {})
    for set_name, set_def in sets.items():
        set_def = set_def or {}
        iterations = int(set_def.get("iterations", 1))
        env = set_def.get("env", {}) or {}
        files: List[List[str]] = []
        if "path" in set_def:
            path = os.path.expanduser(set_def["path"])
            if os.path.isdir(path):
                path = os.path.join(path, "*")
            files = [[f] for f in sorted(glob.glob(path))]
        else:
            files = [[]]
        for file_group in files:
            for iteration in range(iterations):
                context = dict(env)
                context.update({
                    "set": set_name,
                    "iteration": iteration,
                })
                if file_group:
                    fp = file_group[0]
                    context.update({
                        "file_path": fp,
                        "dir_path": os.path.dirname(fp),
                        "file_basename": os.path.basename(fp),
                        "file_name": os.path.splitext(
                            os.path.basename(fp))[0],
                    })
                for batch_name, batch_def in batches.items():
                    yield from _batch_jobs(
                        batch_name, batch_def, context, file_group,
                        global_options,
                    )


def _batch_jobs(batch_name: str, batch_def: Dict, context: Dict,
                file_group: List[str], global_options: Dict):
    command = batch_def.get("command", "solve")
    command_options = batch_def.get("command_options", {}) or {}
    batch_globals = dict(global_options)
    batch_globals.update(batch_def.get("global_options", {}) or {})
    context = dict(context)
    context["batch"] = batch_name
    for combo in _expand_option_combinations(command_options):
        job_context = dict(context)
        for name, value in combo:
            # dicts stay dicts so "{opts[key]}" expansion works.
            job_context[name] = value
        cli_args: List[str] = []
        for name, value in sorted(batch_globals.items()):
            cli_args += ["--" + name, _expand(str(value), job_context)]
        cli_args += command.split()
        for name, value in combo:
            if isinstance(value, dict):
                for k, v in value.items():
                    cli_args += [
                        "--" + name,
                        f"{k}:{_expand(str(v), job_context)}",
                    ]
            else:
                cli_args += [
                    "--" + name, _expand(str(value), job_context)
                ]
        cli_args += file_group
        current_dir = batch_def.get("current_dir")
        if current_dir:
            current_dir = os.path.expanduser(
                _expand(current_dir, job_context))
        job_id = " ".join(cli_args) + f" #it{job_context['iteration']}"
        yield cli_args, current_dir, job_id


def _expand_option_combinations(options: Dict) -> List[List[Tuple]]:
    """Cartesian product over list-valued options (reference batch
    sweep semantics); dict values sweep over their list-valued
    entries."""
    axes = []
    for name, value in sorted(options.items()):
        if isinstance(value, list):
            axes.append([(name, v) for v in value])
        elif isinstance(value, dict):
            sub_axes = []
            for k, v in sorted(value.items()):
                if isinstance(v, list):
                    sub_axes.append([(k, sv) for sv in v])
                else:
                    sub_axes.append([(k, v)])
            axes.append([
                (name, dict(sub_combo))
                for sub_combo in itertools.product(*sub_axes)
            ])
        else:
            axes.append([(name, value)])
    return [list(combo) for combo in itertools.product(*axes)]


def _expand(template: str, context: Dict) -> str:
    try:
        return template.format(**context)
    except (KeyError, IndexError):
        return template


def _load_progress(progress_file: str) -> set:
    if not os.path.exists(progress_file):
        return set()
    with open(progress_file, encoding="utf-8") as f:
        return {line.rstrip("\n") for line in f if line.strip()}


def _register_job(progress_file: str, job_id: str):
    with open(progress_file, "a", encoding="utf-8") as f:
        f.write(job_id + "\n")
