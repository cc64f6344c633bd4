"""Accelerator-probe diagnostics and the CUDA liveness guard.

Port of the diagnostic half of ``pydcop_tpu/utils/cleanenv.py``
(:func:`record_diag`, :func:`diag_events`, :func:`probelog_tail`, the
probe-failure classification and its mirror into the metrics registry
and the tracer), with the reference's event shapes and environment
variables, so one reader serves both packages' logs.

:func:`ensure_live_backend` is the torch counterpart of the
reference's guard: it checks, in a child process with a timeout, that
CUDA initialises and that one tiny launch completes.  A card that
hangs at init (a wedged CUDA stack) or fails cannot then hang or crash
the caller mid-solve.  On failure it records the diagnostic event and
RAISES: the port has no CPU fallback, so the reference's
``cpu_fallback_exec`` and ``scrubbed_cpu_env`` are not ported.

No torch import here: the probe runs in a child interpreter.
"""

import json
import os
import time

# Probe-diagnostic event log, carried in the environment to child
# processes (the reference's variable).
DIAG_ENV = "PYDCOP_BENCH_DIAG"
# Probe timeout override (seconds).
PROBE_TIMEOUT_ENV = "PYDCOP_BENCH_PROBE_TIMEOUT"
# On-disk probe history: one record_diag-shaped JSON object per line.
PROBELOG_ENV = "PYDCOP_PROBELOG"
PROBELOG_DEFAULT = "BENCH_TPU_PROBELOG.jsonl"

# What the child runs: CUDA init and one tiny launch, synchronised.
_PROBE_SRC = (
    "import torch\n"
    "assert torch.cuda.is_available(), 'torch.cuda.is_available() is "
    "False'\n"
    "x = torch.ones(8, device='cuda')\n"
    "torch.cuda.synchronize()\n"
    "assert float((x + x).sum()) == 16.0\n"
    "print(torch.cuda.get_device_name(0))\n"
)


def default_probe_timeout(default=120.0):
    """The probe timeout in seconds: ``PYDCOP_BENCH_PROBE_TIMEOUT``
    when set (and parseable, and positive), else ``default``."""
    raw = os.environ.get(PROBE_TIMEOUT_ENV)
    if raw is None:
        return default
    try:
        value = float(raw)
    except ValueError:
        return default
    return value if value > 0 else default


def _probe_failure_reason(error):
    """Short label for the failure-counter: 'timeout' vs 'init_error'
    (non-zero exit / import crash)."""
    if error and str(error).startswith("timeout"):
        return "timeout"
    return "init_error"


def is_probe_failure(event):
    """Whether a diagnostic event (a ``diag_events()`` row, or a
    (kind, details) pair flattened into one dict) records a probe /
    supervision FAILURE: the one classification shared by the metrics
    mirror and the ``/healthz`` accelerator_probe body."""
    kind = str(event.get("event", ""))
    return (
        kind in ("cpu_fallback", "child_timeout", "child_failed",
                 "backend_unavailable")
        or (kind.endswith("probe") and event.get("ok") is False)
    )


def _observe_probe_event(kind, details):
    """Mirror a diagnostic event into the observability plane: failed
    probes count in ``pydcop_bench_probe_failures_total{reason}`` and
    every event is a ``bench_probe`` trace instant while tracing is on.
    Not gated on ``registry.active``: the CLI probes before the solve
    opens its session."""
    try:
        from pydcop_tpu_torch.observability.metrics import registry
        from pydcop_tpu_torch.observability.trace import tracer
    except Exception:  # noqa: BLE001
        return
    failed = is_probe_failure({"event": kind, **details})
    if failed:
        reason = (kind if not kind.endswith("probe")
                  else _probe_failure_reason(details.get("error")))
        registry.counter(
            "pydcop_bench_probe_failures_total",
            "Accelerator probe / bench supervision failures by reason",
        ).inc(reason=reason)
    if tracer.enabled:
        tracer.instant("bench_probe", "bench", kind=kind, **details)


def diag_events():
    """Accumulated probe events ([] when none)."""
    try:
        events = json.loads(os.environ.get(DIAG_ENV, "[]"))
        return events if isinstance(events, list) else []
    except (ValueError, TypeError):
        return []


def record_diag(kind, **details):
    """Append an event to the in-env diagnostic log and return the
    full log (timestamps in unix seconds); the event is also mirrored
    into the metrics registry and the tracer."""
    events = diag_events()
    events.append({"unix": round(time.time(), 1), "event": kind,
                   **details})
    os.environ[DIAG_ENV] = json.dumps(events)
    _observe_probe_event(kind, details)
    return events


def probelog_path():
    """The probe history file: ``PYDCOP_PROBELOG`` when set, else the
    reference's ``BENCH_TPU_PROBELOG.jsonl`` in the current directory.
    Returns the path whether or not it exists."""
    return os.environ.get(PROBELOG_ENV, PROBELOG_DEFAULT)


def probelog_tail(n=20, path=None):
    """The last ``n`` rows of the on-disk probe history.  Unparsable
    lines are skipped, a missing file is an empty list: this feeds
    postmortem bundles, which must never fail on their own evidence."""
    path = path or probelog_path()
    rows = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if isinstance(row, dict):
                    rows.append(row)
    except OSError:
        return []
    return rows[-max(int(n), 0):]


def probe_backend(timeout=120, env=None):
    """One child-process probe: CUDA init plus one tiny launch.

    Returns (ok, error, seconds): error is None on success, else a
    short string ("timeout after Ns" / "exit <rc>: <stderr tail>")."""
    import subprocess
    import sys

    t0 = time.time()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _PROBE_SRC],
            timeout=timeout, capture_output=True, text=True, env=env,
        )
    except subprocess.TimeoutExpired:
        return False, f"timeout after {timeout}s", time.time() - t0
    dt = time.time() - t0
    if proc.returncode != 0:
        tail = (proc.stderr or "").strip().splitlines()[-1:]
        return False, f"exit {proc.returncode}: {' '.join(tail)[:200]}", dt
    return True, None, dt


def probe_with_retries(tag, retries, probe_timeout=None, backoff=10.0):
    """Probe up to ``retries`` times with ``backoff`` seconds between
    failures, recording every attempt.  Returns True when a probe
    succeeds.  ``probe_timeout=None`` resolves through
    ``PYDCOP_BENCH_PROBE_TIMEOUT`` (default 120 s)."""
    import sys

    if probe_timeout is None:
        probe_timeout = default_probe_timeout()
    for attempt in range(retries):
        ok, error, dt = probe_backend(probe_timeout)
        record_diag(
            "probe", tag=tag, attempt=attempt + 1, of=retries,
            ok=ok, error=error, seconds=round(dt, 1),
        )
        if ok:
            return True
        print(
            f"{tag}: CUDA probe {attempt + 1}/{retries} failed "
            f"({error})", file=sys.stderr,
        )
        if attempt < retries - 1:
            time.sleep(backoff)
    return False


def ensure_live_backend(tag="cli", retries=1, probe_timeout=None,
                        backoff=10.0):
    """Raise RuntimeError unless CUDA initialises and a tiny launch
    completes in a child process (``retries`` attempts, ``backoff``
    seconds apart).  The failure is recorded (a ``backend_unavailable``
    event after the failed ``probe`` events) before raising; there is
    no CPU fallback."""
    if probe_with_retries(tag, retries, probe_timeout, backoff):
        return
    record_diag("backend_unavailable", tag=tag)
    last = [e for e in diag_events() if e.get("event") == "probe"]
    raise RuntimeError(
        f"{tag}: the CUDA device did not initialise or run a tiny "
        f"launch ({last[-1].get('error') if last else 'no probe'}); "
        "pass --device cpu to run on the CPU")
