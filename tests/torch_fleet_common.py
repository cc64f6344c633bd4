"""Helpers shared by the port's fleet tests
(``tests/test_torch_fleet_*.py``): a two-worker CPU fleet whose
workers inherit nothing of the suite's shared state, and polls with a
deadline.

A fleet's workers are processes: they inherit this process's
environment.  ``cpu_fleet`` gives them a private autotune cache (the
pack model's persisted fit included), flight-bundle directory, journal
and kernel-library directory under one temporary directory, and
``OMP_NUM_THREADS=1`` so that they do not compete with the other test
processes for every core.
"""

import contextlib
import time

import pytest

import torch_serving_common as common


@contextlib.contextmanager
def cpu_fleet(tmp, **serve_kw):
    """``api.serve(port=0, replicas=2, device="cpu", ...)`` under
    :func:`torch_serving_common.isolated` with the workers' private
    environment; yields the handle and stops it (with drain) after."""
    from pydcop_tpu_torch import api

    with pytest.MonkeyPatch.context() as mp, common.isolated(mp, tmp):
        mp.setenv("PYDCOP_FLIGHT_DIR", str(tmp / "bundles"))
        mp.setenv("OMP_NUM_THREADS", "1")
        serve_kw.setdefault("journal_dir", str(tmp / "journal"))
        serve_kw.setdefault("compile_cache_dir", str(tmp / "kernels"))
        serve_kw.setdefault("heartbeat_s", 0.2)
        handle = api.serve(port=0, replicas=2, device="cpu", **serve_kw)
        try:
            yield handle
        finally:
            handle.summary = handle.stop()


def poll(fn, timeout: float, every: float = 0.05, what: str = ""):
    """Call ``fn`` until it returns something truthy; fail after
    ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        out = fn()
        if out:
            return out
        if time.monotonic() > deadline:
            pytest.fail(f"timed out after {timeout} s waiting for "
                        f"{what or fn}")
        time.sleep(every)


def await_result(url: str, rid: str, timeout: float = 120):
    """A router-minted request's result through the router: 202
    (pending) and 503 (its replica restarting) are polled out."""
    def done():
        code, body = common.http(url + f"/result/{rid}", timeout=60)
        return None if code in (202, 503) else (code, body)

    return poll(done, timeout, what=f"result {rid}")
