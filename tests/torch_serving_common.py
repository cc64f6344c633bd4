"""Helpers shared by the serving parity tests
(``tests/test_torch_serving_parity.py``, ``test_torch_journal.py``,
``test_torch_session_parity.py``): the same request stream through
the JAX package's ``SolveService`` and the port's
``SolveService(device="cpu")``.

Problems travel as dcop yaml text (what the wire carries), built once
with ``chip_smoke.py``'s copies of ``bench.py``'s instance builders and
loaded by each package's own ``load_dcop``.
"""

import contextlib
import copy
import json
import os
import sys
import urllib.error
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402
import pydcop_tpu_torch.dcop.dcop as port_dcop  # noqa: E402
import pydcop_tpu_torch.dcop.objects as port_objects  # noqa: E402
import pydcop_tpu_torch.dcop.relations as port_relations  # noqa: E402
from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml  # noqa: E402

PACKAGES = ("jax", "torch")

# Result keys that hold ids or timings: everything else must match.
VOLATILE = ("id", "session_id", "trace_id", "latency", "ledger",
            "result_url", "events_url")


@contextlib.contextmanager
def isolated(monkeypatch, tmp_path):
    """A serving test leaves nothing behind in its worker process:
    both packages' dispatch caches start empty, the autotune cache
    (portfolio decisions and the pack model's persisted fit) is a
    private file, and both packages' in-memory pack-model fit — fed by
    every warm dispatch's measured time — starts empty and is restored
    as found afterwards, so no test's timings move another's pack
    decisions.  (CPU test files only: it imports the JAX package.)"""
    import pydcop_tpu.engine.autotune as reference_autotune
    import pydcop_tpu.engine.batch as reference_batch
    import pydcop_tpu_torch.engine.autotune as port_autotune
    import pydcop_tpu_torch.engine.batch as port_batch

    reference_batch._warm.clear()
    port_batch._warm.clear()
    monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    saved = []
    for mod in (reference_autotune, port_autotune):
        with mod._packfit_lock:
            saved.append((mod, copy.deepcopy(mod._packfit_state),
                          dict(mod._packfit_dirty)))
            mod._packfit_state.clear()
            mod._packfit_dirty.clear()
    try:
        yield
    finally:
        for mod, state, dirty in saved:
            with mod._packfit_lock:
                mod._packfit_state.clear()
                mod._packfit_state.update(state)
                mod._packfit_dirty.clear()
                mod._packfit_dirty.update(dirty)


def small_yaml(n_vars: int, seed: int) -> str:
    """bench.py ``build_dcop_small`` as yaml."""
    return dcop_yaml(chip_smoke.build_dcop_small(
        port_objects, port_relations, port_dcop, n_vars, seed))


def mixed_yaml(struct_idx: int, seed: int) -> str:
    """bench.py ``build_dcop_mixed`` (one of its 24 structures) as
    yaml."""
    return dcop_yaml(chip_smoke.build_dcop_mixed(
        port_objects, port_relations, port_dcop, struct_idx, seed))


def ring_yaml(n: int, seed: int, chords: int = 0, d: int = 3) -> str:
    """A ring of ``n`` variables with ``chords`` half-way chords and
    random integer tables over ``d`` values."""
    rng = np.random.default_rng(seed)
    dom = port_objects.Domain("c", "", list(range(d)))
    dcop = port_dcop.DCOP(f"ring{n}_{chords}_{seed}", objective="min")
    vs = [port_objects.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    edges = [(i, (i + 1) % n) for i in range(n)]
    edges += [(i, (i + n // 2) % n) for i in range(chords)]
    for k, (i, j) in enumerate(edges):
        table = rng.integers(0, 10, size=(d, d)).astype(float)
        dcop.add_constraint(port_relations.NAryMatrixRelation(
            [vs[i], vs[j]], table, f"c{k}"))
    dcop.add_agents([port_objects.AgentDef("a0")])
    return dcop_yaml(dcop)


def load(pkg: str, yaml_src: str):
    if pkg == "jax":
        from pydcop_tpu.dcop.yamldcop import load_dcop
    else:
        from pydcop_tpu_torch.dcop.yamldcop import load_dcop
    return load_dcop(yaml_src)


def service_class(pkg: str):
    if pkg == "jax":
        from pydcop_tpu.serving.service import SolveService
    else:
        from pydcop_tpu_torch.serving.service import SolveService
    return SolveService


def make_service(pkg: str, **kw):
    """The package's SolveService (the port's on the CPU), not
    started."""
    if pkg == "torch":
        kw["device"] = "cpu"
    return service_class(pkg)(**kw)


def serve_stream(pkg: str, yamls, params=None, **service_kw):
    """Submit every problem (each loaded by ``pkg``'s loader first) to
    a fresh service and stop it with drain; returns ``(results,
    stats)``.  By default the batch window never expires, so the whole
    stream is collected into ONE flush, which the scheduler dispatches
    when the stop ends its window: the flush's composition does not
    depend on how fast the host submits."""
    service_kw.setdefault("batch_window_s", 3600.0)
    service_kw.setdefault("max_batch", 16)
    service_kw.setdefault("speculate", False)
    dcops = [load(pkg, y) for y in yamls]
    svc = make_service(pkg, **service_kw).start()
    try:
        ids = [svc.submit(dcop, params=dict(params or {}))
               for dcop in dcops]
    finally:
        svc.stop(drain=True, timeout=600)
    return [svc.result(i) for i in ids], svc.stats()


def key_fields(result):
    """What a served result must agree on across packages."""
    return (result["status"], result.get("assignment"),
            result.get("cost"), result.get("cycles"),
            result.get("violations"), result.get("converged"))


def stable_body(body):
    """A response body without its ids and timings."""
    if not isinstance(body, dict):
        return body
    return {k: stable_body(v) for k, v in body.items()
            if k not in VOLATILE}


def http(url: str, method: str = "GET", body=None, timeout: float = 120):
    """``(status, decoded JSON body)`` of one request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())
