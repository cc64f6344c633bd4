"""Injectable link-fault plane for the serving fleet.

Every socket exchange the fleet makes — router→replica forwards,
liveness probes, SSE proxies, worker→router ``/fleet/join``
announcements — routes through :func:`exchange` / :func:`open_stream`
(nothing in ``serving/`` opens a
socket any other way).  With no plan installed the seam is a branch
and a plain ``http.client`` round trip; with one installed it injects
seeded, deterministic per-link faults:

- ``drop``: the request is never sent (connect refused) — retry-safe.
- ``delay_ms``: fixed latency added before the bytes go out.
- ``dup``: the request is delivered *twice* (second response
  discarded) — the idempotency probe.
- ``lose_response``: the request is delivered and executed but the
  response evaporates — the ambiguous failure that forces
  retry-after-bytes-sent.
- ``blackhole`` / ``partition``: the link eats traffic; calls hold
  (bounded) and fail without delivering.

Plans come from the ``PYDCOP_NETFAULT`` environment variable (reaches
spawned fleet workers) or :func:`install` (same-process test hook).
Grammar — ``;``-separated clauses of ``,``-separated ``key=value``::

    seed=7;link=router>replica-*,drop=0.01,delay_ms=20
    link=router>hostB,lose_response=1.0,times=1
    partition=host0/hostB

``link=SRC>DST`` scopes a clause to links whose endpoint labels
fnmatch the patterns (endpoints carry several labels: ``replica-3``
*and* its host id); ``path=GLOB`` further scopes it to matching
request paths (``path=/solve`` faults forwards but not the liveness
probes sharing the link).  ``times=N`` retires a clause after it has
injected N faults.  ``partition=A/B`` (groups ``+``-separated) is a
bidirectional blackhole between the two label groups.

Determinism: each probabilistic draw hashes
``seed|src|dst|attempt#|field`` — the same plan over the same call
sequence injects the same faults, regardless of thread timing
elsewhere in the fleet.

A copy of ``pydcop_tpu/serving/netfault.py`` (pure Python).
"""

from __future__ import annotations

import hashlib
import http.client
import os
import threading
import time
from dataclasses import dataclass, field
from fnmatch import fnmatch
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

__all__ = [
    "NotSent", "FaultPlan", "exchange", "open_stream",
    "install", "clear", "plan", "counters",
]

Labels = Union[str, Sequence[str]]


class NotSent(OSError):
    """The request was never delivered (zero bytes reached the peer).

    Safe to retry anywhere: raised for real connect failures and for
    injected drop/blackhole/partition faults.  ``FleetRouter``
    re-exports this as ``ForwardNotSent``.
    """


def _labels(x: Labels) -> Tuple[str, ...]:
    if isinstance(x, str):
        return (x,)
    return tuple(s for s in x if s)


def _match(pattern: str, labels: Tuple[str, ...]) -> bool:
    return any(fnmatch(lab, pattern) for lab in labels)


@dataclass
class _Clause:
    src: str = "*"
    dst: str = "*"
    path: str = "*"
    drop: float = 0.0
    delay_ms: float = 0.0
    dup: float = 0.0
    lose_response: float = 0.0
    blackhole: bool = False
    times: Optional[int] = None
    hold_s: float = 0.2          # bounded blackhole hold (tests stay fast)
    fired: int = 0

    def live(self) -> bool:
        return self.times is None or self.fired < self.times


@dataclass
class _Partition:
    group_a: List[str] = field(default_factory=list)
    group_b: List[str] = field(default_factory=list)
    hold_s: float = 0.2

    def severs(self, src: Tuple[str, ...], dst: Tuple[str, ...]) -> bool:
        a_src = any(_match(p, src) for p in self.group_a)
        b_src = any(_match(p, src) for p in self.group_b)
        a_dst = any(_match(p, dst) for p in self.group_a)
        b_dst = any(_match(p, dst) for p in self.group_b)
        return (a_src and b_dst) or (b_src and a_dst)


class FaultPlan:
    """A parsed, seeded fault plan over the fleet's links."""

    def __init__(self, clauses: Iterable[_Clause] = (),
                 partitions: Iterable[_Partition] = (),
                 seed: int = 0):
        self.clauses: List[_Clause] = list(clauses)
        self.partitions: List[_Partition] = list(partitions)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._attempts: Dict[Tuple[str, str], int] = {}
        self._injected: Dict[str, int] = {}

    # ---------------------------------------------------- parsing
    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        clauses: List[_Clause] = []
        partitions: List[_Partition] = []
        seed = 0
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            pairs = {}
            for item in raw.split(","):
                if "=" not in item:
                    raise ValueError(
                        f"netfault clause item {item!r} is not key=value")
                k, v = item.split("=", 1)
                pairs[k.strip()] = v.strip()
            if "seed" in pairs:
                seed = int(pairs.pop("seed"))
            if "partition" in pairs:
                part = pairs.pop("partition")
                if "/" not in part:
                    raise ValueError(
                        "partition=A/B needs two '/'-separated groups")
                a, b = part.split("/", 1)
                partitions.append(_Partition(
                    group_a=[g for g in a.split("+") if g],
                    group_b=[g for g in b.split("+") if g],
                    hold_s=float(pairs.pop("hold_s", 0.2))))
                if pairs:
                    raise ValueError(
                        f"partition clause has stray keys {sorted(pairs)}")
                continue
            if not pairs:
                continue
            cl = _Clause()
            link = pairs.pop("link", None)
            if link is not None:
                if ">" not in link:
                    raise ValueError("link=SRC>DST needs a '>'")
                cl.src, cl.dst = (s.strip() for s in link.split(">", 1))
            for k, v in pairs.items():
                if k in ("drop", "dup", "lose_response"):
                    setattr(cl, k, float(v))
                elif k in ("delay_ms", "hold_s"):
                    setattr(cl, k, float(v))
                elif k == "blackhole":
                    cl.blackhole = v not in ("0", "false", "")
                elif k == "times":
                    cl.times = int(v)
                elif k == "path":
                    cl.path = v
                else:
                    raise ValueError(f"unknown netfault key {k!r}")
            clauses.append(cl)
        return cls(clauses, partitions, seed)

    # ------------------------------------------------- bookkeeping
    def _count(self, kind: str) -> None:
        with self._lock:
            self._injected[kind] = self._injected.get(kind, 0) + 1
        # Injections announce themselves to the trace plane: the
        # instant inherits any thread-bound trace context (the router
        # binds the forwarded request's trace_ids around the
        # exchange), so /fleet/forensics shows the fault INSIDE the
        # causal tree it perturbed.  Off the fault path this never
        # runs — the no-fault hot path stays instant-free.
        try:
            from pydcop_tpu_torch.observability.trace import tracer

            if tracer.active:
                tracer.instant("netfault_injected", "fleet",
                               kind=kind)
        except Exception:  # noqa: BLE001 — telemetry never breaks IO
            pass

    def injected(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._injected)

    def _fraction(self, src_key: str, dst_key: str, n: int,
                  fld: str) -> float:
        h = hashlib.sha256(
            f"{self.seed}|{src_key}|{dst_key}|{n}|{fld}".encode()
        ).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64

    # ---------------------------------------------------- deciding
    def decide(self, src: Labels, dst: Labels, timeout: float,
               path: str = "") -> Dict[str, bool]:
        """Apply pre-send faults (may sleep / raise); return the
        post-send faults the caller must honor (``dup`` /
        ``lose_response``)."""
        src_l, dst_l = _labels(src), _labels(dst)
        src_key, dst_key = "|".join(src_l), "|".join(dst_l)
        with self._lock:
            n = self._attempts[(src_key, dst_key)] = (
                self._attempts.get((src_key, dst_key), 0) + 1)
        for part in self.partitions:
            if part.severs(src_l, dst_l):
                self._count("partition")
                time.sleep(min(timeout, part.hold_s))
                raise NotSent(
                    f"netfault: partition severs {src_key}->{dst_key}")
        post = {"dup": False, "lose_response": False}
        for cl in self.clauses:
            if not (_match(cl.src, src_l) and _match(cl.dst, dst_l)):
                continue
            if not fnmatch(path, cl.path):
                continue
            if not cl.live():
                continue
            if cl.blackhole:
                cl.fired += 1
                self._count("blackhole")
                time.sleep(min(timeout, cl.hold_s))
                raise NotSent(
                    f"netfault: black hole on {src_key}->{dst_key}")
            if cl.drop and self._fraction(
                    src_key, dst_key, n, "drop") < cl.drop:
                cl.fired += 1
                self._count("drop")
                raise NotSent(
                    f"netfault: dropped on {src_key}->{dst_key}")
            if cl.delay_ms:
                cl.fired += 1
                self._count("delay")
                time.sleep(cl.delay_ms / 1000.0)
            if cl.dup and self._fraction(
                    src_key, dst_key, n, "dup") < cl.dup:
                cl.fired += 1
                post["dup"] = True
            if cl.lose_response and self._fraction(
                    src_key, dst_key, n, "lose_response"
                    ) < cl.lose_response:
                cl.fired += 1
                post["lose_response"] = True
        return post


# ------------------------------------------------------------------
# Module-level plan registry.  ``plan()`` is the hot-path check: one
# global read once the env latch is set.
# ------------------------------------------------------------------
_PLAN: Optional[FaultPlan] = None
_ENV_LOADED = False
_LOCK = threading.Lock()


def plan() -> Optional[FaultPlan]:
    global _ENV_LOADED, _PLAN
    if not _ENV_LOADED:
        with _LOCK:
            if not _ENV_LOADED:
                spec = os.environ.get("PYDCOP_NETFAULT")
                if spec:
                    _PLAN = FaultPlan.parse(spec)
                _ENV_LOADED = True
    return _PLAN


def install(p: Union[FaultPlan, str]) -> FaultPlan:
    """Same-process test hook: activate a plan (or plan string)."""
    global _ENV_LOADED, _PLAN
    if isinstance(p, str):
        p = FaultPlan.parse(p)
    with _LOCK:
        _PLAN = p
        _ENV_LOADED = True
    return p


def clear() -> None:
    """Deactivate fault injection (also suppresses the env plan)."""
    global _ENV_LOADED, _PLAN
    with _LOCK:
        _PLAN = None
        _ENV_LOADED = True


def counters() -> Dict[str, int]:
    p = plan()
    return p.injected() if p is not None else {}


# ------------------------------------------------------------------
# The seam itself.
# ------------------------------------------------------------------
def _send(host: str, port: int, method: str, path: str,
          body: Optional[bytes], timeout: float,
          headers: Optional[Dict[str, str]]
          ) -> Tuple[int, str, bytes]:
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        try:
            conn.connect()
        except OSError as exc:
            # Zero bytes reached the peer: retry-safe by construction.
            raise NotSent(str(exc)) from exc
        hdrs = dict(headers or {})
        if body is not None and "Content-Type" not in hdrs:
            hdrs["Content-Type"] = "application/json"
        conn.request(method, path, body=body, headers=hdrs)
        resp = conn.getresponse()
        payload = resp.read()
        return (resp.status,
                resp.getheader("Content-Type", "application/json"),
                payload)
    finally:
        conn.close()


def exchange(src: Labels, dst: Labels, host: str, port: int,
             method: str, path: str, body: Optional[bytes] = None,
             timeout: float = 30.0,
             headers: Optional[Dict[str, str]] = None
             ) -> Tuple[int, str, bytes]:
    """One HTTP round trip over a named fleet link.

    Raises :class:`NotSent` when nothing was delivered (connect
    failure or injected drop/blackhole/partition) and plain
    ``OSError`` for ambiguous failures (bytes sent, outcome unknown —
    including injected ``lose_response``).
    """
    p = plan()
    if p is None:
        return _send(host, port, method, path, body, timeout, headers)
    post = p.decide(src, dst, timeout, path=path)
    out = _send(host, port, method, path, body, timeout, headers)
    if post["dup"]:
        p._count("dup")
        try:
            _send(host, port, method, path, body, timeout, headers)
        except OSError:
            pass
    if post["lose_response"]:
        p._count("lose_response")
        raise OSError(
            "netfault: response lost after delivery "
            f"({method} {path})")
    return out


def open_stream(src: Labels, dst: Labels, host: str, port: int,
                method: str, path: str, body: Optional[bytes],
                timeout: float,
                headers: Optional[Dict[str, str]] = None):
    """Open a streaming exchange (SSE proxy); returns ``(conn,
    resp)`` — the caller reads and must ``conn.close()``.

    Pre-send faults (drop/delay/blackhole/partition) apply; the
    post-send kinds don't meaningfully compose with a stream and are
    ignored.
    """
    p = plan()
    if p is not None:
        p.decide(src, dst, timeout, path=path)
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        try:
            conn.connect()
        except OSError as exc:
            raise NotSent(str(exc)) from exc
        hdrs = dict(headers or {})
        if body is not None and "Content-Type" not in hdrs:
            hdrs["Content-Type"] = "application/json"
        conn.request(method, path, body=body, headers=hdrs)
        resp = conn.getresponse()
        return conn, resp
    except Exception:
        conn.close()
        raise
