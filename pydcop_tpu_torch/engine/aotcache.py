"""Persistent kernel-library cache: the port's counterpart of
``pydcop_tpu/engine/aotcache.py``.

The reference persists XLA executables across processes so a fresh
``pydcop serve`` worker does not pay compilation for a structure some
earlier worker already compiled.  The port compiles no programs: what
a cold dispatch can pay for is the ``nvcc`` build of the CUDA
libraries its kernels live in (``ops/_build.py``).  Those libraries
are already keyed by a hash of their source and flags, so a shared
directory IS a persistent cache: :func:`enable_persistent_compile_cache`
points ``ops/_build.py``'s library directory at ``cache_dir`` (or at
``PYDCOP_COMPILE_CACHE_DIR``), and every later process that finds a
library there loads it instead of building it.

**Hit accounting.**  ``ops/_build.py`` counts a hit when a library is
found built and a miss when one has to be compiled, per process and per
thread.  :func:`split_cold_call` reads the calling thread's counts
around a cold dispatch: when the dispatch found every library it
needed in the cache and built none, its ledger ``compile`` is the
measured load time (finding and opening the libraries), not the whole
first-call interval — the reference's convention for a cold call
served from its disk cache.  Libraries are loaded once per process, so
a cold key whose libraries are already loaded shows no cache activity
and keeps the whole-interval convention, as the reference's does.

The names are the reference's (``enable_persistent_compile_cache``,
``maybe_enable_from_env``, ``counters``, ``split_cold_call``,
``disk_stats``, ``stats``).
"""

import logging
import os
import threading
from typing import Any, Dict, Optional

from pydcop_tpu_torch.ops import _build

logger = logging.getLogger("pydcop.engine.aotcache")

ENV_DIR = "PYDCOP_COMPILE_CACHE_DIR"

_lock = threading.Lock()
_state: Dict[str, Any] = {"enabled": False, "dir": None}


def enable_persistent_compile_cache(
        cache_dir: Optional[str] = None) -> Optional[str]:
    """Build and load the CUDA kernel libraries under ``cache_dir``
    (default ``PYDCOP_COMPILE_CACHE_DIR``).  Returns the resolved
    directory, or None when neither names one.  Call it before the
    first kernel is loaded: a library loaded earlier stays loaded from
    where it was built."""
    cache_dir = cache_dir or os.environ.get(ENV_DIR) or None
    if not cache_dir:
        return None
    cache_dir = os.path.abspath(cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    _build.set_build_dir(cache_dir)
    with _lock:
        _state["enabled"] = True
        _state["dir"] = cache_dir
    logger.info("persistent kernel-library cache at %s", cache_dir)
    return cache_dir


def maybe_enable_from_env() -> Optional[str]:
    """Enable iff ``PYDCOP_COMPILE_CACHE_DIR`` is set."""
    if os.environ.get(ENV_DIR):
        return enable_persistent_compile_cache()
    return None


def enabled() -> bool:
    with _lock:
        return bool(_state["enabled"])


def cache_dir() -> Optional[str]:
    with _lock:
        return _state["dir"]


def counters() -> Dict[str, float]:
    """The calling thread's monotone library-cache counts (``hits``,
    ``misses``, ``load_s``): delta two snapshots around a dispatch to
    attribute ITS cache activity (:func:`split_cold_call`)."""
    return _build.thread_counters()


def split_cold_call(elapsed_s: float, before: Dict[str, float],
                    after: Dict[str, float]) -> Optional[float]:
    """Honest ``compile`` seconds for one COLD dispatch given the
    counter snapshots around it: the load time, clamped into ``[0,
    elapsed]``, when the dispatch found every library it needed in the
    cache (hits advanced, misses did not); None (the caller keeps the
    whole-interval convention) on any miss, or with no cache activity
    or the cache disabled."""
    if not enabled():
        return None
    d_hits = after["hits"] - before["hits"]
    d_misses = after["misses"] - before["misses"]
    if d_hits <= 0 or d_misses > 0:
        return None
    loaded = max(after["load_s"] - before["load_s"], 0.0)
    return min(loaded, max(elapsed_s, 0.0))


def disk_stats(directory: Optional[str]) -> Dict[str, int]:
    """Library count + byte size of a cache directory."""
    entries = 0
    size = 0
    if directory:
        try:
            for name in os.listdir(directory):
                if name.endswith(".so"):
                    entries += 1
                try:
                    size += os.path.getsize(
                        os.path.join(directory, name))
                except OSError:
                    pass
        except OSError:
            pass
    return {"entries": entries, "bytes": size}


def stats() -> Dict[str, Any]:
    """Operator-facing snapshot: config + process-wide counts + on-disk
    size."""
    with _build._name_locks_guard:
        out: Dict[str, Any] = dict(_build.cache_counts)
    with _lock:
        out["enabled"] = _state["enabled"]
        out["dir"] = _state["dir"]
    out.update(disk_stats(out["dir"]))
    return out
