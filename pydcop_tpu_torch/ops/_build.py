"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher; it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root and loaded with ``ctypes``.
No PyTorch headers are included, so a build takes seconds, not the
minutes of ``torch.utils.cpp_extension.load``.  Libraries are named by
a hash of their source and flags, so an edited kernel is rebuilt and
an unchanged one is reused.  ``engine/aotcache.py`` points the library
directory elsewhere (``set_build_dir``), as the reference points its
persistent compile cache, and reads the hit/miss counts kept here.

Builds may run on several threads (the serving scheduler and its
speculative builder): each library has its own lock, so two threads
asking for the same one run one ``nvcc``, and the build seconds are
counted per thread as well as per process, so a solve's compile time
(``thread_build_seconds``) never includes another thread's build.

Nothing here runs at import: the CPU tests import every module on a
host with neither ``nvcc`` nor a card.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
# -ftz=true: single-precision arithmetic flushes subnormals to zero, as
# XLA:CPU and the TPU do for the reference.  The kernels also write
# their float operations as PTX instructions with .ftz (inline asm,
# which nvcc neither contracts into an FMA nor reorders) or, in
# window_sum.cu, as __fadd_rn (never contracted, .ftz under this flag);
# division stays IEEE (-prec-div=true is the default without
# --use_fast_math).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-ftz=true", "-shared", "-Xcompiler", "-fPIC",
)

# Launches per kernel, counted by each wrapper where it launches its
# kernel and nowhere else (chip_smoke.py zeroes and reads these around
# the main path to show the path went through the kernels).
launch_counts: "collections.Counter[str]" = collections.Counter()

# Seconds spent compiling kernels in this process, all threads.
build_seconds = 0.0

# Library-cache counts, all threads: a hit is a library found built, a
# miss one that had to be compiled.
cache_counts = {"hits": 0, "misses": 0}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# One lock per library name, taken around its build (never while
# ``_lock`` is wanted by the same thread for another name).
_name_locks: Dict[str, threading.Lock] = {}
_name_locks_guard = threading.Lock()
_tls = threading.local()


def _thread_counter(name: str) -> float:
    return getattr(_tls, name, 0.0)


def _thread_add(name: str, value: float) -> None:
    setattr(_tls, name, _thread_counter(name) + value)


def thread_build_seconds() -> float:
    """Seconds this thread has spent compiling kernels (the engine
    reports the part spent inside a solve as its compile time)."""
    return _thread_counter("build_s")


def thread_counters() -> Dict[str, float]:
    """This thread's library-cache activity: hits, misses, and the
    seconds spent in :func:`load` (finding, building and opening
    libraries)."""
    return {"hits": _thread_counter("hits"),
            "misses": _thread_counter("misses"),
            "load_s": _thread_counter("load_s")}


def set_build_dir(path) -> Path:
    """Build and load libraries under ``path`` from now on (libraries
    already loaded stay loaded)."""
    global BUILD_DIR
    BUILD_DIR = Path(path).resolve()
    return BUILD_DIR


def _name_lock(name: str) -> threading.Lock:
    with _name_locks_guard:
        lock = _name_locks.get(name)
        if lock is None:
            lock = _name_locks[name] = threading.Lock()
        return lock


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels are built from source at first use")
    return nvcc


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one ``nvcc`` for ``csrc/<name>.cu`` into a temporary file;
    returns ``(process, tmp, final)`` or None when already built."""
    final = _lib_path(name)
    if final.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final


def build(names: Iterable[str]) -> float:
    """Compile every named kernel that is not built yet, one ``nvcc``
    per source, all started together.  Returns the wall seconds.  A
    library another thread is building is waited for, not built
    twice."""
    global build_seconds
    names = sorted(set(names))
    locks = [_name_lock(n) for n in names]
    t0 = time.perf_counter()
    for lock in locks:
        lock.acquire()
    try:
        jobs = [(n, _start(n)) for n in names]
        errors = []
        hits = misses = 0
        for name, job in jobs:
            if job is None:
                hits += 1
                continue
            misses += 1
            proc, tmp, final = job
            out, _ = proc.communicate()
            if proc.returncode != 0:
                os.unlink(tmp)
                errors.append(f"nvcc failed for {name}.cu:\n{out}")
            else:
                os.replace(tmp, final)
    finally:
        for lock in reversed(locks):
            lock.release()
    elapsed = time.perf_counter() - t0
    with _name_locks_guard:
        build_seconds += elapsed
        cache_counts["hits"] += hits
        cache_counts["misses"] += misses
    _thread_add("build_s", elapsed)
    _thread_add("hits", hits)
    _thread_add("misses", misses)
    if errors:
        raise RuntimeError("\n".join(errors))
    return elapsed


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.perf_counter()
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
            _thread_add("load_s", time.perf_counter() - t0)
        return lib


def kernel_names() -> list:
    """Every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))
