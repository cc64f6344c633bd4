"""Engine checkpoint/resume: NPZ snapshots of the solver state.

Port of ``pydcop_tpu/resilience/checkpoint.py``.  The engine side
(``MaxSumEngine.run_checkpointed``) chunks the solve into K-cycle
segments and calls a :class:`CheckpointManager` between segments; this
module owns the on-disk format and the resume entry point.  Because the
superstep is deterministic and each segment re-enters
``run_maxsum_from`` with the exact state the previous one produced, a
resumed solve reproduces the uninterrupted trajectory bit for bit.

Format (the reference's, framework-neutral): one ``ckpt_<cycle>.npz``
per snapshot — the state's leaves as ``leaf_<i>`` in
``jax.tree_util.tree_leaves`` order (``utils/tree.py``), with their
dtypes, plus a JSON ``__meta__`` blob (version, cycle, leaf count,
content checksum, extra).  So a snapshot written by either package
resumes in the other.  Writes are atomic (tmp + ``os.replace``);
integrity is verified on read: the meta blob carries a sha256 over
every leaf's bytes, dtype and shape, so a torn write, a truncated file
or disk corruption is detected (:class:`CheckpointCorruptError`) and
``latest()`` / ``resume_from_checkpoint`` fall back to the newest
snapshot that verifies.  :class:`AsyncCheckpointWriter` takes the
device-to-host copy and the write off the solve loop.  The state's
structure is not stored: restore goes through a template state built
from the same compiled graph, whose leaves give each array its dtype
and device.

Every write is logged in ``CheckpointManager.writes`` (bytes, and the
seconds of the host copy, the checksum and the file write), and the
manager counts the asynchronous submits that found the writer's queue
full.
"""

import atexit
import hashlib
import json
import logging
import os
import queue
import re
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.utils.tree import tree_leaves, tree_unflatten

logger = logging.getLogger("pydcop_tpu_torch.resilience.checkpoint")

CHECKPOINT_VERSION = 1
_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")


class CheckpointCorruptError(RuntimeError):
    """A snapshot failed integrity verification (unreadable container,
    missing leaves, or checksum mismatch)."""


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _content_checksum(arrays: Dict[str, np.ndarray]) -> str:
    """sha256 over every leaf's name, dtype, shape and bytes, in leaf
    order (the reference's digest, so both packages agree on it)."""
    h = hashlib.sha256()
    for name in sorted(arrays, key=lambda n: int(n.split("_")[1])):
        arr = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _save_arrays(path: str, arrays: Dict[str, np.ndarray], *, cycle: int,
                 extra: Optional[Dict[str, Any]] = None
                 ) -> Tuple[float, float]:
    """Atomically write host leaves; returns (checksum seconds, write
    seconds).  Every write (the synchronous path's and the
    asynchronous writer thread's) runs inside the tracer's
    ``checkpoint_write`` span and counts in ``pydcop_checkpoints_total``
    and, while the registry is active, ``pydcop_checkpoint_write_seconds``
    (the reference's names).  A failed write raises through the span;
    nothing here swallows it."""
    from pydcop_tpu_torch.observability.trace import tracer

    if tracer.enabled:
        with tracer.span("checkpoint_write", "resilience",
                         path=path, cycle=int(cycle)):
            return _write_arrays(path, arrays, cycle=cycle, extra=extra)
    return _write_arrays(path, arrays, cycle=cycle, extra=extra)


def _write_arrays(path: str, arrays: Dict[str, np.ndarray], *, cycle: int,
                  extra: Optional[Dict[str, Any]] = None
                  ) -> Tuple[float, float]:
    from pydcop_tpu_torch.observability.metrics import registry

    t0 = time.perf_counter()
    meta = {
        "version": CHECKPOINT_VERSION,
        "cycle": int(cycle),
        "n_leaves": len(arrays),
        "checksum": _content_checksum(arrays),
        "extra": extra or {},
    }
    t1 = time.perf_counter()
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=directory, prefix=".ckpt_tmp_", suffix=".npz"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    registry.counter(
        "pydcop_checkpoints_total", "Checkpoint snapshots written"
    ).inc()
    if registry.active:
        registry.histogram(
            "pydcop_checkpoint_write_seconds",
            "Wall seconds per checkpoint write",
        ).observe(time.perf_counter() - t0)
    return t1 - t0, time.perf_counter() - t1


def _host_arrays(leaves: List[Any]) -> Dict[str, np.ndarray]:
    return {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}


def save_state(path: str, state: Any, *, cycle: int,
               extra: Optional[Dict[str, Any]] = None) -> str:
    """Atomically write a state (a NamedTuple of tensors, arrays or
    tuples of them) to ``path`` (.npz)."""
    _save_arrays(path, _host_arrays(tree_leaves(state)), cycle=cycle,
                 extra=extra)
    return path


def read_meta(path: str) -> Dict[str, Any]:
    with np.load(path, allow_pickle=False) as data:
        return json.loads(str(data["__meta__"]))


def _verify_arrays(path: str, meta: Dict[str, Any],
                   arrays: Dict[str, np.ndarray]):
    """Checksum the loaded leaves against the meta blob.  Snapshots
    without a ``checksum`` key pass (the reference's older format)."""
    expected = meta.get("checksum")
    if expected is None:
        return
    actual = _content_checksum(arrays)
    if actual != expected:
        raise CheckpointCorruptError(
            f"Checkpoint {path} failed content verification: "
            f"checksum {actual[:12]}… != recorded {expected[:12]}… "
            "(torn write or disk corruption)"
        )


def verify_checkpoint(path: str) -> Dict[str, Any]:
    """Fully verify one snapshot: readable container, every declared
    leaf present, content checksum matching.  Returns the meta blob;
    raises :class:`CheckpointCorruptError` on any failure."""
    try:
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data["__meta__"]))
            arrays = {
                f"leaf_{i}": data[f"leaf_{i}"]
                for i in range(meta["n_leaves"])
            }
    except Exception as e:
        raise CheckpointCorruptError(
            f"Checkpoint {path} unreadable: {e}") from e
    _verify_arrays(path, meta, arrays)
    return meta


def _place(arr: np.ndarray, ref: Any) -> Any:
    """``arr`` as ``ref``'s kind: a tensor of its dtype on its device,
    or a numpy array of its dtype."""
    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(arr).to(device=ref.device, dtype=ref.dtype)
    return np.asarray(arr).astype(np.asarray(ref).dtype)


def load_state(path: str, template: Any) -> Tuple[Any, Dict[str, Any]]:
    """Load a snapshot into ``template``'s structure, dtypes and
    devices, verifying its content checksum.  Returns ``(state,
    meta)``.  Corruption raises :class:`CheckpointCorruptError`; a
    version or structure mismatch (wrong problem or engine
    configuration) raises ``ValueError``."""
    refs = tree_leaves(template)
    try:
        data = np.load(path, allow_pickle=False)
    except Exception as e:
        raise CheckpointCorruptError(
            f"Checkpoint {path} unreadable: {e}") from e
    with data:
        try:
            meta = json.loads(str(data["__meta__"]))
        except Exception as e:
            raise CheckpointCorruptError(
                f"Checkpoint {path} unreadable: {e}") from e
        if meta.get("version") != CHECKPOINT_VERSION:
            raise ValueError(
                f"Checkpoint {path} has version {meta.get('version')}; "
                f"this build reads version {CHECKPOINT_VERSION}"
            )
        if meta["n_leaves"] != len(refs):
            raise ValueError(
                f"Checkpoint {path} has {meta['n_leaves']} leaves but "
                f"the engine state has {len(refs)}: wrong problem or "
                "engine configuration"
            )
        try:
            loaded = [data[f"leaf_{i}"] for i in range(len(refs))]
        except Exception as e:
            raise CheckpointCorruptError(
                f"Checkpoint {path} unreadable: {e}") from e
    _verify_arrays(
        path, meta,
        {f"leaf_{i}": arr for i, arr in enumerate(loaded)},
    )
    placed = []
    for arr, ref in zip(loaded, refs):
        if tuple(arr.shape) != tuple(np.shape(ref)):
            raise ValueError(
                f"Checkpoint {path} leaf shape {arr.shape} != engine "
                f"state shape {tuple(np.shape(ref))}: wrong problem"
            )
        placed.append(_place(arr, ref))
    return tree_unflatten(template, placed), meta


class CheckpointManager:
    """Cadence + retention over a checkpoint directory.

    ``every`` is the segment length in cycles (the engine snapshots at
    each segment boundary); ``keep`` bounds how many snapshots stay on
    disk (oldest pruned first — the latest one is never pruned).
    ``writes`` logs one dict per snapshot written: ``cycle``,
    ``bytes``, and the seconds of the host copy (``fetch_s``, for the
    asynchronous writer the wait for its side-stream copy), the
    checksum and the file write.  ``blocked`` / ``blocked_s`` count
    the submits of an :class:`AsyncCheckpointWriter` that found its
    queue full, and the seconds the solve loop waited on them.
    """

    def __init__(self, directory: str, every: int = 100, keep: int = 2):
        if every <= 0:
            raise ValueError(f"checkpoint cadence must be > 0: {every}")
        if keep < 1:
            raise ValueError(f"must keep at least 1 checkpoint: {keep}")
        self.directory = directory
        self.every = every
        self.keep = keep
        self.writes: List[Dict[str, Any]] = []
        self.blocked = 0
        self.blocked_s = 0.0
        os.makedirs(directory, exist_ok=True)

    def path_for(self, cycle: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(cycle)}.npz")

    def checkpoints(self) -> List[Tuple[int, str]]:
        """(cycle, path) pairs present on disk, oldest first."""
        found = []
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        for name in names:
            m = _CKPT_RE.match(name)
            if m:
                found.append(
                    (int(m.group(1)),
                     os.path.join(self.directory, name))
                )
        return sorted(found)

    def latest(self) -> Optional[str]:
        """Path of the newest snapshot that fully verifies
        (:func:`verify_checkpoint`); a corrupt or truncated one is
        skipped with a warning and the next older one tried."""
        for cycle, path in reversed(self.checkpoints()):
            try:
                verify_checkpoint(path)
                return path
            except CheckpointCorruptError as e:
                logger.warning(
                    "Skipping corrupt checkpoint %s, falling back to "
                    "an older snapshot: %s", path, e
                )
        return None

    def save(self, state: Any, cycle: int,
             extra: Optional[Dict[str, Any]] = None) -> str:
        t0 = time.perf_counter()
        arrays = _host_arrays(tree_leaves(state))
        return self._write(cycle, arrays, extra, time.perf_counter() - t0)

    def _write(self, cycle: int, arrays: Dict[str, np.ndarray],
               extra: Optional[Dict[str, Any]], fetch_s: float) -> str:
        path = self.path_for(cycle)
        checksum_s, write_s = _save_arrays(path, arrays, cycle=cycle,
                                           extra=extra)
        self.writes.append({
            "cycle": int(cycle),
            "bytes": int(sum(a.nbytes for a in arrays.values())),
            "fetch_s": fetch_s, "checksum_s": checksum_s,
            "write_s": write_s,
        })
        self._prune()
        return path

    def _prune(self):
        existing = self.checkpoints()
        for _, path in existing[:-self.keep]:
            try:
                os.unlink(path)
            except OSError:
                pass


class AsyncCheckpointWriter:
    """Background device-to-host copy + atomic NPZ write.

    ``submit`` returns at once.  A state on the card is copied into
    pinned host buffers on a side CUDA stream that first waits on an
    event recorded at the caller's point in its stream, so the copy
    overlaps the next segment's kernels instead of queueing behind them
    on the caller's stream; the queued item keeps the state's tensors
    alive until the copy has finished, so the caching allocator cannot
    hand their blocks to the next segment while they are read.  A
    single daemon thread waits for the copy, writes the snapshot
    (the manager's atomic format) and applies its retention.  Nothing
    in the solve writes into a state tensor, so the snapshot needs no
    device-side clone; a CPU state is written from its own tensors.

    Contract (the reference's):

    - the queue is bounded (``maxsize``): if writes fall behind, the
      loop blocks on ``submit`` (counted in the manager's ``blocked`` /
      ``blocked_s``) rather than buying unbounded host memory;
    - ``close`` drains the queue and joins the thread (also registered
      ``atexit``, where a failure is logged, not raised);
    - a write failure is re-raised on the next ``submit``/``flush``/
      ``close``.
    """

    def __init__(self, manager: CheckpointManager, maxsize: int = 2):
        self._manager = manager
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._error: Optional[BaseException] = None
        self._closed = False
        self._stream = None
        self._thread = threading.Thread(
            target=self._run, name="pydcop-ckpt-writer", daemon=True
        )
        self._thread.start()
        atexit.register(self._close_at_exit)

    def _start_copy(self, tree: Any):
        """(host leaves, event marking their copy's end or None)."""
        leaves = tree_leaves(tree)
        cuda = [leaf for leaf in leaves
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda]
        if not cuda:
            return leaves, None
        device = cuda[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=device)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))
        self._stream.wait_event(ready)
        host = []
        with torch.cuda.stream(self._stream):
            for leaf in leaves:
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    buf = torch.empty(leaf.shape, dtype=leaf.dtype,
                                      pin_memory=True)
                    buf.copy_(leaf, non_blocking=True)
                    leaf = buf
                host.append(leaf)
        done = torch.cuda.Event()
        done.record(self._stream)
        return host, done

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            host, done, keepalive, extra = item
            del item
            try:
                t0 = time.perf_counter()
                if done is not None:
                    done.synchronize()
                del keepalive
                arrays = _host_arrays(host[:-1])
                cycle = int(_to_numpy(host[-1]))
                self._manager._write(cycle, arrays, extra,
                                     time.perf_counter() - t0)
            except BaseException as exc:  # noqa: BLE001 - reraised
                self._error = exc
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._error is not None:
            exc, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from exc

    def submit(self, state: Any, cycle,
               extra: Optional[Dict[str, Any]] = None) -> None:
        """Enqueue one snapshot.  ``cycle`` may be a device scalar: it
        is copied with the state."""
        if self._closed:
            raise RuntimeError("writer is closed")
        self._raise_pending()
        host, done = self._start_copy((state, cycle))
        keepalive = (state, cycle) if done is not None else None
        item = (host, done, keepalive, extra)
        try:
            self._q.put_nowait(item)
        except queue.Full:
            t0 = time.perf_counter()
            self._q.put(item)
            self._manager.blocked += 1
            self._manager.blocked_s += time.perf_counter() - t0

    def flush(self) -> None:
        """Block until every submitted snapshot is on disk."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """Flush, stop the thread and surface any pending error."""
        if self._closed:
            return
        self._closed = True
        try:
            self._q.join()
            self._q.put(None)
            self._thread.join()
        finally:
            atexit.unregister(self._close_at_exit)
        self._raise_pending()

    def _close_at_exit(self) -> None:
        try:
            self.close()
        except Exception:
            logger.exception(
                "Async checkpoint flush failed during interpreter "
                "shutdown; the last snapshot may be missing"
            )


def resume_from_checkpoint(engine, manager, max_cycles: int = 1000,
                           **run_kwargs):
    """Continue an interrupted checkpointed solve.

    ``manager`` is a :class:`CheckpointManager` or a directory path.
    Loads the newest snapshot that verifies into the engine's state
    structure and device (a decimated run's into
    ``engine.runner.decimation_template``) and re-enters
    ``run_checkpointed``; with no snapshot on disk the solve starts
    from cycle 0.  Only corruption falls back to an older snapshot: a
    structure mismatch (``ValueError``) aborts.  The result's metrics
    gain ``resumed_from_cycle``.
    """
    if isinstance(manager, str):
        manager = CheckpointManager(manager)
    initial_state = None
    resumed_cycle = 0
    template = engine.init_state()
    if run_kwargs.get("decimation") is not None:
        from pydcop_tpu_torch.engine.runner import decimation_template

        template = decimation_template(engine, template)
    for cycle, path in reversed(manager.checkpoints()):
        try:
            initial_state, meta = load_state(path, template)
            resumed_cycle = meta["cycle"]
            logger.info(
                "Resuming from %s (cycle %d)", path, resumed_cycle
            )
            break
        except (CheckpointCorruptError, OSError) as e:
            logger.warning(
                "Checkpoint %s failed verification (%s); falling back "
                "to an older snapshot", path, e,
            )
    result = engine.run_checkpointed(
        max_cycles=max_cycles, manager=manager,
        initial_state=initial_state, **run_kwargs,
    )
    result.metrics["resumed_from_cycle"] = resumed_cycle
    return result
