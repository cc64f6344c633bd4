"""Multi-process initialization for the device engine.

Port of ``pydcop_tpu/engine/multihost.py`` onto ``torch.distributed``:
every process calls :func:`initialize_multihost` before building a mesh,
which joins ``torch.distributed.init_process_group`` (``tcp://`` at
``PYDCOP_COORDINATOR``, or ``env://`` for ``PYDCOP_MULTIHOST=auto``).
The partitioned engine itself is one process driving a list of devices
(``engine/sharding.py``); a mesh across more than one process is not
ported yet and raises, naming ROADMAP.md Queue A item 6(b).

Environment conventions (the reference's):
- ``PYDCOP_COORDINATOR`` — "host:port" of process 0,
- ``PYDCOP_NUM_PROCESSES`` / ``PYDCOP_PROCESS_ID`` — world size / rank,
- ``PYDCOP_MULTIHOST=auto`` — join with ``init_method="env://"`` (the
  launcher's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``).
With none of these set the initializer is a silent single-host no-op,
so the same entry points work everywhere.
"""

import logging
import os
from typing import Optional

logger = logging.getLogger("pydcop_tpu_torch.multihost")

_initialized = False

# What a mesh across processes would need.
CROSS_PROCESS_NOT_PORTED = (
    "a mesh across processes is not ported yet (ROADMAP.md, Queue A "
    "item 6(b)); the partitioned engine drives the devices of one "
    "process")


def multihost_initialized() -> bool:
    """True once a join (or single-host no-op) completed successfully."""
    return _initialized


def _reset_initialized():
    """Test hook: forget the latched join state so a fresh
    initialize_multihost attempt runs (a FAILED join already leaves the
    latch unset)."""
    global _initialized
    _initialized = False


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _backend() -> str:
    import torch

    return "nccl" if torch.cuda.is_available() else "gloo"


def _join_with_retry(join, retry_policy, what: str):
    """Run the coordinator join under the retry policy, keeping the
    module un-latched on failure so the caller can try again.

    The coordinator not being up yet is the expected first-attempt
    outcome of a staggered bring-up, not a fatal one.  On exhaustion
    the partial process group is torn down (best effort) and the last
    error raised."""
    from pydcop_tpu_torch.resilience.retry import RetryPolicy

    if retry_policy is None:
        retry_policy = RetryPolicy.from_env(
            "PYDCOP_MULTIHOST_RETRY_",
            max_attempts=5, base_delay=1.0, max_delay=15.0,
            jitter=0.0,
        )

    def _log_retry(attempt, error, delay):
        logger.warning(
            "%s failed (attempt %d: %s); retrying in %.1fs",
            what, attempt, error, delay,
        )

    try:
        retry_policy.call(join, on_retry=_log_retry)
    except Exception:
        import torch.distributed as dist

        # A half-joined group would make every later attempt fail
        # with "already initialized"; tear it down so retry is
        # possible.  _initialized stays False (never latched here).
        try:
            dist.destroy_process_group()
        except Exception:
            pass
        raise


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         retry_policy=None) -> bool:
    """Join the distributed runtime (idempotent).

    Arguments default to the ``PYDCOP_*`` environment variables; set
    ``PYDCOP_MULTIHOST=auto`` to join through ``env://``.  Returns True
    when running distributed (more than one process), False for plain
    single-host runs (nothing configured — a silent no-op).

    The join runs under ``retry_policy`` (default: from
    ``PYDCOP_MULTIHOST_RETRY_*`` — exponential backoff, 5 attempts)
    because process 0 may simply not be up yet.  On failure the module
    state is NOT latched: a later call retries the join instead of
    silently reporting single-host."""
    global _initialized
    if _initialized:
        return _world_size() > 1

    coordinator_address = (
        coordinator_address or os.environ.get("PYDCOP_COORDINATOR")
    )
    if num_processes is None and "PYDCOP_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PYDCOP_NUM_PROCESSES"])
    if process_id is None and "PYDCOP_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PYDCOP_PROCESS_ID"])

    import torch.distributed as dist

    if coordinator_address is None and num_processes is None:
        if os.environ.get("PYDCOP_MULTIHOST") == "auto":
            _join_with_retry(
                lambda: dist.init_process_group(
                    backend=_backend(), init_method="env://"),
                retry_policy, "multihost auto-join",
            )
            _initialized = True
            return _world_size() > 1
        # Single-host: nothing to join.
        _initialized = True
        return False

    def _join():
        dist.init_process_group(
            backend=_backend(),
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes,
            rank=process_id,
        )

    _join_with_retry(
        _join, retry_policy,
        f"multihost join via {coordinator_address}",
    )
    _initialized = True
    logger.info("Joined distributed runtime: process %s/%d",
                process_id, _world_size())
    return _world_size() > 1


def fleet_host_id() -> str:
    """Stable identity of the host this process serves from, for the
    fleet control plane: ``PYDCOP_HOST_ID`` when set (a multi-host
    simulation on one box overrides it per process), else the host
    name."""
    host = os.environ.get("PYDCOP_HOST_ID")
    if host:
        return host
    import socket

    return socket.gethostname()


def multihost_configured() -> bool:
    """True when the environment asks for a distributed runtime (the
    ``PYDCOP_*`` conventions above), joined or not."""
    return (
        "PYDCOP_COORDINATOR" in os.environ
        or "PYDCOP_NUM_PROCESSES" in os.environ
        or os.environ.get("PYDCOP_MULTIHOST") == "auto"
    )


def global_mesh(n_devices: Optional[int] = None, device="cuda"):
    """A mesh over this process's devices of ``device``'s kind.

    When the environment is CONFIGURED for multihost but the join has
    not completed, this raises instead of silently building a
    single-host mesh: a participant sharding over its local devices
    while the rest shard globally would give a wrong answer, not a
    crash.  A joined world of more than one process raises too: a mesh
    across processes is not ported."""
    from pydcop_tpu_torch.engine.sharding import make_mesh

    if multihost_configured() and not multihost_initialized():
        raise RuntimeError(
            "multihost runtime configured (PYDCOP_COORDINATOR / "
            "PYDCOP_NUM_PROCESSES / PYDCOP_MULTIHOST=auto) but not "
            "initialized: the coordinator join failed or was never "
            "attempted — call initialize_multihost() (it retries and "
            "never latches a failed join) before building a global "
            "mesh"
        )
    if _world_size() > 1:
        raise NotImplementedError(CROSS_PROCESS_NOT_PORTED)
    return make_mesh(n_devices, device=device)


def partitioned_mesh(shards: int, device="cuda"):
    """Mesh for the PARTITIONED engine (``api.solve(shards=N)`` /
    ``solve --shards N``): the unjoined-multihost guard of
    :func:`global_mesh` plus a device-count check.  A count above the
    machine's devices raises, a one-card machine asked for 4 shards on
    ``"cuda"`` included; ``ShardedMaxSumEngine(mesh=...)`` takes a mesh
    that names one card several times."""
    from pydcop_tpu_torch.engine.sharding import available_devices

    if shards < 2:
        raise ValueError(
            f"partitioned sharding needs shards >= 2, got {shards}")
    available = len(available_devices(device)) \
        if not multihost_configured() else None
    if available is not None and shards > available:
        raise ValueError(
            f"shards={shards} but only {available} device(s) "
            "available; for CPU testing force host devices with "
            "XLA_FLAGS=--xla_force_host_platform_device_count="
            f"{shards}; on one card, build ShardedMaxSumEngine on a "
            "mesh that names it several times "
            "(engine.sharding.make_mesh(devices=[...]))")
    return global_mesh(shards, device)
