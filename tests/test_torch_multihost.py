"""The port's multihost join (pydcop_tpu_torch/engine/multihost.py), on
the CPU, after ``tests/unit/test_selfheal_battery.py``'s
``TestMultihostCoordinatorLoss`` (its ``jax.distributed`` mocks become
``torch.distributed.init_process_group`` / ``destroy_process_group``
mocks), plus the environment conventions, the ``env://`` auto-join, the
host identity and the guards of ``global_mesh`` / ``partitioned_mesh``.

Tolerance: not applicable (control flow and messages).
"""

import pytest
import torch
import torch.distributed as dist

from pydcop_tpu_torch.resilience.retry import (
    RetryExhaustedError,
    RetryPolicy,
)

ENV = ("PYDCOP_COORDINATOR", "PYDCOP_NUM_PROCESSES", "PYDCOP_PROCESS_ID",
       "PYDCOP_MULTIHOST", "PYDCOP_HOST_ID")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def multihost(monkeypatch):
    from pydcop_tpu_torch.engine import multihost as mh

    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    was_initialized = mh._initialized
    mh._reset_initialized()
    yield mh
    mh._initialized = was_initialized


@pytest.fixture()
def joins(monkeypatch):
    """Record init_process_group calls instead of joining."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    return calls


class TestMultihostCoordinatorLoss:
    def test_coordinator_loss_surfaces_clean_error_no_latch(
            self, multihost, monkeypatch):
        """A participant losing the coordinator mid-join gets a bounded,
        clean RetryExhaustedError, the partial group is torn down, and
        the module never latches — a later successful join works."""
        shutdowns = []

        def lost_coordinator(**kwargs):
            raise RuntimeError(
                "DEADLINE_EXCEEDED: coordinator heartbeat lost")

        monkeypatch.setattr(dist, "init_process_group", lost_coordinator)
        monkeypatch.setattr(dist, "destroy_process_group",
                            lambda: shutdowns.append(1))
        with pytest.raises(RetryExhaustedError):
            multihost.initialize_multihost(
                coordinator_address="127.0.0.1:65501",
                num_processes=2, process_id=1,
                retry_policy=RetryPolicy(max_attempts=2,
                                         base_delay=0.01, jitter=0.0),
            )
        assert not multihost.multihost_initialized()
        assert shutdowns, "partial process group not torn down"
        monkeypatch.setattr(dist, "init_process_group",
                            lambda **kw: None)
        multihost.initialize_multihost(
            coordinator_address="127.0.0.1:65501",
            num_processes=1, process_id=0,
            retry_policy=RetryPolicy(max_attempts=1),
        )
        assert multihost.multihost_initialized()

    def test_global_mesh_refuses_unjoined_configured_env(
            self, multihost, monkeypatch):
        monkeypatch.setenv("PYDCOP_NUM_PROCESSES", "2")
        assert multihost.multihost_configured()
        with pytest.raises(RuntimeError, match="not.*initialized"):
            multihost.global_mesh(device="cpu")

    def test_global_mesh_works_single_host(self, multihost):
        assert not multihost.multihost_configured()
        mesh = multihost.global_mesh(device="cpu")
        assert mesh is not None and mesh.size >= 1


def test_join_uses_tcp_from_the_environment(multihost, joins,
                                            monkeypatch):
    monkeypatch.setenv("PYDCOP_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("PYDCOP_NUM_PROCESSES", "3")
    monkeypatch.setenv("PYDCOP_PROCESS_ID", "2")
    assert multihost.initialize_multihost(
        retry_policy=RetryPolicy(max_attempts=1)) is False
    assert joins == [{"backend": "nccl" if torch.cuda.is_available()
                      else "gloo",
                      "init_method": "tcp://10.0.0.1:1234",
                      "world_size": 3, "rank": 2}]
    assert multihost.multihost_initialized()
    # Idempotent: a second call does not join again.
    multihost.initialize_multihost()
    assert len(joins) == 1


def test_auto_joins_through_env(multihost, joins, monkeypatch):
    monkeypatch.setenv("PYDCOP_MULTIHOST", "auto")
    multihost.initialize_multihost(retry_policy=RetryPolicy(max_attempts=1))
    assert len(joins) == 1 and joins[0]["init_method"] == "env://"
    assert multihost.multihost_initialized()


def test_single_host_is_a_silent_no_op(multihost, joins):
    assert multihost.initialize_multihost() is False
    assert joins == []
    assert multihost.multihost_initialized()


def test_retry_policy_from_the_environment(multihost, monkeypatch):
    """The default policy comes from ``PYDCOP_MULTIHOST_RETRY_*``: three
    attempts here, then the clean error."""
    attempts = []

    def refuse(**kw):
        attempts.append(1)
        raise RuntimeError("connection refused")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(dist, "destroy_process_group", lambda: None)
    monkeypatch.setenv("PYDCOP_MULTIHOST_RETRY_MAX_ATTEMPTS", "3")
    monkeypatch.setenv("PYDCOP_MULTIHOST_RETRY_BASE_DELAY", "0.001")
    with pytest.raises(RetryExhaustedError):
        multihost.initialize_multihost(coordinator_address="h:1",
                                       num_processes=2, process_id=0)
    assert len(attempts) == 3
    assert not multihost.multihost_initialized()


def test_a_mesh_across_processes_is_not_ported(multihost, monkeypatch):
    monkeypatch.setattr(multihost, "_world_size", lambda: 2)
    multihost._initialized = True
    with pytest.raises(NotImplementedError, match=r"item 6\(b\)"):
        multihost.global_mesh(device="cpu")
    with pytest.raises(NotImplementedError, match=r"item 6\(b\)"):
        multihost.partitioned_mesh(2, device="cpu")


def test_partitioned_mesh_skips_the_count_when_configured(
        multihost, monkeypatch):
    """As in the reference, a configured multihost environment is not
    held to the local device count (the world is bigger), but an
    unjoined one is refused."""
    monkeypatch.setenv("PYDCOP_COORDINATOR", "h:1")
    with pytest.raises(RuntimeError, match="not.*initialized"):
        multihost.partitioned_mesh(64, device="cpu")


def test_fleet_host_id(multihost, monkeypatch):
    import socket

    assert multihost.fleet_host_id() == socket.gethostname()
    monkeypatch.setenv("PYDCOP_HOST_ID", "rack-7")
    assert multihost.fleet_host_id() == "rack-7"


def test_configured_matches_the_reference(multihost, monkeypatch):
    from pydcop_tpu.engine import multihost as jmh

    for var, value in (("PYDCOP_COORDINATOR", "h:1"),
                       ("PYDCOP_NUM_PROCESSES", "2"),
                       ("PYDCOP_MULTIHOST", "auto"),
                       ("PYDCOP_MULTIHOST", "no")):
        monkeypatch.setenv(var, value)
        assert multihost.multihost_configured() == \
            jmh.multihost_configured()
        monkeypatch.delenv(var)
    assert multihost.multihost_configured() == jmh.multihost_configured()
