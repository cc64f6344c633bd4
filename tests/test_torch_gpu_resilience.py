"""On the card: the port's segmented solve, its snapshots and its noise.

This file imports neither JAX nor the JAX package, so it also runs where
only the port is installed.  Every test is marked ``gpu`` and decides
inside itself whether a card is present; without one it skips.  Where
JAX is missing (the repository's root conftest imports it), run:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu_resilience.py

- A segmented run on the card (a snapshot every 25 cycles, written
  asynchronously) equals the card's plain run: values and every final
  message of the last snapshot.
- A snapshot written by a CPU run of the port, resumed on the card,
  ends where the card's uninterrupted run ends, bit for bit, and the
  card's snapshot at the same cycle has the CPU's checksum.
- ``utils/prng.py`` gives the same bits on the card as on the CPU, and
  so does the recovery noise (``perturb_state``).
- A recovered run (reseed, damping bump, both) on the card equals the
  CPU's, and a decimated solve on the card equals the CPU's.
"""

import numpy as np
import pytest
import torch

from pydcop_tpu_torch.algorithms import AlgorithmDef
from pydcop_tpu_torch.algorithms.maxsum import build_engine
from pydcop_tpu_torch.api import solve
from pydcop_tpu_torch.ops import maxsum as ops
from pydcop_tpu_torch.resilience.checkpoint import (
    CheckpointManager,
    load_state,
    read_meta,
    resume_from_checkpoint,
)
from pydcop_tpu_torch.resilience.recovery import (
    RecoveryPolicy,
    perturb_state,
)
from pydcop_tpu_torch.utils import prng
from pydcop_tpu_torch.utils.tree import tree_leaves
from test_torch_gpu_determinism import coloring


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CYCLES = 100
EVERY = 25


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _engines(n_vars=1_000):
    dcop = coloring(n_vars)
    params = AlgorithmDef.build_with_default_param("maxsum").params
    return (dcop, build_engine(dcop, params, device="cuda"),
            build_engine(dcop, params, device="cpu"))


def _leaves(path, engine):
    state, _ = load_state(path, engine.init_state())
    return [t.cpu().numpy() for t in tree_leaves(state)]


@pytest.mark.gpu
def test_segmented_run_equals_plain_run_on_the_card(tmp_path):
    _need_card()
    _, card, _ = _engines()
    state, values = ops.run_maxsum(card.graph, CYCLES,
                                   stop_on_convergence=False)
    plain = [t.cpu().numpy() for t in tree_leaves(state)]
    manager = CheckpointManager(str(tmp_path), every=EVERY, keep=1)
    res = card.run_checkpointed(
        CYCLES, manager=manager, stop_on_convergence=False,
        checkpoint_async=True)
    assert res.metrics["checkpoint_async"]
    assert res.metrics["segments"] == CYCLES // EVERY
    assert res.assignment == card.meta.assignment_from_indices(
        values.cpu().numpy())
    for a, b in zip(_leaves(manager.path_for(CYCLES), card), plain):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_cpu_snapshot_resumes_on_the_card(tmp_path):
    _need_card()
    _, card, cpu = _engines()
    kw = dict(segment_cycles=EVERY, stop_on_convergence=False)
    full = CheckpointManager(str(tmp_path / "card"), every=EVERY, keep=10)
    ref = card.run_checkpointed(CYCLES, manager=full, **kw)
    part = CheckpointManager(str(tmp_path / "cpu"), every=EVERY, keep=10)
    cpu.run_checkpointed(CYCLES, manager=part, max_segments=2,
                         checkpoint_async=False, **kw)
    assert read_meta(part.path_for(50))["checksum"] == read_meta(
        full.path_for(50))["checksum"]
    resumed = resume_from_checkpoint(card, part, max_cycles=CYCLES, **kw)
    assert resumed.metrics["resumed_from_cycle"] == 50
    assert resumed.assignment == ref.assignment
    assert read_meta(part.path_for(CYCLES))["checksum"] == read_meta(
        full.path_for(CYCLES))["checksum"]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1])
def test_prng_bits_on_the_card_equal_the_cpu(seed):
    _need_card()
    keys, bits = [], []
    for device in ("cuda", "cpu"):
        key = prng.fold_in(prng.PRNGKey(seed, device=device), 7)
        out = prng.uniform(key, (33, 2, 3), minval=-1e-3, maxval=1e-3)
        keys.append(key.cpu().numpy())
        bits.append(out.cpu().numpy().view(np.uint32))
    np.testing.assert_array_equal(keys[0], keys[1])
    np.testing.assert_array_equal(bits[0], bits[1])


@pytest.mark.gpu
def test_recovery_noise_on_the_card_equals_the_cpu():
    _need_card()
    _, card, cpu = _engines(300)
    states = []
    for engine in (card, cpu):
        state, _ = ops.run_maxsum(engine.graph, 20,
                                  stop_on_convergence=False)
        states.append(perturb_state(state, 1e-3, seed=5))
    for a, b in zip(tree_leaves(states[0]), tree_leaves(states[1])):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


@pytest.mark.gpu
def test_recovered_run_on_the_card_equals_the_cpu(tmp_path):
    _need_card()
    _, card, cpu = _engines(500)
    out = []
    for label, engine in (("card", card), ("cpu", cpu)):
        manager = CheckpointManager(str(tmp_path / label), every=EVERY,
                                    keep=1)
        res = engine.run_checkpointed(
            CYCLES, manager=manager, checkpoint_async=False,
            stop_on_convergence=False,
            recovery=RecoveryPolicy(trip_cycles=(25, 50, 75)))
        out.append((res, read_meta(manager.path_for(CYCLES))["checksum"],
                    engine.damping))
    (a, sum_a, damp_a), (b, sum_b, damp_b) = out
    assert a.metrics["recovery_actions"] == [
        "reseed_noise", "damping_bump", "reseed_noise+damping_bump"]
    assert a.metrics["recovery_actions"] == b.metrics["recovery_actions"]
    assert (a.assignment, sum_a, damp_a) == (b.assignment, sum_b, damp_b)


@pytest.mark.gpu
def test_decimated_solve_on_the_card_equals_the_cpu():
    _need_card()
    dcop = coloring(500)
    card, cpu = (solve(dcop, "maxsum", max_cycles=800,
                       algo_params={"decimation": 20}, device=device)
                 for device in ("cuda", "cpu"))
    assert card["metrics"]["device"].startswith("cuda")
    for key in ("assignment", "cycles", "status", "cost"):
        assert card[key] == cpu[key], key
    for key in ("decimated_vars", "decimation_rounds", "active_edges"):
        assert card["metrics"][key] == cpu["metrics"][key], key
    assert card["metrics"]["decimated_vars"] == 500
