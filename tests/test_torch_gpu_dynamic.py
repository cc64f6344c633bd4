"""On the card: the dynamic engine's in-place patching and a scenario
replay equal the CPU's, and ``algo="auto"`` races every leg.

This file imports neither JAX nor the JAX package.  Every test is
marked ``gpu`` and decides inside itself whether a card is present;
without one it skips.  Where JAX is missing run:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu_dynamic.py

- After every edit (cost-only changes, removals, additions on new
  scopes, a recompile, a new variable), the card's patched
  ``TorchFactorGraph`` equals ``to_device_graph`` of its host arrays on
  the card, field by field.
- ``replay_scenario`` on the card equals the CPU replay: every event's
  record, the final result, every message and count tensor.
- ``autotune_portfolio`` on the card: every leg's cost equals the same
  leg on the CPU, bit for bit.
"""

import numpy as np
import pytest
import torch

import pydcop_tpu_torch.dcop.dcop as dcop_mod
import pydcop_tpu_torch.dcop.objects as objects
import pydcop_tpu_torch.dcop.relations as relations
import pydcop_tpu_torch.dcop.scenario as scenario_mod
from pydcop_tpu_torch.device import TorchFactorGraph, to_device_graph
from pydcop_tpu_torch.engine import autotune
from pydcop_tpu_torch.engine import dynamic
from pydcop_tpu_torch.engine.compile import compile_dcop


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def coloring(n=200, seed=3):
    """A 3-colouring with random integer tables, 1.5 edges a variable."""
    rng = np.random.default_rng(seed)
    dom = objects.Domain("c", "", [0, 1, 2])
    dcop = dcop_mod.DCOP("col", objective="min")
    vs = [objects.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    seen = set()
    while len(seen) < int(1.5 * n):
        i, j = sorted(rng.choice(n, 2, replace=False))
        if (i, j) in seen:
            continue
        seen.add((i, j))
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[i], vs[j]], rng.integers(0, 5, (3, 3)).astype(float),
            f"c{len(seen)}"))
    dcop.add_agents([objects.AgentDef(f"a{k}") for k in range(4)])
    return dcop


def same_graph(a: TorchFactorGraph, b: TorchFactorGraph):
    for name in TorchFactorGraph._fields:
        x, y = getattr(a, name), getattr(b, name)
        if name == "buckets":
            for bx, by in zip(x, y, strict=True):
                for f, tx, ty in zip(bx._fields, bx, by):
                    assert (tx is None) == (ty is None), f
                    if tx is not None:
                        assert tx.device == ty.device, f
                        assert torch.equal(tx, ty), f
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        else:
            assert x == y, name


def scenario(dcop, seed=1):
    E, A = scenario_mod.DcopEvent, scenario_mod.EventAction
    rng = np.random.default_rng(seed)
    names = list(dcop.constraints)
    table = lambda: rng.integers(0, 5, (3, 3)).tolist()  # noqa: E731
    return scenario_mod.Scenario([
        E("change", actions=[A("change_factor", name=names[k],
                               table=table()) for k in range(0, 40, 3)]),
        E("move", actions=[A("remove_factor", name=names[k])
                           for k in range(40, 50)]
          + [A("add_factor", name=f"m{k}", variables=[f"v{k}", f"v{k + 7}"],
               table=table()) for k in range(10)]),
        E("wait", delay=1.0),
        E("grow", actions=[A("add_factor", name=f"g{k}",
                             variables=[f"v{k}", f"v{k + 50}"],
                             table=table()) for k in range(30)]),
        E("new", actions=[A("add_variable", name="w", domain=[0, 1, 2]),
                          A("add_factor", name="cw", variables=["w", "v3"],
                            table=table())]),
    ])


@pytest.mark.gpu
def test_patched_graph_equals_placement_on_the_card():
    _need_card()
    dcop = coloring()
    engine = dynamic.build_dynamic_engine(dcop, {"slack": 0.05})
    engine.run(30)
    for event in scenario(dcop):
        if event.is_delay:
            continue
        for action in event.actions:
            dynamic.apply_action(engine, action.type, action.args)
            same_graph(engine.placed, to_device_graph(engine.graph, "cuda"))
        engine.run(20)


@pytest.mark.gpu
@pytest.mark.parametrize("margin", [None, 0.2])
def test_replay_on_the_card_equals_the_cpu(margin):
    _need_card()
    dcop = coloring()
    outs, engines = {}, {}
    for device in ("cuda", "cpu"):
        engines[device] = dynamic.build_dynamic_engine(
            dcop, {"slack": 0.05}, device=device)
        outs[device] = dynamic.replay_scenario(
            dcop, scenario(dcop), params={"slack": 0.05}, max_cycles=100,
            event_cycles=50, decimation_margin=margin, device=device,
            engine=engines[device])
    card, cpu = outs["cuda"], outs["cpu"]
    strip = [{k: v for k, v in e.items() if k != "wall_s"}
             for e in cpu["events"]]
    assert [{k: v for k, v in e.items() if k != "wall_s"}
            for e in card["events"]] == strip
    for key in card:
        if key != "events":
            assert card[key] == cpu[key], key
    assert card["recompiles"] >= 2
    for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
        for a, b in zip(getattr(engines["cuda"]._state, field),
                        getattr(engines["cpu"]._state, field), strict=True):
            assert a.is_cuda
            assert np.array_equal(a.cpu().numpy().view(np.uint8),
                                  b.numpy().view(np.uint8)), field


@pytest.mark.gpu
def test_every_race_leg_on_the_card_equals_the_cpu():
    _need_card()
    dcop = coloring(120, seed=5)
    graph, meta = compile_dcop(dcop, noise_level=0.01)
    card = autotune._portfolio_runners(graph, 30, meta=meta, device="cuda")
    cpu = autotune._portfolio_runners(graph, 30, meta=meta, device="cpu")
    for name in card:
        a, b = card[name](), cpu[name]()
        assert np.float32(a).view(np.uint32) == np.float32(b).view(
            np.uint32), name
