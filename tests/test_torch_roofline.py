"""The port's roofline accounting (pydcop_tpu_torch/engine/roofline.py)
against the reference's (pydcop_tpu/engine/roofline.py), on the CPU.

- The FLOP, byte and working-set models are the reference's: on the
  same compiled graph they give the reference's integers, on the port's
  numpy graph and on its placed torch graph alike, with the scatter and
  the ell aggregations (the reference's hand counts are asserted too).
- The peaks are the H100's datasheet numbers keyed by the card's name;
  an unknown card and the CPU get no utilization claim.
- ``hbm_util`` is claimed only when the working set does not fit in
  half the 50 MiB L2 (the reference's VMEM rule): the 10k-variable
  flagship's fits, the 1M-variable scale graph's does not.
(The reference's ``test_rejects_lane_graph`` waits for the lane
layout.)
"""

import numpy as np
import pytest
import torch

import pydcop_tpu.engine.roofline as JR
from pydcop_tpu.dcop.objects import Domain as JDomain
from pydcop_tpu.dcop.objects import Variable as JVariable
from pydcop_tpu.dcop.relations import constraint_from_str as jconstraint
from pydcop_tpu.engine.compile import (
    build_aggregation_arrays as jbuild_agg,
)
from pydcop_tpu.engine.compile import compile_factor_graph as jcompile
import pydcop_tpu_torch.engine.roofline as TR
from pydcop_tpu_torch.dcop.objects import Domain, Variable
from pydcop_tpu_torch.dcop.relations import constraint_from_str
from pydcop_tpu_torch.device import to_device_graph
from pydcop_tpu_torch.engine.compile import build_aggregation_arrays
from pydcop_tpu_torch.engine.compile import compile_factor_graph
from test_torch_compile import build_coloring_both
from test_torch_prune import loopy_graphs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _graphs(n_vars=4, arity2=3, aggregation="scatter"):
    """(reference graph, port graph) of the reference test's chain."""
    out = []
    for dom, var, cons, compile_ in (
            (JDomain, JVariable, jconstraint, jcompile),
            (Domain, Variable, constraint_from_str, compile_factor_graph)):
        d = dom("d", "", [0, 1, 2])
        vs = [var(f"v{i}", d) for i in range(n_vars)]
        cs = [cons(f"c{i}", f"v{i} + v{i + 1}", [vs[i], vs[i + 1]])
              for i in range(arity2)]
        graph, _ = compile_(vs, cs, aggregation=aggregation)
        out.append(graph)
    return out


MODELS = ("maxsum_superstep_flops", "maxsum_superstep_bytes",
          "working_set_bytes")


def _assert_same_integers(jg, tg):
    for name in MODELS:
        ref = getattr(JR, name)(jg)
        assert getattr(TR, name)(tg) == ref, name
        assert getattr(TR, name)(to_device_graph(tg, "cpu")) == ref, name


def test_hand_counts_of_the_reference():
    _, graph = _graphs()
    # V+1=5 rows, D=3, one bucket: F=3, a=2, D^a=9.
    assert TR.maxsum_superstep_flops(graph) == 15 + 108 + 522
    assert TR.maxsum_superstep_bytes(graph) == 240 + 108 + 432 + 24
    assert TR.working_set_bytes(graph) == 75 + 108 + 24 + 144 + 12


@pytest.mark.parametrize("aggregation", ["scatter", "sorted", "ell"])
@pytest.mark.parametrize("n_vars,arity2", [(4, 3), (6, 5), (12, 11)])
def test_counts_equal_the_reference(n_vars, arity2, aggregation):
    _assert_same_integers(*_graphs(n_vars, arity2, aggregation))


@pytest.mark.parametrize("problem", ["coloring300", "loopy_d16",
                                     "loopy_d33"])
def test_counts_equal_the_reference_on_larger_graphs(problem):
    if problem == "coloring300":
        from pydcop_tpu.engine.compile import compile_dcop as jcd
        from pydcop_tpu_torch.engine.compile import compile_dcop as tcd

        jd, td = build_coloring_both(300)
        jg, _ = jcd(jd, noise_level=0.01)
        tg, _ = tcd(td, noise_level=0.01)
    else:
        from pydcop_tpu.engine.compile import compile_dcop as jcd
        from pydcop_tpu_torch.engine.compile import compile_dcop as tcd
        from test_torch_prune import loopy_both

        d = int(problem.split("_d")[1])
        jd, td = loopy_both(d=d, seed=0)
        jg, _ = jcd(jd, noise_level=0.0)
        tg, _ = tcd(td, noise_level=0.0)
    _assert_same_integers(jg, tg)


def test_ell_graph_counts_list_traffic():
    jg, tg = _graphs(n_vars=6, arity2=5)
    _, _, _, _, jell = jbuild_agg(jg.buckets, jg.var_costs.shape[0], "ell")
    _, _, _, _, tell = build_aggregation_arrays(
        tg.buckets, tg.var_costs.shape[0], "ell")
    np.testing.assert_array_equal(tell, jell)
    _assert_same_integers(jg._replace(agg_ell=jell),
                          tg._replace(agg_ell=tell))


def test_report_on_the_h100_and_the_cpu():
    _, graph = _graphs()
    card = TR.roofline_report(graph, cycles_per_s=1000.0, platform="cuda",
                              device_kind="NVIDIA H100 80GB HBM3")
    expected_mfu = (TR.maxsum_superstep_flops(graph) * 1000.0
                    / TR.H100_SXM_PEAK_FLOPS_BF16)
    assert card["mfu"] == pytest.approx(expected_mfu, rel=1e-12)
    assert card["peaks_source"] == "datasheet"
    # The tiny graph fits in L2: no HBM-utilization claim.
    assert card["l2_resident"] is True
    assert card["hbm_util"] is None and card["achieved_gbps"] is None
    cpu = TR.roofline_report(graph, cycles_per_s=1000.0, platform="cpu")
    assert cpu["mfu"] is None and cpu["hbm_util"] is None
    assert cpu["l2_resident"] is None
    assert cpu["achieved_gbps"] is not None
    assert cpu["achieved_gflops"] == card["achieved_gflops"]
    assert TR.CUDA_PEAKS["NVIDIA H100 80GB HBM3"] == (989.4e12, 3.35e12)


def test_unknown_card_gets_no_utilization_claim():
    _, graph = _graphs()
    for kind in ("NVIDIA A100-SXM4-80GB", "Some Card"):
        rep = TR.roofline_report(graph, cycles_per_s=1000.0,
                                 platform="cuda", device_kind=kind)
        assert rep["mfu"] is None and rep["hbm_util"] is None
        assert rep["achieved_gflops"] > 0
        assert rep["peaks_source"] is None


def test_hbm_util_claimed_only_past_half_the_l2(monkeypatch):
    _, graph = _graphs()
    monkeypatch.setattr(TR, "H100_L2_BYTES", 2)
    rep = TR.roofline_report(graph, cycles_per_s=1000.0, platform="cuda",
                             device_kind="NVIDIA H100 80GB HBM3")
    assert rep["l2_resident"] is False
    expected = (TR.maxsum_superstep_bytes(graph) * 1000.0
                / TR.H100_SXM_HBM_BYTES_PER_S)
    assert rep["hbm_util"] == pytest.approx(expected, rel=1e-12)
    assert rep["hbm_util_exceeds_peak"] is False
    too_fast = TR.roofline_report(graph, cycles_per_s=1e12,
                                  platform="cuda",
                                  device_kind="NVIDIA H100 80GB HBM3")
    assert too_fast["hbm_util_exceeds_peak"] is True


def test_flagship_fits_the_l2_and_the_scale_graph_does_not():
    """Working sets from the shapes alone (no arrays allocated): the
    10k-variable flagship (14,999 binary factors, D = 3) and the
    1M-variable, 1.5M-factor scale graph."""
    class Arr:
        def __init__(self, shape, itemsize):
            self.shape = shape
            self.size = int(np.prod(shape))
            self.dtype = np.dtype({1: np.bool_, 4: np.float32}[itemsize])

    class Bucket:
        def __init__(self, f):
            self.costs = Arr((f, 3, 3), 4)
            self.var_ids = Arr((f, 2), 4)

    class Graph:
        def __init__(self, v, f):
            self.var_costs = Arr((v + 1, 3), 4)
            self.var_valid = Arr((v + 1, 3), 1)
            self.buckets = [Bucket(f)]
            self.agg_ell = None

    half = TR.H100_L2_BYTES // 2
    assert TR.working_set_bytes(Graph(10_000, 14_999)) < half
    assert TR.working_set_bytes(Graph(1_000_000, 1_500_000)) > half
    assert TR.working_set_bytes(Graph(10_000, 14_999)) == \
        JR.working_set_bytes(Graph(10_000, 14_999))


def test_loopy_graph_helper_is_the_port_graph():
    g, tg = loopy_graphs(d=16, seed=0)
    assert TR.maxsum_superstep_flops(tg) == JR.maxsum_superstep_flops(g)
