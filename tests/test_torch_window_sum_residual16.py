"""The engine probe's residual ``jnp.sum(jnp.abs(b - a))`` over
[F, 16, D] messages against the jitted JAX reference on the CPU, bit for
bit (uint32 views): LLVM sums each row in 8 lanes (slots k and k + 8 in
lane k, each slot's D values in order) for D <= 6 windowed (F > 32) and
D <= 18 direct, in 4 lanes at D = 7-8 windowed, and left to right
beyond (optimised IR of the jitted reference, jax 0.9.0;
``window_sum.residual_lanes``).  Before, the row went left to right:
ROADMAP Queue C item 1's open residual at arity 16.
"""

import numpy as np
import pytest
import torch

from pydcop_tpu.observability.engine_probe import EngineProbe as JaxProbe
from pydcop_tpu_torch.observability.engine_probe import EngineProbe
from pydcop_tpu_torch.ops.window_sum import residual_lanes
from test_torch_window_sum_open_shapes import bits, costs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_conv = JaxProbe._build_conv_fn(None)


@pytest.mark.parametrize("f", [2, 17, 33, 100])
@pytest.mark.parametrize("d", [1, 2, 6, 7, 8, 9, 18, 19])
def test_residual_at_arity_16(f, d):
    """The probe's residual over one [F, 16, D] bucket and beside a
    [20, 2, 3] one."""
    shape = (f, 16, d)
    lanes = residual_lanes(shape)
    if d == 1:
        assert lanes == 1
    elif f > 32:
        assert lanes == (8 if d <= 6 else 4 if d <= 8 else 1)
    else:
        assert lanes == (8 if d <= 18 else 1)
    rng = np.random.default_rng(f * 100 + d)
    pv = rng.integers(0, 3, 9).astype(np.int32)
    for extra in ([], [(20, 2, 3)]):
        for decades in (1, 3, 6):
            a = [np.abs(costs(rng, s, decades)) for s in [shape] + extra]
            b = [x + costs(rng, x.shape, decades) for x in a]
            ref = _conv(tuple(a), tuple(b), pv, pv)
            out = EngineProbe._convergence(
                tuple(torch.from_numpy(x) for x in a),
                tuple(torch.from_numpy(x) for x in b),
                torch.from_numpy(pv), torch.from_numpy(pv))
            assert bits(out[0]) == bits(ref[0]), (shape, extra, decades)
