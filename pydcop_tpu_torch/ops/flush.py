"""Flush-to-zero arithmetic of the plain versions.

XLA:CPU runs the reference with subnormals flushed to zero at every
floating-point operation (FTZ/DAZ), and so does the TPU; torch keeps
IEEE subnormals, and ``torch.set_flush_denormal`` reaches only the
calling thread (not torch's intra-op threads, nor the card).  So every
plain version of a superstep operation that can make a subnormal out of
normal inputs — an add, a subtract, a division, a product — is followed
by :func:`ftz`; the CUDA kernels use the ``.ftz`` instructions instead
(``csrc/*.cu``, built with ``-ftz=true``).
"""

import numpy as np
import torch

# Smallest normal float32.
FLT_MIN = float(np.finfo(np.float32).tiny)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every subnormal value replaced by a zero of its sign
    (NaN and infinities kept), as the reference's arithmetic leaves a
    subnormal result."""
    return x * (torch.abs(x) >= FLT_MIN)
