"""The binary-factor min-plus update: CUDA kernel wrapper and plain
version.

Port of the TPU kernel ``pydcop_tpu/ops/pallas_maxsum.py:54``
(``binary_factor_update``).  On a CUDA tensor the wrapper launches the
hand-written kernel ``csrc/binary_factor_update.cu`` — the binary path
of every superstep on the card, not an opt-in — and raises if the
launch fails.  On a CPU tensor it runs the plain version, which is the
same formula in torch ops (the CPU tests' path and ``chip_smoke.py``'s
yardstick of correctness).
"""

import ctypes
import functools

import torch

from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops.flush import ftz

KERNEL = "binary_factor_update"


def binary_factor_update_reference(costs: torch.Tensor,
                                   v2f: torch.Tensor) -> torch.Tensor:
    """All f2v messages of one arity-2 bucket, in the dense path's add
    order: ``(costs + m0) + m1``, min over the other axis, minus the
    receiver's own message, each add and subtract flushed to zero like
    the reference's.  costs [F, D, D], v2f [F, 2, D] -> [F, 2, D].
    """
    m0, m1 = v2f[:, 0], v2f[:, 1]
    total = ftz(ftz(costs + m0[:, :, None]) + m1[:, None, :])
    return torch.stack(
        [ftz(total.amin(dim=2) - m0), ftz(total.amin(dim=1) - m1)], dim=1)


def _check(costs: torch.Tensor, v2f: torch.Tensor):
    if costs.dtype != torch.float32 or v2f.dtype != torch.float32:
        raise TypeError(
            f"binary_factor_update takes float32, got {costs.dtype} "
            f"and {v2f.dtype}")
    if costs.dim() != 3 or costs.shape[1] != costs.shape[2]:
        raise ValueError(
            f"costs must be [F, D, D], got {tuple(costs.shape)}")
    f, d, _ = costs.shape
    if tuple(v2f.shape) != (f, 2, d):
        raise ValueError(
            f"v2f must be [F, 2, D] = {(f, 2, d)}, got {tuple(v2f.shape)}")
    if costs.device != v2f.device:
        raise ValueError(
            f"costs on {costs.device} but v2f on {v2f.device}")
    if costs.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {costs.device}")
    if not (costs.is_contiguous() and v2f.is_contiguous()):
        raise ValueError("binary_factor_update takes contiguous tensors")


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load(KERNEL)
    fn = lib.binary_factor_update_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def binary_factor_update(costs: torch.Tensor,
                         v2f: torch.Tensor) -> torch.Tensor:
    """costs [F, D, D] f32, v2f [F, 2, D] f32 -> f2v [F, 2, D] f32,
    equal to ``ops.maxsum.factor_to_var`` on the bucket.  Launches the
    CUDA kernel on the current stream for CUDA tensors; runs the plain
    version for CPU tensors."""
    _check(costs, v2f)
    if costs.device.type == "cpu":
        return binary_factor_update_reference(costs, v2f)
    f, d, _ = costs.shape
    if f * 2 * d >= 2 ** 31:
        raise ValueError(f"bucket too large for one launch: F={f}")
    if costs.device.index != torch.cuda.current_device():
        # The launcher runs on the current device: switch to the
        # tensors' card (the guard costs microseconds, so only here).
        with torch.cuda.device(costs.device):
            return binary_factor_update(costs, v2f)
    out = torch.empty_like(v2f)
    if f == 0:
        return out
    launch = _launcher()
    err = launch(costs.data_ptr(), v2f.data_ptr(), out.data_ptr(), f, d,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"binary_factor_update launch failed: CUDA error {err}")
    _build.launch_counts[KERNEL] += 1
    return out


# The lane-major entry (the Pallas kernel's own block layout: factors on
# the minor axis).

LANE = "binary_factor_update:lane"


def binary_factor_update_lane_reference(costs: torch.Tensor,
                                        v2f: torch.Tensor) -> torch.Tensor:
    """The lane layout's f2v messages of one arity-2 bucket
    (``pydcop_tpu/ops/maxsum_lane.py:298 factor_to_var``): costs [D, D,
    F], v2f [D, 2, F] -> [D, 2, F], in the same order as the edge entry,
    ``(costs + m0) + m1``, min over the other axis, minus the receiver's
    own message, each add and subtract flushed."""
    m0, m1 = v2f[:, 0], v2f[:, 1]
    total = ftz(ftz(costs + m0[:, None, :]) + m1[None, :, :])
    return torch.stack(
        [ftz(total.amin(dim=1) - m0), ftz(total.amin(dim=0) - m1)], dim=1)


def _check_lane(costs: torch.Tensor, v2f: torch.Tensor):
    if costs.dtype != torch.float32 or v2f.dtype != torch.float32:
        raise TypeError(
            f"binary_factor_update_lane takes float32, got {costs.dtype} "
            f"and {v2f.dtype}")
    if costs.dim() != 3 or costs.shape[0] != costs.shape[1]:
        raise ValueError(
            f"costs must be [D, D, F], got {tuple(costs.shape)}")
    d, _, f = costs.shape
    if tuple(v2f.shape) != (d, 2, f):
        raise ValueError(
            f"v2f must be [D, 2, F] = {(d, 2, f)}, got {tuple(v2f.shape)}")
    if costs.device != v2f.device:
        raise ValueError(
            f"costs on {costs.device} but v2f on {v2f.device}")
    if costs.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {costs.device}")
    if not (costs.is_contiguous() and v2f.is_contiguous()):
        raise ValueError("binary_factor_update_lane takes contiguous "
                         "tensors")


@functools.lru_cache(maxsize=None)
def _lane_launcher():
    fn = _build.load(KERNEL).binary_factor_update_lane_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def binary_factor_update_lane(costs: torch.Tensor,
                              v2f: torch.Tensor) -> torch.Tensor:
    """costs [D, D, F] f32, v2f [D, 2, F] f32 -> f2v [D, 2, F] f32,
    equal to the lane layout's ``factor_to_var`` on the bucket.  Launches
    the kernel's lane entry on the current stream for CUDA tensors
    (raising if the launch fails); runs the plain version for CPU
    tensors."""
    _check_lane(costs, v2f)
    if costs.device.type == "cpu":
        return binary_factor_update_lane_reference(costs, v2f)
    d, _, f = costs.shape
    if costs.numel() >= 2 ** 31 or v2f.numel() >= 2 ** 31:
        raise ValueError(f"bucket too large for one launch: F={f}, D={d}")
    if costs.device.index != torch.cuda.current_device():
        with torch.cuda.device(costs.device):
            return binary_factor_update_lane(costs, v2f)
    out = torch.empty_like(v2f)
    if f == 0 or d == 0:
        return out
    err = _lane_launcher()(costs.data_ptr(), v2f.data_ptr(),
                           out.data_ptr(), f, d,
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"binary_factor_update_lane launch failed: CUDA error {err}")
    _build.launch_counts[LANE] += 1
    return out
