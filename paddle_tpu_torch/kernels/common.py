"""Launch checks shared by the kernel wrappers.

The counterpart of paddle_tpu/kernels/common.py, whose
``checked_pallas_call`` holds every Pallas launch to Mosaic's block rule.
A CUDA launch that breaks the card's limits is refused without running,
and ``torch.cuda.synchronize()`` does not report it, so every wrapper
checks its grid, block and shared memory here first and raises with the
numbers.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Sequence

import torch

__all__ = ["SMEM_PER_BLOCK", "MAX_THREADS_PER_BLOCK", "ceil_div",
           "check_launch", "check_tensor", "on_device", "sm_count"]

# Hopper (sm_90) limits: 227 KB of opt-in dynamic shared memory per block
SMEM_PER_BLOCK = 232448
MAX_THREADS_PER_BLOCK = 1024
_MAX_GRID = (2 ** 31 - 1, 65535, 65535)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def check_launch(what: str, grid: Sequence[int], block: Sequence[int],
                 smem_bytes: int) -> None:
    """Raise ValueError when a launch would be refused by the card."""
    if len(grid) != 3 or len(block) != 3:
        raise ValueError("%s: grid and block must have 3 dims, got %s / %s"
                         % (what, grid, block))
    for g, lim, ax in zip(grid, _MAX_GRID, "xyz"):
        if not 1 <= g <= lim:
            raise ValueError("%s: grid.%s = %d outside [1, %d]"
                             % (what, ax, g, lim))
    threads = block[0] * block[1] * block[2]
    if not 1 <= threads <= MAX_THREADS_PER_BLOCK:
        raise ValueError("%s: %d threads per block outside [1, %d]"
                         % (what, threads, MAX_THREADS_PER_BLOCK))
    if not 0 <= smem_bytes <= SMEM_PER_BLOCK:
        raise ValueError("%s: %d bytes of shared memory per block, the "
                         "card allows %d" % (what, smem_bytes,
                                             SMEM_PER_BLOCK))


def check_tensor(what: str, t: torch.Tensor, dtypes, ndim: int,
                 device: torch.device, contiguous: bool = True) -> None:
    """Raise ValueError unless ``t`` has one of ``dtypes``, ``ndim`` dims,
    lies on ``device`` and (when asked) is contiguous."""
    if t.dtype not in dtypes:
        raise ValueError("%s: dtype %s not supported (expected one of %s)"
                         % (what, t.dtype, [str(d) for d in dtypes]))
    if t.ndim != ndim:
        raise ValueError("%s: expected %d dims, got shape %s"
                         % (what, ndim, tuple(t.shape)))
    if t.device != device:
        raise ValueError("%s: on %s, expected %s" % (what, t.device, device))
    if contiguous and not t.is_contiguous():
        raise ValueError("%s: must be contiguous (strides %s for shape %s)"
                         % (what, t.stride(), tuple(t.shape)))


def on_device(device: torch.device):
    """Context that makes ``device`` the current CUDA device for a
    launch; a no-op when it already is (the common case, which then
    costs no device switch per launch)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors: the persistent grids' unit."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())
