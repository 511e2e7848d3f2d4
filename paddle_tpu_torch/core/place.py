"""Device identity types.

The port's counterpart of paddle_tpu/core/place.py. A Place resolves to a
``torch.device`` without touching the card: resolving ``CUDAPlace(0)``
on a machine with no card succeeds, and the first tensor placed there
raises. Entry points run on the card unless the caller passes
``CPUPlace()``.
"""

from __future__ import annotations

import torch

__all__ = ["CPUPlace", "CUDAPinnedPlace", "CUDAPlace", "Place",
           "default_place", "require_device"]


class Place:
    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self.device_id)

    def torch_device(self) -> torch.device:
        raise NotImplementedError


class CPUPlace(Place):
    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    def torch_device(self) -> torch.device:
        return torch.device("cuda", self.device_id)


class CUDAPinnedPlace(Place):
    """Pinned host memory place (reference place.h). Staging in pinned
    memory is the feed path's own job (``feeds_to_device``), so this
    place feeds like ``CPUPlace``."""

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


def default_place() -> Place:
    """The place an entry point uses when the caller names none."""
    return CUDAPlace(0)


def require_device(device: torch.device) -> torch.device:
    """Raise when ``device`` is a card this process cannot reach: a run
    asked for the card never falls back to the CPU."""
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "%s requested but no CUDA device is available; pass "
                "CPUPlace() to run on the CPU" % device)
        if device.index is not None and \
                device.index >= torch.cuda.device_count():
            raise RuntimeError("%s requested but only %d CUDA device(s) "
                               "are visible"
                               % (device, torch.cuda.device_count()))
    return device
