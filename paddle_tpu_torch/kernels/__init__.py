"""Kernel tier: hand-written Hopper kernels beside composed lowerings.

The port of paddle_tpu/kernels/__init__.py. The tier's fused ops —
layernorm + residual, the grouped optimizer update — take their route
from the device (ops/fused_ops.py): on the card they launch their CUDA
kernel (K4, K6 / K7), on the CPU they replay the unfused ops. Nothing is
chosen by a table there, and each kernel has one launch configuration.

What the tier still decides by measurement is flash attention's
flash-vs-composed choice per (Sq, Sk): the ``attention`` entry of the
registry (``registry.py``, registered in ops/attention.py) is what the
tuner (``tune.py``) measures on the card, and its persisted winner is
tier 2 of the precedence in ops/attention.py ``flash_effective``
(explicit ``PADDLE_TPU_FLASH_MIN_SEQ`` > tuned ``attention`` entry >
static threshold).

* ``PADDLE_TPU_KERNELS=0`` bypasses the tier: the pass pipeline builds
  no tier op (core/passes/kernel_fuse.py) and the flash precedence
  ignores the tuned table.

The port's lowerings consult the tuned table whenever they run (each
eager step, each CUDA-graph capture; a captured graph is captured anew
when the table's ``tune.epoch()`` moved), so a table change needs no
re-prepare: ``config_key()`` holds only what changes the optimized
program or outvotes the table.

Also here: the nvcc build (``build.py``) and the launch checks every
wrapper applies (``common.py``). The flash wrappers live beside their op
(ops/attention.py), the tier's in ``layernorm.py`` and
``optimizer_update.py``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from . import tune
from .common import ceil_div, check_launch, check_tensor  # noqa: F401
from .registry import (KERNELS, KernelDef, all_kernels,  # noqa: F401
                       get_kernel, has_kernel, register_kernel)
from . import layernorm, optimizer_update  # noqa: F401

__all__ = [
    "kernels_enabled", "tuned_choice", "config_key", "register_kernel",
    "get_kernel", "has_kernel", "all_kernels", "check_launch",
    "check_tensor", "KernelDef",
]


def kernels_enabled() -> bool:
    """``PADDLE_TPU_KERNELS`` master switch (default on). Off = the
    pipeline fuses nothing onto the tier and the flash precedence skips
    the tuned table."""
    return os.environ.get("PADDLE_TPU_KERNELS", "1") != "0"


def tuned_choice(op: str, sig: Tuple) -> Optional[str]:
    """'cuda' / 'composed' from the tuned table, or None when no entry
    exists (or the tier is bypassed). The flash precedence hook: never
    tunes inline."""
    if not kernels_enabled():
        return None
    dec = tune.lookup(op, sig)
    return dec["choice"] if dec else None


def config_key() -> tuple:
    """Everything that changes the optimized program or outvotes the
    tuned table — part of the executor's plan-cache key: the tier switch
    (the pipeline fuses onto the tier only when on) and the flash
    threshold, which applies in every mode."""
    return (1 if kernels_enabled() else 0,
            os.environ.get("PADDLE_TPU_FLASH_MIN_SEQ", ""))
