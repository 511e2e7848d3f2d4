"""Block lowering: run each op's torch lowering in program order.

The port's counterpart of paddle_tpu/core/lowering.py. There the
lowerings trace into one XLA computation; here they run eagerly, each
op dispatching its own torch kernels (or hand-written CUDA kernels, see
ops/attention.py) on the context's device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .program import Block
from .registry import get_op

__all__ = ["LowerContext", "lower_op", "lower_ops", "lower_block",
           "release_schedule", "as_torch_dtype"]


class LowerContext:
    """Run-wide state across op lowerings: the device, the owning block
    and the RNG chain.

    ``rng`` is a CPU ``torch.Generator`` that only hands out seeds: each
    ``next_rng()`` draws one and returns a fresh generator on the
    context's device, so every random op gets its own stream (the
    counterpart of splitting a JAX key). A pure context (``rng=None``)
    refuses randomness, as in the JAX package."""

    def __init__(self, block: Optional[Block] = None,
                 rng: Optional[torch.Generator] = None,
                 device: torch.device = torch.device("cpu"),
                 is_test: bool = False):
        self.block = block
        self._rng = rng
        self.device = device
        self.is_test = is_test

    def next_rng(self) -> torch.Generator:
        if self._rng is None:
            raise RuntimeError(
                "op requested RNG in a pure context; register a custom grad "
                "lowering that reuses saved randomness (e.g. dropout mask)"
            )
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._rng))
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def pure(self) -> "LowerContext":
        """Context for re-running a forward lowering inside a vjp: the
        same block, device and mode, no RNG (as in the JAX package)."""
        return LowerContext(self.block, None, self.device, self.is_test)


def lower_op(ctx: LowerContext, op, env: Dict[str, Any]) -> None:
    opdef = get_op(op.type)
    ins: Dict[str, List[Any]] = {}
    for slot, names in op.inputs.items():
        ins[slot] = [env[n] if n else None for n in names]
    outs = opdef.lowering(ctx, ins, op.attrs)
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for name, val in zip(names, vals):
            if name and val is not None:
                env[name] = val


def lower_ops(ctx: LowerContext, ops, env: Dict[str, Any],
              release: Optional[List[List[str]]] = None) -> None:
    """Lower a specific op sequence in order, mutating `env`. With
    ``release``, the names in ``release[i]`` leave `env` right after op i,
    so a temporary's memory returns to the allocator after its last
    reader (the reference's eager-deletion GC)."""
    for i, op in enumerate(ops):
        try:
            lower_op(ctx, op, env)
        except Exception as e:
            raise RuntimeError(
                "while lowering op %r (inputs=%s outputs=%s): %s: %s"
                % (op.type, op.inputs, op.outputs, type(e).__name__, e)
            ) from e
        if release is not None:
            for n in release[i]:
                env.pop(n, None)


def lower_block(ctx: LowerContext, block: Block, env: Dict[str, Any],
                release: Optional[List[List[str]]] = None) -> None:
    """Run every op's lowering in program order, mutating `env`
    (name -> tensor); ``release`` as in ``lower_ops``."""
    lower_ops(ctx, block.ops, env, release)


def release_schedule(ops, keep) -> List[List[str]]:
    """For each op, the names it reads or writes for the last time in
    ``ops``, except those in ``keep`` (fetches and state): what
    ``lower_ops`` may drop after that op."""
    last: Dict[str, int] = {}
    for i, op in enumerate(ops):
        for n in op.input_names() + op.output_names():
            last[n] = i
    out: List[List[str]] = [[] for _ in ops]
    for n, i in last.items():
        if n not in keep:
            out[i].append(n)
    return out


_DTYPES = {
    "bool": torch.bool,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    # int64 is an API-boundary type, as in the JAX package: ids run as
    # int32 on the device, range-checked at the feed boundary
    # (core/executor.py feed_to_device)
    "int64": torch.int32,
}


def as_torch_dtype(dtype: str) -> torch.dtype:
    """Program dtype -> on-device torch dtype (int64 narrows to int32)."""
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise TypeError("dtype %r has no on-device torch dtype (known: %s)"
                        % (dtype, sorted(_DTYPES))) from None
