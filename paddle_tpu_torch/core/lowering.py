"""Block lowering: run each op's torch lowering in program order.

The port's counterpart of paddle_tpu/core/lowering.py. There the
lowerings trace into one XLA computation; here they run eagerly, each
op dispatching its own torch kernels (or hand-written CUDA kernels, see
ops/attention.py) on the context's device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .amp import amp_cast
from .program import Block
from .registry import get_op

__all__ = ["LowerContext", "lower_op", "lower_ops", "lower_block",
           "release_schedule", "as_torch_dtype", "draw_seed",
           "seeded_generator"]


def draw_seed(chain: torch.Generator) -> int:
    """One seed from the RNG chain (a CPU ``torch.Generator``): what each
    random op's stream starts from. The eager step and a replayed graph
    draw through this one function, in program order."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=chain))


def seeded_generator(seed: int, device: torch.device) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


class LowerContext:
    """Run-wide state across op lowerings: the device, the owning block,
    the RNG chain and the mode flags (``is_test``, and ``amp``: the
    bf16 cast policy of core/amp.py, which ``lower_op`` applies).

    ``rng`` is a CPU ``torch.Generator`` that only hands out seeds: each
    ``next_rng()`` draws one and returns a fresh generator on the
    context's device, so every random op gets its own stream (the
    counterpart of splitting a JAX key). A pure context (``rng=None``)
    refuses randomness, as in the JAX package.

    ``graph``, when set, is the executor's hook for a step being
    recorded or captured as a CUDA graph (core/cuda_graph.py): random
    ops take its generators (``next_rng`` / ``seeded_rng``), which a
    replay re-seeds from the chain, and the fused optimizer update asks
    it which state tensors it may update in place and where to keep its
    pointer table. ``op`` is the op being lowered (set by
    ``lower_op``).

    A recompute segment (ops/recompute_ops.py) replays its forward's
    random streams in its grad: its forward context records a token per
    chain draw in ``streams`` (the seed, or with a graph hook the hook's
    slot), and the grad's re-run context hands them back from
    ``replay``, each a generator seeded like the one its token names, so
    the recomputed dropout masks are the forward's."""

    def __init__(self, block: Optional[Block] = None,
                 rng: Optional[torch.Generator] = None,
                 device: torch.device = torch.device("cpu"),
                 is_test: bool = False, amp: bool = False, graph=None):
        self.block = block
        self._rng = rng
        self.device = device
        self.is_test = is_test
        self.amp = amp
        self.graph = graph
        self.op = None
        self.streams: Optional[List[Any]] = None
        self.replay: Optional[List[Any]] = None

    def next_rng(self) -> torch.Generator:
        """The next random op's generator, seeded from the chain (in a
        recompute segment's re-run: the next of the forward's streams)."""
        if self._rng is None:
            raise RuntimeError(
                "op requested RNG in a pure context; register a custom grad "
                "lowering that reuses saved randomness (e.g. dropout mask)"
            )
        if self.replay is not None:
            if not self.replay:
                raise RuntimeError(
                    "a recomputed segment draws more random streams than "
                    "its forward drew")
            token = self.replay.pop(0)
            if self.graph is not None:
                return self.graph.same_generator(token, self.device)
            return seeded_generator(token, self.device)
        if self.graph is not None:
            gen = self.graph.chain_generator(self._rng, self.device)
            token = self.graph.last_stream()
        else:
            token = draw_seed(self._rng)
            gen = seeded_generator(token, self.device)
        if self.streams is not None:
            self.streams.append(token)
        return gen

    def seeded_rng(self, seed: int) -> torch.Generator:
        """A generator with a fixed seed (``fix_seed`` dropout, a seeded
        ``uniform_random``): the same stream at every run."""
        if self.graph is not None:
            return self.graph.fixed_generator(int(seed), self.device)
        return seeded_generator(seed, self.device)

    def pure(self) -> "LowerContext":
        """Context for re-running a forward lowering inside a vjp: the
        same block, device, modes and graph hook, no RNG (as in the JAX
        package)."""
        return LowerContext(self.block, None, self.device, self.is_test,
                            self.amp, self.graph)


def lower_op(ctx: LowerContext, op, env: Dict[str, Any]) -> None:
    opdef = get_op(op.type)
    ctx.op = op
    ins: Dict[str, List[Any]] = {}
    for slot, names in op.inputs.items():
        ins[slot] = [env[n] if n else None for n in names]
    if ctx.amp:
        # the __amp__ attr stamped by core/passes/amp_pass.py (or set per
        # op by the user) overrides the table policy
        ins = amp_cast(op.type, op.attrs, ins)
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
