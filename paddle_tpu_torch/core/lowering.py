"""Block lowering: run each op's torch lowering in program order.

The port's counterpart of paddle_tpu/core/lowering.py. There the
lowerings trace into one XLA computation; here they run eagerly, each
op dispatching its own torch kernels (or hand-written CUDA kernels, see
ops/attention.py) on the context's device.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Any, Dict, List, Optional

import torch

from .amp import amp_cast
from .program import Block, op_effects
from .registry import get_op

__all__ = ["FoldedChain", "LowerContext", "lower_op", "lower_ops",
           "lower_block", "release_schedule", "as_torch_dtype", "draw_seed",
           "fold_seed", "seeded_generator"]


def draw_seed(chain: torch.Generator) -> int:
    """One seed from the RNG chain (a CPU ``torch.Generator``): what each
    random op's stream starts from. The eager step and a replayed graph
    draw through this one function, in program order."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=chain))


def fold_seed(seed: int, *path: int) -> int:
    """A seed derived from ``seed`` and the integers ``path``: the
    counterpart of ``jax.random.fold_in``. The same (seed, path) always
    gives the same seed, whatever order the derivations are made in."""
    digest = hashlib.blake2b(struct.pack("<%dq" % (1 + len(path)),
                                         int(seed), *map(int, path)),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 2


class FoldedChain:
    """An RNG chain derived from one drawn stream: draw ``j`` of a
    context over it takes ``fold_seed(seed, *path, j)``, where ``seed``
    is the seed of the stream ``token`` names (its seed in an eager
    step, its slot under a CUDA graph hook). The pipeline op gives each
    (stage, microbatch) such a chain, so its masks depend on the pair and
    not on the schedule that ran it."""

    def __init__(self, token, path):
        self.token = token
        self.path = tuple(int(p) for p in path)
        self.drawn = 0


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
    the recomputed dropout masks are the forward's.

    ``mesh`` is the ``ParallelEngine``'s mesh (parallel/mesh.py) when the
    step runs under one, with the names of its batch, tensor-parallel
    and sequence-parallel axes: the ops with a per-position algorithm
    (``fused_attention``'s ring, ``moe_ffn``'s experts, the
    ``pipeline`` schedule) read them; every other op computes with
    global semantics. ``sub`` and ``pure`` keep them.

    ``rng`` may also be a ``FoldedChain``: its draws derive from one
    stream of the enclosing step (the pipeline op's stages)."""

    def __init__(self, block: Optional[Block] = None,
                 rng: Optional[torch.Generator] = None,
                 device: torch.device = torch.device("cpu"),
                 is_test: bool = False, amp: bool = False, graph=None,
                 mesh=None, data_axis: str = "data",
                 model_axis: str = "model", seq_axis: str = "seq"):
        self.block = block
        self._rng = rng
        self.device = device
        self.is_test = is_test
        self.amp = amp
        self.graph = graph
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.seq_axis = seq_axis
        self.op = None
        self.streams: Optional[List[Any]] = None
        self.replay: Optional[List[Any]] = None

    def mesh_kw(self) -> Dict[str, Any]:
        """The mesh and its axis names, for a context made elsewhere."""
        return dict(mesh=self.mesh, data_axis=self.data_axis,
                    model_axis=self.model_axis, seq_axis=self.seq_axis)

    def next_rng(self) -> torch.Generator:
        """The next random op's generator, seeded from the chain (in a
        recompute segment's re-run: the next of the forward's streams)."""
        return self._draw()[0]

    def next_token(self):
        """Draw the next stream as ``next_rng`` does and return its token
        (its seed, or under a CUDA graph hook its slot): what a
        ``FoldedChain`` derives from."""
        return self._draw()[1]

    def _draw(self):
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
                return (self.graph.same_generator(token, self.device),
                        self.graph.last_stream())
            return seeded_generator(token, self.device), token
        if isinstance(self._rng, FoldedChain):
            chain = self._rng
            path = chain.path + (chain.drawn,)
            chain.drawn += 1
            if self.graph is not None:
                gen = self.graph.folded_generator(chain.token, path,
                                                  self.device)
                token = self.graph.last_stream()
            else:
                token = fold_seed(chain.token, *path)
                gen = seeded_generator(token, self.device)
        elif self.graph is not None:
            gen = self.graph.chain_generator(self._rng, self.device)
            token = self.graph.last_stream()
        else:
            token = draw_seed(self._rng)
            gen = seeded_generator(token, self.device)
        if self.streams is not None:
            self.streams.append(token)
        return gen, token

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
                            self.amp, self.graph, **self.mesh_kw())

    def final_rng(self):
        """The chain after this context's draws (the JAX package's key
        after a body's splits). The port's chain is one generator that
        every draw advances in place, so it is the chain itself."""
        return self._rng

    def sub(self, block: Block) -> "LowerContext":
        """Context for a control-flow op's sub-block: the same chain,
        device, modes and graph hook, and the same recorded or replayed
        streams (a recurrent op's body records into its op's list)."""
        c = LowerContext(block, self._rng, self.device, self.is_test,
                         self.amp, self.graph, **self.mesh_kw())
        c.streams, c.replay = self.streams, self.replay
        return c


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
    attrs = op.attrs
    if opdef.needs_env:
        # a control-flow op reads and rebinds the live env
        attrs = dict(op.attrs)
        attrs["__env__"] = env
    outs = opdef.lowering(ctx, ins, attrs)
    upd = outs.pop("__env_update__", None) if isinstance(outs, dict) else None
    if upd:
        env.update(upd)
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
    ``lower_ops`` may drop after that op. A control-flow op reads and
    writes what its sub-block does (``op_effects``), so a var that only
    a ``while`` or ``conditional_block`` body reads lives until that op
    has run."""
    last: Dict[str, int] = {}
    for i, op in enumerate(ops):
        reads, writes = op_effects(op.block.program, op)
        for n in reads + writes:
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
