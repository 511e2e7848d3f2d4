"""A plan's step captured once as a CUDA graph and replayed.

The port's counterpart of ``jax.jit(step, donate_argnums=(2,))``
(paddle_tpu/core/executor.py:942): where the JAX package traces a plan
into one XLA executable with donated state buffers, the port captures
the plan's eager step into one ``torch.cuda.CUDAGraph`` and replays it.
A replay pays the host's per-op cost (the lowerings, the generic grads'
``torch.func.vjp``, the launch calls) once, at capture.

The executor (core/executor.py) captures a plan on the card from its
second run on: the first run is eager, warms the kernels' build, the
cuBLAS handles and lazy module loading, records what a capture must
make first (``StepTrace``: the random ops' generators, the buffers of
constants and of write-only persistables) and is a real step. A graph
reads fixed addresses, which the port keeps so:

- **Feeds** are copied into static input buffers before each replay.
- **State is donated.** The graph reads each param and optimizer slot
  at the address it captured, and the step's new values land in those
  same tensors: the fused optimizer update (K6/K7) writes params and
  moments in place (``donated``), and what else the step writes back
  (the beta powers, a var an unfused op writes, a persistable the step
  only writes) is copied over its tensor at the end of the graph, in one
  multi-tensor copy: a captured state tensor, or for a write-only
  persistable a buffer made before the capture. So the scope keeps its
  tensor objects across replays, updated in place, the way a donated
  JAX array is consumed: a caller that keeps a value across a step
  clones it.
- **State the user replaced** (``scope.set_var``, ``io.load_*``,
  ``convert.params_from_jax``) is found before each replay by
  ``state_changes``: a tensor of the captured one's shape, dtype and
  device is copied into the captured tensor, and the scope gets the
  captured tensor back; anything else, or a run on another scope, is
  captured anew. The graph never reads a stale address.
- **RNG.** Each random op takes one of the graph's generators,
  registered with the graph before capture; before each replay every
  generator is re-seeded from the scope's chain (``draw_seed``, in
  program order, as the eager step draws) or with its op's fixed seed,
  so a replay draws the eager step's masks. A recompute segment's grad
  re-runs its forward's random ops on generators of their own, each
  re-seeded with the seed its forward slot took in the same replay
  (slot kind ``("same", i)``), so the recomputed masks are the
  forward's.
- **K6/K7's pointer table** is built once, at capture, and kept on the
  card by the graph (``keep_table``), in a buffer made before the
  capture: a pinned host buffer would be freed while replays still read
  it. So is each ``assign_value`` constant (``constant``): a host copy
  cannot be captured.
- **Memory.** The graphs of one executor share one memory pool
  (``pool``) and are captured on one stream (``stream``: the caching
  allocator hands a free block out again only on the stream it was
  freed on): a step's temporaries are dead once its replay has ended,
  so the graphs' pool holds about the largest graph's temporaries, not
  their sum. Nothing a later replay reads lives in the pool: feeds,
  constants and write-only persistables have buffers made before the
  capture, state is the scope's, and fetches are the pool's tensors
  only until the executor has copied them.
- **Launch counters.** A kernel wrapper counts the launch calls its
  host code makes, in the eager run and in the capture (which records
  the launch into the graph). A replay makes no launch call: the card
  runs the graph's kernels, and each kernel counts its own launches on
  the device (csrc/launch_count.cuh, ``kernels.build.device_launches``).
- **Fetches** are the graph's output tensors, overwritten by the next
  replay of any graph of the executor: the executor hands out copies.

A host sync inside a step (``.item()``, a shape read from values)
cannot be captured: the capture raises, naming the op.
"""

from __future__ import annotations

import time
import warnings
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .lowering import draw_seed, seeded_generator

__all__ = ["StepGraph", "StepTrace", "slot_seeds", "state_changes"]

CHAIN = None  # a random op whose seed comes from the chain (else: its
#               seed, or ("same", i): the seed slot i took in this step)


def _kind(slot) -> str:
    if slot is CHAIN:
        return "from the chain"
    if isinstance(slot, tuple):
        return "slot %d's seed again" % slot[1]
    return "seed %d" % slot


def slot_seeds(slots, chain) -> List[int]:
    """Each slot's seed for one step, in program order: chain draws from
    ``chain``, fixed seeds, and a ``("same", i)`` slot slot i's seed."""
    seeds: List[int] = []
    for slot in slots:
        if slot is CHAIN:
            seeds.append(draw_seed(chain))
        elif isinstance(slot, tuple):
            seeds.append(seeds[slot[1]])
        else:
            seeds.append(slot)
    return seeds


class StepTrace:
    """The graph hook of a plan's eager run on the card
    (``LowerContext.graph``). The step runs as it always does, and the
    trace records, in program order, what a capture must make before it
    begins: ``slots``, where each random op's seed came from (``CHAIN``
    or the op's fixed seed: the capture registers one generator per
    slot), and ``constants``, the (shape, dtype) of each tensor the step
    places on the card from the host (``assign_value`` constants, K6/K7's
    pointer tables: the capture allocates them outside its memory pool,
    where no captured kernel's temporaries can land)."""

    donated: Dict[str, torch.Tensor] = {}  # nothing is updated in place

    def __init__(self):
        self.slots: List[Any] = []
        self.seeds: List[int] = []  # each slot's seed in this eager run
        self.constants: List[Tuple[Tuple[int, ...], torch.dtype]] = []
        self.pure: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}

    def _generator(self, slot, seed, device):
        self.slots.append(slot)
        self.seeds.append(seed)
        return seeded_generator(seed, device)

    def chain_generator(self, chain, device):
        return self._generator(CHAIN, draw_seed(chain), device)

    def fixed_generator(self, seed, device):
        return self._generator(seed, seed, device)

    def last_stream(self) -> int:
        """The token of the generator handed out last: its slot."""
        return len(self.slots) - 1

    def same_generator(self, token, device):
        """A generator seeded as slot ``token``'s (a recompute segment's
        re-run of a random op its forward ran)."""
        return self._generator(("same", token), self.seeds[token], device)

    def constant(self, host: torch.Tensor, device) -> torch.Tensor:
        self.constants.append((tuple(host.shape), host.dtype))
        return host.to(device)

    def keep_table(self, arr: np.ndarray, device) -> torch.Tensor:
        from ..kernels.optimizer_update import pinned_upload

        self.constants.append((tuple(arr.shape), torch.int64))
        return pinned_upload(arr, device)


def state_changes(captured: Dict[str, torch.Tensor],
                  current: Dict[str, Any]) -> Tuple[List[str], List[str]]:
    """What a replay must do about the scope's state: ``(copy,
    recapture)``, the vars whose value is no longer the captured tensor,
    split into those whose new value can be copied into it (a tensor of
    the same shape, dtype and device) and those that need a new
    capture. Both empty: replay as captured."""
    copy, recapture = [], []
    for n, t in captured.items():
        v = current[n]
        if v is t:
            continue
        if isinstance(v, torch.Tensor) and v.shape == t.shape and \
                v.dtype == t.dtype and v.device == t.device:
            copy.append(n)
        else:
            recapture.append(n)
    return copy, recapture


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


class StepGraph:
    """One plan's step captured on one scope's state.

    ``step(feeds, state, rng, device, graph)`` is the plan's eager step
    (core/executor.py ``analyze_block``); ``state`` maps every var it
    reads to the scope's tensor, ``mut_state`` names those it writes
    back, ``trace`` is the eager run's ``StepTrace``, ``pool`` the memory
    pool the executor's graphs share (``torch.cuda.graph_pool_handle``)
    and ``stream`` the side stream they are captured on.
    Capturing runs nothing: ``replay`` runs the step. ``fetches`` and
    ``written`` (every written var's value: for ``mut_state`` its captured
    tensor, for a write-only persistable its buffer) hold the graph's
    outputs after a replay. ``seconds`` is the capture's host time;
    ``adopted`` counts the replaced vars copied in (``adopt``)."""

    def __init__(self, step, feeds: Dict[str, torch.Tensor],
                 state: Dict[str, Any], mut_state: Sequence[str],
                 trace: StepTrace, device: torch.device, scope, pool,
                 stream: torch.cuda.Stream):
        t0 = time.perf_counter()
        self.device = device
        self.feeds = {n: t.clone() for n, t in feeds.items()}
        self.state = dict(state)
        self.donated = {n: state[n] for n in mut_state}
        self.slots = list(trace.slots)
        self.generators = [torch.Generator(device=device)
                           for _ in self.slots]
        # made before the capture, so outside its pool: memory the pool
        # hands out mid-step may hold an earlier kernel's temporaries at
        # every replay
        self._constants = [torch.empty(shape, dtype=dtype, device=device)
                           for shape, dtype in trace.constants]
        self.targets = {n: state[n] for n in mut_state}
        self.targets.update(
            (n, torch.empty(shape, dtype=dtype, device=device))
            for n, (shape, dtype) in trace.pure.items())
        self.adopted = 0
        self.tables: List[torch.Tensor] = []  # K6/K7's, kept
        self._fills: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._next_slot = 0
        self._scope = weakref.ref(scope)
        self.graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            self.graph.register_generator_state(g)
        torch.cuda.synchronize(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream), torch.no_grad():
            # thread_local: a DevicePrefetcher's fill thread may allocate
            # and copy on its own stream while this thread captures
            self.graph.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
            try:
                # the chain is not drawn at capture: each replay draws
                fetches, written = step(self.feeds, self.state,
                                        torch.Generator(), device, self)
                self.written = self._write_back(written)
            except BaseException as e:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass  # the capture is invalid; e says why
                if not isinstance(e, Exception):
                    raise
                raise RuntimeError(
                    "CUDA graph capture of the step failed (a host "
                    "sync or another call a graph cannot hold): %s"
                    % e) from e
            with warnings.catch_warnings():
                # a step that launches nothing (a fetch of scope
                # state) captures an empty graph, which replays fine
                warnings.filterwarnings(
                    "ignore", message="The CUDA Graph is empty")
                self.graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(stream)
        if self._next_slot != len(self.slots) or \
                len(self._fills) != len(self._constants):
            raise RuntimeError(
                "the step drew %d random streams and placed %d constants "
                "under capture, %d and %d in its eager run"
                % (self._next_slot, len(self._fills), len(self.slots),
                   len(self._constants)))
        from ..kernels import tune

        self.tuned_epoch = tune.epoch()  # the table the capture read
        self.fetches = fetches
        for out, host in self._fills:
            out.copy_(host)
        self.seconds = time.perf_counter() - t0

    # ---- the LowerContext.graph hook, at capture
    def _slot(self, kind):
        i = self._next_slot
        if i >= len(self.slots) or self.slots[i] != kind:
            raise RuntimeError(
                "random op %d draws %s under capture, %s in the eager run"
                % (i, _kind(kind), "nothing" if i >= len(self.slots)
                   else _kind(self.slots[i])))
        self._next_slot += 1
        return self.generators[i]

    def chain_generator(self, chain, device):
        return self._slot(CHAIN)

    def fixed_generator(self, seed, device):
        return self._slot(seed)

    def last_stream(self) -> int:
        return self._next_slot - 1

    def same_generator(self, token, device):
        return self._slot(("same", token))

    def constant(self, host: torch.Tensor, device) -> torch.Tensor:
        """A host tensor's value on the card for the graph's life (an
        ``assign_value``): the next buffer made before the capture,
        filled right after it, before the first replay."""
        i = len(self._fills)
        if i >= len(self._constants) or \
                self._constants[i].shape != host.shape or \
                self._constants[i].dtype != host.dtype:
            raise RuntimeError(
                "constant %d is %s %s under capture, %s in the eager run"
                % (i, tuple(host.shape), host.dtype,
                   "absent" if i >= len(self._constants) else
                   "%s %s" % (tuple(self._constants[i].shape),
                              self._constants[i].dtype)))
        self._fills.append((self._constants[i], host))
        return self._constants[i]

    def keep_table(self, arr: np.ndarray, device) -> torch.Tensor:
        """K6/K7's pointer table, kept on the card for the graph's life
        (``constant``)."""
        table = self.constant(torch.from_numpy(arr), device)
        self.tables.append(table)
        return table

    def _write_back(self, written):
        """At the end of the captured step, each written var's new value
        into its tensor in ``targets``, unless the step already wrote it
        there in place; a value that shares memory with one of those
        tensors is cloned first, so no copy reads what another wrote."""
        dsts, srcs = [], []
        for n, s in self.targets.items():
            w = written[n]
            if w is s:
                continue
            if not isinstance(w, torch.Tensor) or w.shape != s.shape or \
                    w.dtype != s.dtype or w.device != s.device:
                raise RuntimeError(
                    "state var %r changes from %s %s to %s within a step; "
                    "a CUDA graph keeps state at fixed addresses"
                    % (n, tuple(s.shape), s.dtype,
                       getattr(w, "shape", type(w).__name__)))
            dsts.append(s)
            srcs.append(w)
        srcs = [w.clone() if any(_same_storage(w, d) for d in dsts) else w
                for w in srcs]
        if dsts:
            torch._foreach_copy_(dsts, srcs)
        out = dict(written)
        out.update(self.targets)
        return out

    # ---- replay
    def bound_to(self, scope) -> bool:
        return self._scope() is scope

    def adopt(self, names: Sequence[str], current: Dict[str, Any],
              scope) -> None:
        """Copy the replaced vars ``names`` (``state_changes``' first
        list) into their captured tensors, and give the scope those
        tensors back."""
        for n in names:
            self.state[n].copy_(current[n])
            scope.set_var(n, self.state[n])
        self.adopted += len(names)

    def replay(self, feeds: Dict[str, torch.Tensor],
               chain: Optional[torch.Generator]) -> None:
        """One step: the feeds into the static buffers, every generator
        re-seeded (``slot_seeds``: chain draws in program order), the
        graph launched on the current stream."""
        for n, t in feeds.items():
            self.feeds[n].copy_(t)
        for g, seed in zip(self.generators, slot_seeds(self.slots, chain)):
            g.manual_seed(seed)
        self.graph.replay()

    def release(self) -> None:
        """Free the graph, its buffers and its share of the memory pool
        (after the card has finished any replay of it): the pool's memory
        returns to the card once no graph holds it."""
        torch.cuda.synchronize(self.device)
        self.graph.reset()
        self.fetches = self.written = self.tables = self.targets = None
        self._fills = self._constants = None
