"""Continuous batching for autoregressive GPT decode.

``models/gpt.py:generate`` drives one fixed-batch decode loop per
caller: requests that arrive mid-generation wait for the whole loop,
and a finished row idles its slot until the LONGEST request in the
batch completes. On a dispatch-latency-bound device that is the
difference between ~1/B and full utilisation. This engine owns the
batch instead:

* ONE decode executable at fixed ``b_max``
  (``gpt.build_serving_decode_step``): per-slot token/position feeds,
  per-slot visibility masks, per-slot (vmapped) KV-cache writes. The
  B cache rows are B independent slots.
* **Admission** happens at step boundaries, prefill-then-insert: a new
  prompt prefills through a batch=1 ``build_prefill_step`` executable
  (one dispatch, its own scope sharing the weight arrays by name),
  then the slot's cache rows are spliced into the big caches with one
  ``dynamic_update_slice`` per layer tensor. Prefill executables are
  cached per prompt length
  (``paddle_serving_prefill_programs_total`` counts compiles).
* **Retirement** is immediate: a sequence that hits EOS or its token
  budget frees its slot at that step boundary
  (``paddle_serving_slots_retired_total``); the next queued request is
  admitted into it while the rest of the batch keeps decoding.

Two fleet-tier levers ride the same machinery (docs/SERVING.md "The
fleet tier"):

* **Prefix/KV-cache reuse** — with a :class:`PrefixStore` attached, a
  prompt whose head matches a stored prefix splices the cached K/V
  rows (serving/prefix.py) and prefills only its suffix through ONE
  ``gpt.build_multi_token_decode_step`` dispatch; shared system
  prompts prefill once per fleet, not once per request.
* **Speculative decoding** — with a draft model attached
  (``draft_cfg``/``draft_params``/``spec_k``), greedy requests draft k
  tokens through the draft's own fixed-shape decode executable and the
  target verifies all k in ONE multi-token dispatch; accepted drafts
  advance the slot several tokens per target dispatch. Verification is
  greedy-exact, so outputs stay bitwise the plain engine's; speculative
  and plain (sampled) rows coexist in one batch — plain slots ride the
  verify dispatch using only its first position.

Requests enter through a bounded ``RequestQueue`` (backpressure,
deadlines over queue time, cancellation — serving/queue.py). Sampling
is host-side and per-request (its own seeded RandomState), so a
request's output is bitwise what ``generate()`` would produce for it
alone (in the port: its tokens, not its logits; see below) —
tests/test_serving.py and tests/test_serving_fleet.py pin that parity
with the fleet levers on and off. Occupancy telemetry:
``paddle_serving_slot_occupancy_ratio`` per decode step,
``paddle_serving_slots_active``, tokens/steps/spec/prefix counters
(docs/SERVING.md).

The port of paddle_tpu/serving/engine.py. What differs:

* **Splices write in place.** On the card each program's second run
  captures it as a CUDA graph (core/cuda_graph.py) that holds the
  scope's cache tensors at fixed addresses. So the admission splice and
  the prefix splice are ``copy_`` into views of those very tensors (the
  engine scope's [b_max, n_kv, max_len, Dh] caches, the prefill scope's
  [1, ...] ones), as ``kv_cache_write`` writes them; a new tensor
  ``set_var``'d into the scope would be copied into the captured one
  before the next replay, or make it recapture. Weights the caller
  passes become tensors on the engine's device.
* **Program builds take a lock.** ``program_guard`` and the name
  counter are process-wide, and the engine builds a prefill program per
  new prompt length on its scheduler thread: every build of every
  engine in the process holds ``_BUILD_LOCK``, so two engines (a
  router's replicas) never append ops to each other's programs. A
  caller that builds programs of its own on another thread while
  engines run builds them before starting the engines, or under the
  same lock.
* **The verify step's products run per position.** cuBLAS picks its
  algorithm by row count, so one product over b_max x S rows sums in
  another order than the decode step's over b_max rows. Every ``mul``
  of a verify program carries ``slot_rows = b_max``
  (``products_per_position``, ops/math.py) and runs S products of b_max
  rows: a verify dispatch's logits are the bits of S single steps, and
  speculative output is the plain engine's, whatever b_max and
  ``spec_k``. The decode step and the prefills keep one product.
* **A request gets ``generate()``'s tokens, not its logits.**
  ``generate()`` decodes a request alone at batch 1 and the engine at
  b_max, and a product of one row sums in another order than one of
  b_max rows (torch's on the CPU as cuBLAS's on the card): a slot's
  logits differ from batch 1's in the last bits (chip_smoke.py phase
  12c reads by how much, and which ops). The tokens agree but where two
  candidates tie within that difference; the tests and the card's
  phase 12 gate them equal on their traffic (ROADMAP §C).
* **``_cold``** marks a program's first two dispatches: on the card the
  eager first run and the capture at the second.
* ``DecodeEngine.from_artifact`` builds an engine from a deployable
  artifact's serving record and params (``export.save_artifact(None,
  params=..., serving={...})``), the router's default ``roll`` factory.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..observe import trace as _tr
from .queue import QueueFull, RequestQueue

__all__ = ["DecodeEngine", "MemoryBudgetExceeded"]


# every program build of every engine in the process: program_guard and
# the unique-name counter are process-wide state
_BUILD_LOCK = threading.RLock()


def products_per_position(prog, b_max: int) -> None:
    """Give every ``mul`` of a batch-``b_max`` multi-token program the
    ``slot_rows`` attr (ops/math.py): each product then runs once per
    position over the ``b_max`` slots, the decode step's own shape, so a
    verify dispatch's logits are the bits of single decode steps."""
    for op in prog.global_block().ops:
        if op.type == "mul":
            op.attrs["slot_rows"] = b_max


def _host_copy(t) -> np.ndarray:
    """A host numpy copy of a tensor that the caller owns (a cache view
    is overwritten by the next prefill)."""
    return t.detach().to("cpu", copy=True).numpy()


def _on_device(value, var, device) -> torch.Tensor:
    """A caller's weight (numpy or tensor) as a tensor on ``device`` at
    its var's dtype."""
    from ..core.lowering import as_torch_dtype

    t = value if isinstance(value, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(value))
    return t.to(device=device, dtype=as_torch_dtype(var.dtype))


class MemoryBudgetExceeded(QueueFull):
    """Raised at submit when the predicted-bytes admission guard
    refuses a prompt: engine-resident bytes (weights + the 2L
    decode-cache slabs) plus the prompt's predicted prefill peak exceed
    the engine's device budget (``device_budget=`` or
    ``PADDLE_TPU_DEVICE_HBM_BYTES``). A ``QueueFull`` subclass so the
    router's per-replica retry treats it like backpressure — but with
    its own counter (``paddle_serving_memory_admissions_denied_total``)
    and router rejection reason (``memory``)."""


@contextlib.contextmanager
def _null_mark(site, compiling):
    """Busy-marker no-op for lanes without a supervising engine."""
    yield


class _Slot:
    """One live sequence bound to a cache row."""

    __slots__ = ("request", "tokens", "target_len", "eos_id",
                 "temperature", "top_k", "rng", "spec")

    def __init__(self, request, prompt, n_new, eos_id, temperature,
                 top_k, seed, spec=False):
        self.request = request
        self.tokens = [int(t) for t in prompt]
        self.target_len = len(prompt) + int(n_new)
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.rng = np.random.RandomState(seed)
        # speculative slots are GREEDY requests while a draft lane is
        # attached: greedy verification is exact, sampled requests
        # take plain per-token steps in the same batch
        self.spec = bool(spec) and self.temperature == 0

    def sample(self, logits_row) -> int:
        """THE sampler generate() uses, applied to this slot's row with
        its private RandomState — a slot decodes bitwise like a B=1
        generate() with the same seed by construction."""
        from ..models.gpt import sample_token

        return sample_token(logits_row, self.rng, self.temperature,
                            self.top_k)

    def finished(self, last_token: int) -> bool:
        return (len(self.tokens) >= self.target_len
                or (self.eos_id is not None and last_token == self.eos_id))


class _Lane:
    """One model's compiled decode surface: the fixed-``b_max``
    per-slot decode executable, cached per-length prefill and
    multi-token programs, and the donated cache splice. The engine
    holds one lane for the target model and, under speculative
    decoding, a second for the draft — slot i of the draft lane
    mirrors slot i of the target."""

    def __init__(self, fluid, exe, cfg, b_max, max_len, params,
                 scope_guard, gpt, mark=None):
        from ..core.scope import Scope

        self._fluid, self._exe, self._gpt = fluid, exe, gpt
        self._scope_guard = scope_guard
        self._mark = mark if mark is not None else _null_mark
        self._runs: Dict[int, int] = {}   # program id -> dispatches
        self.cfg = cfg
        self.b_max, self.max_len = b_max, max_len
        self.scope = Scope()
        self._prefill_scope = Scope()
        self._prefill: Dict[int, tuple] = {}   # P -> (prog, logits_var)
        self._suffix: Dict[int, tuple] = {}    # S -> (prog, logits_var)
        self._multi: Dict[int, tuple] = {}     # S -> (prog, logits_var)
        self._decode_prog = fluid.Program()
        dec_start = fluid.Program()
        with scope_guard(self.scope), _BUILD_LOCK:
            with fluid.program_guard(self._decode_prog, dec_start):
                self._logits, self.cache_names = \
                    gpt.build_serving_decode_step(
                        cfg, batch=b_max, max_len=max_len)
            exe.run(dec_start, scope=self.scope)
            block = self._decode_prog.global_block()
            for n, v in (params or {}).items():
                if self.scope.find_var(n) is not None:
                    self.scope.set_var(n, _on_device(v, block.var(n),
                                                     exe.device))

    def _splice(self, slot_idx: int) -> None:
        """The prefill scope's batch=1 cache rows into slot ``slot_idx``
        of the engine scope's caches, in place: the tensors the decode
        and verify graphs captured."""
        with torch.no_grad():
            for n in self.cache_names:
                big = self.scope.find_var(n)
                big[slot_idx:slot_idx + 1].copy_(
                    self._prefill_scope.find_var(n))

    def _prefix_splice(self, rows) -> None:
        """A stored prefix's host rows [1, n_kv, L, Dh] into the head of
        the prefill scope's caches, in place, before the suffix prefill
        reads them."""
        with torch.no_grad():
            for n, r in zip(self.cache_names, rows):
                small = self._prefill_scope.find_var(n)
                small[:, :, :r.shape[2]].copy_(torch.from_numpy(r))

    # ---------------------------------------------------------- dispatch
    def _cold(self, prog) -> bool:
        """True on a program's first two dispatches through this lane
        (on the card: the eager first run, then the CUDA graph's
        capture) — the busy marker's compiling-grace signal for replica
        supervision."""
        n = self._runs.get(id(prog), 0)
        self._runs[id(prog)] = n + 1
        return n < 2

    def decode(self, token, pos):
        """One plain per-slot decode step; logits [B, 1, vocab]."""
        with self._mark("decode", self._cold(self._decode_prog)):
            with self._scope_guard(self.scope):
                (logits,) = self._exe.run(
                    self._decode_prog, feed={"token": token, "pos": pos},
                    fetch_list=[self._logits], scope=self.scope)
        return logits

    def multi_decode(self, token, pos):
        """One multi-token step over the big caches (speculative
        verification); logits [B, S, vocab]. ``pos`` rows must be
        contiguous ascending and in-range — the scheduler's fit
        predicate guarantees it."""
        prog, logits_var = self._multi_program(token.shape[1])
        with self._mark("verify", self._cold(prog)):
            with self._scope_guard(self.scope):
                (logits,) = self._exe.run(
                    prog, feed={"token": token, "pos": pos},
                    fetch_list=[logits_var], scope=self.scope)
        return logits

    # ----------------------------------------------------------- prefill
    def prefill_insert(self, slot_idx, prompt, prefix_store=None,
                       prefix_len=None):
        """Admission prefill: fill the prefill scope's batch=1 cache
        rows for the whole prompt — via one full-prompt dispatch, or,
        on a prefix-store hit, a donated splice of the stored rows plus
        one suffix dispatch — then splice the rows into the big caches
        at ``slot_idx`` (ONE jitted donated dispatch for all 2*n_layer
        tensors). Registers ``prompt[:prefix_len]`` with the store on
        first sighting. Returns the last prompt position's logits row
        (the caller samples the first token from it)."""
        P = prompt.shape[0]
        hit = prefix_store.lookup(prompt) if prefix_store is not None \
            else None
        if hit is not None:
            L, rows = hit
            with _tr.trace_span("serving.engine.suffix_prefill",
                                prompt_len=P, prefix_len=L):
                with self._scope_guard(self._prefill_scope):
                    # the suffix program must exist BEFORE the splice:
                    # its (scratch-scope) startup materializes the
                    # prefill-scope caches on first use, and the
                    # spliced rows must land in the live arrays after
                    prog, logits_var = self._suffix_program(P - L)
                    self._prefix_splice(rows)
                    pos = (L + np.arange(P - L,
                                         dtype="int64"))[None, :]
                    (full,) = self._exe.run(
                        prog, feed={"token": prompt[None, L:],
                                    "pos": pos},
                        fetch_list=[logits_var],
                        scope=self._prefill_scope)
            last = full[0, P - L - 1]
        else:
            prog, logits_var = self._prefill_program(P)
            with _tr.trace_span("serving.engine.prefill", prompt_len=P):
                with self._scope_guard(self._prefill_scope):
                    (full,) = self._exe.run(
                        prog, feed={"tokens": prompt[None, :]},
                        fetch_list=[logits_var],
                        scope=self._prefill_scope)
            last = full[0, P - 1]
        if prefix_store is not None and prefix_len:
            key = prompt[:prefix_len]
            if not prefix_store.contains(key):
                prefix_store.insert(
                    key,
                    [_host_copy(self._prefill_scope.find_var(n)
                                [:, :, :prefix_len])
                     for n in self.cache_names])
        with _tr.trace_span("serving.engine.splice", slot=slot_idx):
            self._splice(slot_idx)
        return last

    # ---------------------------------------------------------- programs
    def _prefill_program(self, P: int):
        """Batch=1 prefill executable for prompt length P, cached. All
        P's share ONE prefill scope: the [1, n_kv, max_len, Dh] caches
        have the same shape for every P, and weights are (re)copied
        from the engine scope after each new program's startup."""
        hit = self._prefill.get(P)
        if hit is not None:
            return hit
        from ..observe.families import SERVING_PREFILL_PROGRAMS

        fluid = self._fluid
        prog, start = fluid.Program(), fluid.Program()
        with self._scope_guard(self._prefill_scope):
            with _BUILD_LOCK, fluid.program_guard(prog, start):
                logits_var, cache_names = self._gpt.build_prefill_step(
                    self.cfg, batch=1, prompt_len=P, max_len=self.max_len)
            self._exe.run(start, scope=self._prefill_scope)
            self._share_weights(prog, skip={"tokens"})
        SERVING_PREFILL_PROGRAMS.inc()
        self._prefill[P] = (prog, logits_var)
        return self._prefill[P]

    def _suffix_program(self, S: int):
        """Batch=1 multi-token executable for suffix length S, cached
        per S (the prefix hit's un-cached tail). Runs in the SAME
        prefill scope as the full-prompt programs — the splice path is
        identical downstream. The engine's weights are shared in
        EXPLICITLY: a fresh engine whose first admission hits a shared
        prefix store (replica N of a fleet, a restarted replica) has
        never built a full-prefill program, so the scratch-startup
        copy in _build_multi would otherwise leave freshly-initialized
        weights in the prefill scope and silently break the
        bitwise-generate() contract."""
        hit = self._suffix.get(S)
        if hit is not None:
            return hit
        from ..observe.families import SERVING_PREFILL_PROGRAMS

        prog, logits_var = self._build_multi(1, S, self._prefill_scope)
        self._share_weights(prog, skip={"token", "pos"})
        SERVING_PREFILL_PROGRAMS.inc()
        self._suffix[S] = (prog, logits_var)
        return self._suffix[S]

    def _multi_program(self, S: int):
        """Batch=b_max multi-token executable (speculative verify),
        cached per S, sharing the ENGINE scope's live caches and
        weights."""
        hit = self._multi.get(S)
        if hit is not None:
            return hit
        self._multi[S] = self._build_multi(self.b_max, S, self.scope)
        products_per_position(self._multi[S][0], self.b_max)
        return self._multi[S]

    def _build_multi(self, batch, S, scope):
        """Build a multi-token program against ``scope``, initializing
        ONLY its program-private vars (the unnamed fc biases a fresh
        build mints): its startup runs in a scratch scope and the
        missing vars are copied over — running it in ``scope`` directly
        would re-initialize live weights and zero the caches."""
        from ..core.scope import Scope

        fluid = self._fluid
        prog, start = fluid.Program(), fluid.Program()
        with self._scope_guard(scope):
            with _BUILD_LOCK, fluid.program_guard(prog, start):
                logits_var, _ = self._gpt.build_multi_token_decode_step(
                    self.cfg, batch=batch, steps=S, max_len=self.max_len)
        scratch = Scope()
        with self._scope_guard(scratch):
            self._exe.run(start, scope=scratch)
        for n in prog.global_block().vars:
            if scope.find_var(n) is None \
                    and scratch.find_var(n) is not None:
                scope.set_var(n, scratch.find_var(n))
        return prog, logits_var

    def _share_weights(self, prog, skip):
        """Point the prefill scope at the engine scope's weight ARRAYS
        by name (cheap reference copies); never the caches — their
        batch dim differs."""
        skip = set(self.cache_names) | set(skip)
        for n in prog.global_block().vars:
            if n in skip:
                continue
            v = self.scope.find_var(n)
            if v is not None:
                self._prefill_scope.set_var(n, v)

    # ------------------------------------------------- memory estimation
    def memory_footprint(self) -> dict:
        """Static byte model of this lane (analysis/memory.py), built
        ONCE at engine construction — never from the submit path, so
        the process-global ``program_guard`` is only ever entered from
        the thread that is already building this engine's programs.

        ``resident``: predicted peak of the decode-step program
        (weights + the 2L ``[b_max, n_kv, max_len, Dh]`` cache slabs +
        one step's activations). ``prefill_extra_lo``/``_hi``: the
        NON-shared bytes a batch=1 prefill adds on top (its own caches
        + activations + the P x P attention scores; weights shared with
        the decode scope are excluded) at the two endpoint prompt
        lengths ``p_lo``/``p_hi`` — prefill cost is convex in P, so the
        chord through the endpoints brackets every P from above (the
        admission guard's per-P form)."""
        from ..analysis.memory import MemoryAnalysis

        decode = MemoryAnalysis(self._decode_prog, site="serving")
        resident = decode.peak_bytes(1)
        persist = {n for n, t in decode.tensors.items()
                   if t.kind == "persistable"}
        p_lo, p_hi = 1, max(2, self.max_len - 1)

        def extra(P: int) -> int:
            fluid = self._fluid
            prog, start = fluid.Program(), fluid.Program()
            with _BUILD_LOCK, fluid.program_guard(prog, start):
                # IR only: no startup run, no compile — the analysis
                # walks the graph, the throwaway programs are dropped
                self._gpt.build_prefill_step(
                    self.cfg, batch=1, prompt_len=P,
                    max_len=self.max_len)
            ma = MemoryAnalysis(prog, site="serving")
            shared = sum(t.poly.at(1) for n, t in ma.tensors.items()
                         if n in persist and t.kind == "persistable"
                         and t.poly is not None)
            return max(0, ma.peak_bytes(1) - shared)

        return {"resident": resident, "p_lo": p_lo, "p_hi": p_hi,
                "prefill_extra_lo": extra(p_lo),
                "prefill_extra_hi": extra(p_hi)}


class DecodeEngine:
    """Continuous-batching scheduler over one ``b_max`` decode
    executable.

    ``params`` maps parameter name -> array (the training scope's
    persistables, ``gpt_*`` names); None keeps the startup
    initialization (bench/synthetic runs). ``submit`` returns a
    ``ServingRequest`` whose ``result()`` is the full int64 token
    sequence ``[P + generated]`` (budget ``n_new``, or shorter when
    ``eos_id`` is sampled — the EOS token is included). Deadlines
    bound QUEUE time; once a sequence holds a slot it runs to
    completion. ``start()`` launches the scheduler thread; ``stop()``
    drains nothing — in-flight and queued requests fail with
    ``Cancelled``.

    Fleet-tier knobs (both default off; docs/SERVING.md):

    * ``prefix_store`` (a ``serving.PrefixStore``, shareable across
      replicas of one model) or ``prefix_cache_bytes`` (build a
      private store) enable prefix/KV-cache reuse; callers mark the
      reusable boundary per request via ``submit(prefix_len=...)``.
    * ``draft_cfg``/``draft_params`` + ``spec_k >= 1`` enable
      speculative decoding for greedy requests: the draft model drafts
      ``spec_k`` tokens per iteration, the target verifies them in one
      multi-token dispatch. The draft lane shares ``b_max``/``max_len``
      so its slots mirror the target's.
    """

    def __init__(self, cfg, params: Optional[Dict[str, np.ndarray]] = None,
                 b_max: int = 4, max_len: Optional[int] = None,
                 queue_capacity: int = 64, eos_id: Optional[int] = None,
                 place=None, prefix_store=None, prefix_cache_bytes: int = 0,
                 draft_cfg=None,
                 draft_params: Optional[Dict[str, np.ndarray]] = None,
                 spec_k: int = 0, device_budget: Optional[int] = None):
        import paddle_tpu_torch as fluid
        from ..models import gpt
        from ..core.scope import scope_guard
        from .prefix import PrefixStore

        if b_max < 1:
            raise ValueError("b_max must be >= 1")
        if spec_k < 0:
            raise ValueError("spec_k must be >= 0; got %r" % (spec_k,))
        if spec_k and draft_cfg is None:
            raise ValueError(
                "spec_k=%d needs a draft model (draft_cfg=...) to "
                "propose tokens" % spec_k)
        self.cfg = dict(cfg) if cfg else gpt.base_config()
        self.b_max = b_max
        self.max_len = (self.cfg["max_length"] if max_len is None
                        else int(max_len))
        self.eos_id = eos_id
        self._exe = fluid.Executor(place if place is not None
                                   else fluid.CUDAPlace(0))
        # busy-state stack for replica supervision (scheduler thread
        # writes, the router's monitor reads): a frame marked
        # compiling=True buys the engine the router's compile grace —
        # the Watchdog's wedge-vs-slow-compile distinction, replica-local
        self._busy_frames: list = []
        self._lane = _Lane(fluid, self._exe, self.cfg, b_max,
                           self.max_len, params, scope_guard, gpt,
                           mark=self._busy_mark)
        self.spec_k = int(spec_k)
        self._draft = None
        if draft_cfg is not None and self.spec_k >= 1:
            self._draft = _Lane(fluid, self._exe, dict(draft_cfg), b_max,
                                self.max_len, draft_params, scope_guard,
                                gpt, mark=self._busy_mark)
        if prefix_store is None and prefix_cache_bytes > 0:
            prefix_store = PrefixStore(prefix_cache_bytes)
        self.prefix_store = prefix_store
        # predicted-bytes admission guard (analysis/memory.py): the
        # byte model is built HERE, in the one thread already building
        # this engine's programs, never from submit — and a failed
        # estimate disables the guard instead of sinking construction
        from ..analysis.memory import device_budget as _env_budget

        self.device_budget = (_env_budget() if device_budget is None
                              else int(device_budget))
        try:
            self._mem = self._lane.memory_footprint()
            if self._draft is not None:
                self._mem["resident"] += \
                    self._draft.memory_footprint()["resident"]
        except Exception:
            self._mem = None
        self.queue = RequestQueue(queue_capacity)
        self._slots: list = [None] * b_max
        self._n_active = 0
        self._gauge_contrib = 0
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop,
                                        name="DecodeEngine", daemon=True)
        self._started = False
        # scheduler-progress stamp for replica supervision: the router
        # declares this engine wedged when it holds active slots and
        # the stamp goes stale (serving/router.py)
        self.last_progress = time.monotonic()

    @classmethod
    def from_artifact(cls, artifact, **overrides) -> "DecodeEngine":
        """Build an engine from a deployable artifact
        (``export.save_artifact(..., serving={"cfg": ..., ...})``):
        the artifact's serving record supplies ``cfg``/``b_max``/
        ``max_len``/``eos_id``, its params section supplies the
        weights (already per-var checksummed at load), and its
        tuned-winner slice is already installed — a replica built this
        way re-tunes nothing. ``artifact`` is a path or a
        ``LoadedArtifact``; ``overrides`` pass through to the
        constructor (``queue_capacity``, ``prefix_store``, ``place``,
        ...). The engine is built but NOT started, matching the
        router's ``engine_factory`` contract."""
        from ..export import ArtifactError, LoadedArtifact, load_artifact
        from ..observe.families import ARTIFACT_DEGRADED

        art = (artifact if isinstance(artifact, LoadedArtifact)
               else load_artifact(artifact))
        if art.serving is None:
            ARTIFACT_DEGRADED.labels(section="serving",
                                     reason="absent").inc()
            raise ArtifactError(
                "artifact %r carries no serving section — export it "
                "with serving={'cfg': ...} to build engines from it"
                % art.path)
        kw = dict(cfg=art.serving.get("cfg"),
                  params={n: np.asarray(v)
                          for n, v in art.params.items()} or None)
        for k in ("b_max", "max_len", "eos_id", "spec_k"):
            if art.serving.get(k) is not None:
                kw[k] = art.serving[k]
        kw.update(overrides)
        return cls(**kw)

    # ------------------------------------------------------------ caller
    def submit(self, prompt_ids, n_new: int, eos_id: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0, seed: int = 0,
               deadline_s: Optional[float] = None, tenant: str = "default",
               prefix_len: Optional[int] = None, trace_ctx=None,
               report: bool = True):
        """Enqueue one generation request (thread-safe). ``prompt_ids``
        is a 1-D (or [1, P]) int array; raises ``QueueFull`` under
        backpressure, ``ValueError`` on a budget that overruns the
        cache (the same check as ``generate``). ``prefix_len`` marks
        the prompt's reusable head (a shared system prompt) for the
        prefix store — ignored without one. ``tenant`` labels the
        request's terminal outcome; ``trace_ctx``/``report`` are the
        router's propagation knobs (serving/queue.py)."""
        if self._error is not None:
            raise RuntimeError("DecodeEngine failed") from self._error
        prompt = np.asarray(prompt_ids, dtype="int64").reshape(-1)
        P = prompt.shape[0]
        if P < 1:
            raise ValueError("empty prompt")
        if n_new < 1:
            raise ValueError("n_new must be >= 1; got %r" % (n_new,))
        if P + n_new > self.max_len:
            raise ValueError(
                "prompt (%d) + new tokens (%d) exceeds the engine's "
                "max_len=%d — positions past the cache would clamp and "
                "corrupt output" % (P, n_new, self.max_len))
        if temperature < 0:
            raise ValueError("temperature must be >= 0; got %r"
                             % (temperature,))
        if prefix_len is not None and not 0 < prefix_len <= P:
            raise ValueError(
                "prefix_len=%r must be in [1, prompt length %d]"
                % (prefix_len, P))
        budget = self.device_budget
        if budget is not None:
            predicted = self.predicted_bytes(P)
            if predicted is not None:
                from ..observe.families import SERVING_MEMORY_HEADROOM

                # the live headroom signal the fleet dashboard and the
                # roadmap's autoscaler watch (negative = this denial)
                SERVING_MEMORY_HEADROOM.set(budget - predicted)
            if predicted is not None and predicted > budget:
                from ..observe.families import SERVING_MEMORY_DENIED

                SERVING_MEMORY_DENIED.inc()
                raise MemoryBudgetExceeded(
                    "predicted bytes %d (resident %d + prefill(P=%d) "
                    "%d) exceed the engine's device budget %d — "
                    "admission refused before any prefill compile"
                    % (predicted, self._mem["resident"], P,
                       predicted - self._mem["resident"], budget))
        payload = dict(prompt=prompt, n_new=int(n_new),
                       eos_id=self.eos_id if eos_id is None else eos_id,
                       temperature=float(temperature), top_k=int(top_k),
                       seed=int(seed),
                       prefix_len=int(prefix_len) if prefix_len else None)
        return self.queue.submit(payload, deadline_s=deadline_s,
                                 tenant=tenant, trace_ctx=trace_ctx,
                                 report=report)

    def predicted_resident_bytes(self) -> Optional[int]:
        """Static estimate of this engine's resident device bytes
        (target + draft weights, 2L cache slabs, one decode step's
        activations) — None when the byte model could not be built.
        The bench's serving ``peak_bytes_predicted`` field."""
        return None if self._mem is None else int(self._mem["resident"])

    def predicted_bytes(self, prompt_len: int) -> Optional[int]:
        """Predicted peak while admitting a prompt of ``prompt_len``:
        resident bytes plus the prefill's non-shared extra,
        interpolated on the chord between the two analyzed endpoint
        lengths (prefill cost is convex in P, so the chord brackets
        every P from above). The admission guard's quantity."""
        if self._mem is None:
            return None
        m = self._mem
        p = min(max(int(prompt_len), m["p_lo"]), m["p_hi"])
        span = max(1, m["p_hi"] - m["p_lo"])
        extra = (m["prefill_extra_lo"]
                 + (m["prefill_extra_hi"] - m["prefill_extra_lo"])
                 * (p - m["p_lo"]) / span)
        return int(m["resident"] + max(extra, 0))

    def alive(self) -> bool:
        """Health probe for replica supervision: started, scheduler
        thread running, no terminal error."""
        return (self._started and self._error is None
                and self._thread.is_alive())

    @contextlib.contextmanager
    def _busy_mark(self, site, compiling):
        self._busy_frames.append((site, bool(compiling),
                                  time.monotonic()))
        try:
            yield
        finally:
            self._busy_frames.pop()
            self.last_progress = time.monotonic()

    def busy_compiling(self) -> bool:
        """True while the scheduler thread is inside work that may
        legitimately take seconds (program build, first-signature
        dispatch, splice jit) — the router judges a stale progress
        stamp against its compile grace instead of the stall deadline
        then (serving/router.py)."""
        frames = list(self._busy_frames)
        return any(f[1] for f in frames)

    def start(self) -> "DecodeEngine":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the scheduler. Queued requests fail with ``Cancelled``;
        sequences mid-generation fail with ``Cancelled`` too (their
        partial output is dropped). Idempotent. A shorter ``timeout``
        is the router's drain knob: a wedged scheduler thread is
        abandoned after it (daemon — it dies with the process) and its
        slot requests are failed here so the router can re-admit them
        immediately."""
        from .queue import Cancelled

        self._stop.set()
        self.queue.close()
        if self._started:
            self._thread.join(timeout=timeout)
        self._fail_slots(Cancelled("engine stopped mid-generation"))

    def __enter__(self) -> "DecodeEngine":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # --------------------------------------------------------- scheduler
    def _loop(self) -> None:
        from .queue import Cancelled

        # one trace identity for the scheduler loop: every decode-step
        # span groups under it (requests keep their own traces; the
        # step spans reference them via the "traces" attr)
        self._loop_trace = _tr.new_trace() if _tr.trace_enabled() else None
        try:
            while not self._stop.is_set():
                self.last_progress = time.monotonic()
                # admit into free slots at the step boundary; block on
                # the queue only when the whole batch is idle
                self._admit(block=self._n_active == 0)
                if self._stop.is_set():
                    return
                if self._n_active == 0:
                    continue
                self._step()
        except BaseException as exc:  # noqa: BLE001 — fail every caller loudly
            self._error = exc
            self._fail_slots(exc)  # a dead engine holds no live slots
            self.queue.close()  # pending requests fail as Cancelled
            if not isinstance(exc, Cancelled) and not self._stop.is_set():
                # a stop-requested teardown (router drain) already
                # failed the slots; re-raising into a thread nobody
                # joins would only spray a traceback
                raise
        finally:
            if self._stop.is_set():
                from .queue import Cancelled as _C

                # a slot admitted WHILE stop() was sweeping (this
                # thread was mid-_admit_one past the join timeout)
                # would otherwise strand its caller: nobody steps it
                # and stop's sweep already ran. The admitting thread
                # sweeps once more on its way out, so every admitted
                # request reaches a terminal state no matter how the
                # teardown interleaves.
                self._fail_slots(_C("engine stopped mid-generation"))

    def _fail_slots(self, exc: BaseException) -> None:
        for i, slot in enumerate(self._slots):
            if slot is not None:
                slot.request.set_exception(exc)
                self._slots[i] = None
        self._n_active = 0
        self._set_active_gauge()

    def _admit(self, block: bool) -> None:
        while self._n_active < self.b_max and not self._stop.is_set():
            req = self.queue.get(timeout=0.05 if block else 0)
            if req is None:
                return
            slot_idx = self._slots.index(None)
            try:
                self._admit_one(slot_idx, req)
            except BaseException as exc:  # noqa: BLE001
                # the pop already admitted req (queue.close can't cancel
                # it) but it isn't in a slot yet — fail it HERE or its
                # caller blocks in result() forever, then let the loop's
                # error path fail everyone else. _error is set BEFORE
                # the request fails: its done-callback may be the
                # router's, which must see a dead engine (alive() False)
                # to re-admit instead of surfacing the replica's fault
                # to the caller
                self._error = exc
                req.set_exception(exc)
                raise
            block = False  # drain without blocking once something runs

    def _admit_one(self, slot_idx: int, req) -> None:
        from ..observe.families import (SERVING_ADMITTED, SERVING_TOKENS)

        p = req.payload
        slot = _Slot(req, p["prompt"], p["n_new"], p["eos_id"],
                     p["temperature"], p["top_k"], p["seed"],
                     spec=self._draft is not None)
        # admission runs under the REQUEST's trace (explicit hand-off
        # from the caller thread via req.trace): prefill + splice child
        # spans attribute the one-time admission cost to this request.
        # The busy frame is compiling-class: admission may build and
        # compile new prefill/suffix programs and jit splices — the
        # router must judge it against its compile grace
        with self._busy_mark("admit", True):
            with _tr.trace_span("serving.engine.admit", ctx=req.trace,
                                slot=slot_idx,
                                prompt_len=len(p["prompt"])):
                last = self._lane.prefill_insert(
                    slot_idx, p["prompt"],
                    prefix_store=self.prefix_store,
                    prefix_len=p.get("prefix_len"))
                first = slot.sample(last)
                if slot.spec and not slot.finished(first):
                    # mirror the prompt into the draft lane's slot so
                    # drafting starts cache-aligned with the target
                    # (the draft never consults the prefix store: its
                    # rows would be a different model's)
                    self._draft.prefill_insert(slot_idx, p["prompt"])
        SERVING_ADMITTED.inc()
        SERVING_TOKENS.inc()
        slot.tokens.append(first)
        if slot.finished(first):
            self._retire(slot_idx, slot)
            return
        self._slots[slot_idx] = slot
        self._n_active += 1
        self._set_active_gauge()

    # ------------------------------------------------------------- steps
    def _step(self) -> None:
        from ..observe.families import SERVING_OCCUPANCY

        active = [i for i, s in enumerate(self._slots) if s is not None]
        SERVING_OCCUPANCY.observe(len(active) / float(self.b_max))
        self.last_progress = time.monotonic()
        spec_slots = [i for i in active if self._slots[i].spec]
        # a speculative iteration writes k+1 cache rows per slot; any
        # row that would clamp past max_len (corrupting valid rows —
        # dynamic_update_slice shifts an overflowing window DOWN) forces
        # the whole batch onto a plain step for this iteration
        if spec_slots and all(
                len(self._slots[i].tokens) + self.spec_k <= self.max_len
                for i in active):
            self._spec_step(active, spec_slots)
        else:
            self._plain_step(active,
                             advance_draft=bool(spec_slots))

    def _feeds(self, active):
        token = np.zeros((self.b_max, 1), dtype="int64")
        pos = np.zeros((self.b_max, 1), dtype="int64")
        for i in active:
            slot = self._slots[i]
            token[i, 0] = slot.tokens[-1]
            pos[i, 0] = len(slot.tokens) - 1
        return token, pos

    def _step_span(self, site, active):
        # one span per continuous-batching step under the engine thread;
        # "traces" lists every rider's trace id so a request's share of
        # the batched decode time is attributable post-hoc (the span is
        # shared — B slots advance in ONE dispatch by design). Attrs are
        # attached BEFORE entering: the ring copies attrs per event, so
        # only enter-time keys ride the B event (and an unfinished step
        # in a wedge dump must still name its riders)
        sp = _tr.trace_span(site, ctx=getattr(self, "_loop_trace", None))
        if sp.attrs is not None:
            sp.attrs["active"] = len(active)
            sp.attrs["traces"] = [
                self._slots[i].request.trace.trace_id for i in active
                if self._slots[i].request.trace is not None]
        return sp

    def _plain_step(self, active, advance_draft=False) -> None:
        from ..observe.families import (SERVING_DECODE_STEPS,
                                        SERVING_SPEC_DRAFT_STEPS,
                                        SERVING_TOKENS)

        token, pos = self._feeds(active)
        # free slots keep token 0 at pos 0: the write lands in a row
        # nobody reads (masked, and the next prefill-insert overwrites)
        with self._step_span("serving.engine.step", active):
            logits = self._lane.decode(token, pos)
            if advance_draft and self._draft is not None:
                # keep the draft lane's caches mirror-aligned through
                # plain iterations: a skipped position would leave a
                # never-written garbage row in every later draft's
                # visible window, silently cratering acceptance
                self._draft.decode(token, pos)
                SERVING_SPEC_DRAFT_STEPS.inc()
            SERVING_DECODE_STEPS.inc()
            SERVING_TOKENS.inc(len(active))
            for i in active:
                slot = self._slots[i]
                tok = slot.sample(logits[i, 0])
                slot.tokens.append(tok)
                if slot.finished(tok):
                    self._slots[i] = None
                    self._n_active -= 1
                    self._retire(i, slot)
            self._set_active_gauge()

    def _spec_step(self, active, spec_slots) -> None:
        """One speculative iteration: k greedy draft steps through the
        draft lane's fixed-shape decode executable, then ONE target
        verify dispatch scoring k+1 positions per slot. Greedy
        verification accepts the longest draft prefix that matches the
        target's own argmax chain — every emitted token equals what the
        plain step would have produced, bit for bit (the verify
        program's per-position attention IS the plain step's). Plain
        (sampled) slots ride the verify dispatch and use only its first
        position; their extra rows are masked garbage the next real
        write overwrites."""
        from ..models.gpt import sample_token
        from ..observe.families import (SERVING_SPEC_ACCEPTED,
                                        SERVING_SPEC_DRAFT_STEPS,
                                        SERVING_SPEC_PROPOSED,
                                        SERVING_SPEC_VERIFY_STEPS,
                                        SERVING_TOKENS)

        k = self.spec_k
        sp = self._step_span("serving.engine.spec", active)
        if sp.attrs is not None:
            sp.attrs["spec_slots"] = len(spec_slots)
            sp.attrs["k"] = k
        with sp:
            # --- draft phase: k lockstep draft-lane steps; non-spec
            # rows re-feed their real (token, pos) every round — the
            # repeated write is idempotent and keeps the feeds simple
            token, pos = self._feeds(active)
            drafts: Dict[int, List[int]] = {i: [] for i in spec_slots}
            greedy = np.random.RandomState(0)  # unused at temperature 0
            for _ in range(k):
                logits = self._draft.decode(token, pos)
                SERVING_SPEC_DRAFT_STEPS.inc()
                for i in spec_slots:
                    d = sample_token(logits[i, 0], greedy)
                    drafts[i].append(d)
                    token[i, 0] = d
                    pos[i, 0] += 1
            # --- verify phase: one multi-token target dispatch
            vtok = np.zeros((self.b_max, k + 1), dtype="int64")
            vpos = np.stack([np.arange(k + 1, dtype="int64")]
                            * self.b_max)
            for i in active:
                slot = self._slots[i]
                p0 = len(slot.tokens) - 1
                vpos[i] += p0
                vtok[i, 0] = slot.tokens[-1]
                if i in drafts:
                    vtok[i, 1:] = drafts[i]
            logits = self._lane.multi_decode(vtok, vpos)
            SERVING_SPEC_VERIFY_STEPS.inc()
            SERVING_SPEC_PROPOSED.inc(k * len(spec_slots))
            appended = 0
            for i in active:
                slot = self._slots[i]
                if i not in drafts:
                    # plain rider: position 0 IS its plain step
                    tok = slot.sample(logits[i, 0])
                    slot.tokens.append(tok)
                    appended += 1
                    if slot.finished(tok):
                        self._slots[i] = None
                        self._n_active -= 1
                        self._retire(i, slot)
                    continue
                accepted = 0
                for s in range(k + 1):
                    # row s is valid iff every draft before it matched
                    # the target's argmax chain — walked in order, so
                    # reaching s proves it
                    tok = slot.sample(logits[i, s])
                    slot.tokens.append(tok)
                    appended += 1
                    matched = s < k and tok == drafts[i][s]
                    if matched:
                        # count BEFORE the finished-break: a drafted
                        # EOS / final-budget token the verification
                        # confirmed is an acceptance, not a drop —
                        # accept_rate is THE switch-the-draft-off
                        # signal and must not systematically undercount
                        # request tails
                        accepted += 1
                    if slot.finished(tok):
                        self._slots[i] = None
                        self._n_active -= 1
                        self._retire(i, slot)
                        break
                    if s < k and not matched:
                        break  # mismatch: the draft chain is dead
                SERVING_SPEC_ACCEPTED.inc(accepted)
            SERVING_TOKENS.inc(appended)
            self._set_active_gauge()

    def _retire(self, slot_idx: int, slot: _Slot) -> None:
        from ..observe.families import SERVING_RETIRED

        SERVING_RETIRED.inc()
        if slot.request.trace is not None:
            _tr.trace_event("serving.engine.retire", ctx=slot.request.trace,
                            slot=slot_idx, tokens=len(slot.tokens))
        slot.request.set_result(np.asarray(slot.tokens, dtype="int64"))

    def _set_active_gauge(self) -> None:
        from ..observe.families import SERVING_SLOTS_ACTIVE

        # additive, not set(): N router replicas share the process-wide
        # gauge, so each engine contributes its delta and the gauge
        # reads the fleet total
        delta = self._n_active - self._gauge_contrib
        if delta:
            SERVING_SLOTS_ACTIVE.inc(delta)
            self._gauge_contrib = self._n_active
