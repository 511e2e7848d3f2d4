"""The port's serving tier (paddle_tpu_torch/serving/) on the CPU, on the
small GPT the JAX package's serving tests use.

- RequestQueue and PrefixStore: the JAX package's cases (copies of its
  modules, tests/test_torch_isolation.py pins them).
- DecodeEngine: per-request tokens bitwise the port's ``gpt.generate``
  for the request alone (greedy and seeded sampling in flight
  together), admission beyond ``b_max``, EOS retirement, validation,
  admission failure and stop. Against the JAX package's engine on the
  same params (``convert.params_from_jax``): the prefill's and a decode
  step's logits within 1e-5 (f32 matmuls and softmax sums in another
  order through 2 layers; readings at most 1.3e-6) and the greedy
  tokens equal.
- The fleet levers: prefix reuse bitwise the uncached engine (and a
  fresh engine whose first admission hits a shared store), the
  multi-token step's logits bitwise single steps', speculative decoding
  bitwise with a disagreeing draft and, with an agreeing one, k + 1
  tokens per verify dispatch.
- ReplicaRouter: routing, a tenant quota, SLO reject-early, and chaos:
  replica 0's scheduler is stopped by a fault injected at its third
  decode step (deterministic: a raise, no clock), its requests are
  readmitted onto replica 1 and restarted, every request ends exactly
  once and bitwise ``generate()``'s, and the replica is rebuilt.
- MicroBatcher over the port's CPU Predictor: coalescing, row slicing,
  the max_rows cap, validation, a failed batch and close. A batched
  answer against the same rows run alone within 1e-6 (a softmax over a
  matmul whose row count the bucket sets; the reading here is 0, but
  the JAX package's bitwise batched-against-solo claim fails on every
  run of its own suite, so the port does not make it).

No timing assertion runs here; the throughput comparisons run on the
card (chip_smoke.py phase 12). Thread tests join with timeouts.
"""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu_torch import observe
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.core.scope import Scope, scope_guard
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import (Cancelled, DeadlineExpired,
                                      DecodeEngine, MicroBatcher,
                                      PrefixStore, QueueFull, ReplicaRouter,
                                      RequestQueue, TenantQuotaExceeded)

CPU = pt.CPUPlace()
CFG = dict(d_model=32, d_ff=64, n_head=2, n_layer=2, vocab=64,
           max_length=48, dropout=0.0)
MAX_LEN = 48
DRAFT_CFG = dict(d_model=16, d_ff=32, n_head=2, n_layer=1, vocab=64,
                 max_length=48, dropout=0.0)
JAX_LOGITS_ATOL = 1e-5
BATCH_ATOL = 1e-6
TIMEOUT = 120


def _value(name, **labels):
    for s in observe.snapshot()["metrics"][name]["samples"]:
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            return s.get("value", s.get("count"))
    return 0.0


def _hist(name):
    s = observe.snapshot()["metrics"][name]["samples"][0]
    return s["count"], s["sum"]


def _engine(params, **kw):
    kw.setdefault("b_max", 2)
    kw.setdefault("max_len", MAX_LEN)
    return DecodeEngine(CFG, params=params, place=CPU, **kw)


# ------------------------------------------------------------------ queue
def test_queue_fifo_roundtrip_and_wait_telemetry():
    q = RequestQueue(capacity=4)
    w0 = _hist("paddle_serving_queue_wait_seconds")[0]
    a = q.submit("a")
    b = q.submit("b")
    assert len(q) == 2
    assert q.get().payload == "a"
    assert q.get().payload == "b"
    assert q.get(timeout=0.01) is None
    assert _hist("paddle_serving_queue_wait_seconds")[0] == w0 + 2
    a.set_result(1)
    b.set_exception(RuntimeError("boom"))
    assert a.result(timeout=1) == 1
    with pytest.raises(RuntimeError, match="boom"):
        b.result(timeout=1)
    assert isinstance(b.exception(timeout=1), RuntimeError)


def test_queue_backpressure_deadline_cancel_and_close():
    q = RequestQueue(capacity=2)
    r0 = _value("paddle_serving_queue_rejected_total")
    q.submit(1)
    q.submit(2)
    with pytest.raises(QueueFull, match="capacity 2"):
        q.submit(3)
    assert _value("paddle_serving_queue_rejected_total") == r0 + 1
    q.get()
    q.get()
    e0 = _value("paddle_serving_deadline_expirations_total")
    dead = q.submit("stale", deadline_s=0.0)
    live = q.submit("fresh")
    assert q.get(timeout=1) is live
    with pytest.raises(DeadlineExpired):
        dead.result(timeout=1)
    assert _value("paddle_serving_deadline_expirations_total") == e0 + 1
    r = q.submit("x")
    assert r.cancel() and not r.cancel()
    with pytest.raises(Cancelled):
        r.result(timeout=1)
    assert q.get(timeout=0.01) is None
    pending = [q.submit(i) for i in range(2)]
    q.close()
    for p in pending:
        with pytest.raises(Cancelled):
            p.result(timeout=1)
    with pytest.raises(RuntimeError, match="closed"):
        q.submit("late")
    with pytest.raises(ValueError):
        RequestQueue(capacity=0)


def test_queue_get_unblocks_on_concurrent_submit():
    q = RequestQueue(capacity=4)
    got = []
    t = threading.Thread(target=lambda: got.append(q.get(timeout=30)),
                         daemon=True)
    t.start()
    q.submit("wake")
    t.join(timeout=30)
    assert not t.is_alive() and got[0].payload == "wake"


# ------------------------------------------------------------ prefix store
def test_prefix_store_longest_match_lru_and_caps():
    store = PrefixStore(max_bytes=4096)
    rows = lambda L: [np.zeros((1, 2, L, 4), "float32")]  # noqa: E731
    a = np.arange(1, 9, dtype="int64")
    assert store.insert(a[:4], rows(4))
    assert not store.insert(a[:4], rows(4))
    assert store.insert(a[:6], rows(6))
    L, got = store.lookup(a)
    assert L == 6 and got[0].shape[2] == 6
    assert store.lookup(a[:5])[0] == 4
    assert store.lookup(np.array([9, 9, 9], "int64")) is None
    with pytest.raises(ValueError, match="disagree"):
        store.insert(a[:3], rows(4))
    e0 = _value("paddle_serving_prefix_evictions_total")
    store.lookup(a[:5])
    b = np.arange(20, 40, dtype="int64")
    store.insert(b[:8], [np.zeros((1, 2, 8, 62), "float32")])
    assert _value("paddle_serving_prefix_evictions_total") > e0
    assert store.contains(a[:4]) and not store.contains(a[:6])
    assert not store.insert(b[:10], [np.zeros((1, 2, 10, 64), "float32")])
    assert store.bytes_used <= 4096


# ----------------------------------------------------------------- engine
class _SeqRef:
    """The port's B=1 decode loop (``gpt.generate``): the engine's
    oracle, and the params every engine here shares (built before any
    engine thread starts)."""

    def __init__(self, params=None):
        self.prog, start = pt.Program(), pt.Program()
        self.scope = Scope()
        with pt.program_guard(self.prog, start):
            self.logits, self.cache_names = gpt.build_decode_step(
                CFG, batch=1, max_len=MAX_LEN)
        self.exe = pt.Executor(CPU)
        self.exe.run(start, scope=self.scope)
        for n, v in (params or {}).items():
            self.scope.set_var(n, v)
        self.params = {n: self.scope.find_var(n).clone()
                       for n in self.prog.global_block().vars
                       if n.startswith("gpt_") and n not in self.cache_names
                       and self.scope.find_var(n) is not None}

    def generate(self, prompt, n_new, **kw):
        with scope_guard(self.scope):
            return gpt.generate(self.exe, self.prog, self.logits,
                                prompt[None, :], n_new, self.scope,
                                **kw)[0]


@pytest.fixture(scope="module")
def seq_ref():
    return _SeqRef()


@pytest.fixture(scope="module")
def engine(seq_ref):
    eng = _engine(seq_ref.params, queue_capacity=16).start()
    yield eng
    eng.stop()


def _prompts(seed, n, length=4):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 64, (length,)).astype("int64") for _ in range(n)]


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(CFG, b_max=1, max_len=16)


def test_engine_output_matches_generate_greedy_and_sampled(engine,
                                                           seq_ref):
    p1, p2 = _prompts(2, 2)
    r1 = engine.submit(p1, 5)
    r2 = engine.submit(p2, 6, temperature=0.9, top_k=8, seed=13)
    np.testing.assert_array_equal(r1.result(timeout=TIMEOUT),
                                  seq_ref.generate(p1, 5))
    np.testing.assert_array_equal(
        r2.result(timeout=TIMEOUT),
        seq_ref.generate(p2, 6, temperature=0.9, top_k=8, seed=13))


def test_engine_admits_beyond_b_max_and_retires_slots(engine, seq_ref):
    a0 = _value("paddle_serving_slots_admitted_total")
    t0 = _value("paddle_serving_slots_retired_total")
    occ0 = _hist("paddle_serving_slot_occupancy_ratio")[0]
    prompts = _prompts(3, 4, length=3)
    budgets = [5, 3, 4, 2]
    reqs = [engine.submit(p, n) for p, n in zip(prompts, budgets)]
    for p, n, r in zip(prompts, budgets, reqs):
        np.testing.assert_array_equal(r.result(timeout=TIMEOUT),
                                      seq_ref.generate(p, n))
    assert _value("paddle_serving_slots_admitted_total") == a0 + 4
    assert _value("paddle_serving_slots_retired_total") == t0 + 4
    assert _hist("paddle_serving_slot_occupancy_ratio")[0] > occ0
    assert _value("paddle_serving_slots_active") == 0


def test_engine_eos_retires_early(engine, seq_ref):
    (p,) = _prompts(4, 1, length=3)
    gen = [int(t) for t in seq_ref.generate(p, 8)[3:]]
    eos = gen[2]
    want = gen[:gen.index(eos) + 1]
    got = engine.submit(p, 8, eos_id=eos).result(timeout=TIMEOUT)
    np.testing.assert_array_equal(got, np.concatenate([p, want]))


def test_engine_submit_validation(engine):
    p = np.array([1, 2, 3], dtype="int64")
    with pytest.raises(ValueError, match="max_len"):
        engine.submit(p, 99)
    with pytest.raises(ValueError, match="empty"):
        engine.submit(np.zeros((0,), "int64"), 2)
    with pytest.raises(ValueError, match="n_new"):
        engine.submit(p, 0)
    with pytest.raises(ValueError, match="temperature"):
        engine.submit(p, 2, temperature=-0.5)
    with pytest.raises(ValueError):
        DecodeEngine(CFG, b_max=0, place=CPU)


def test_engine_admission_failure_fails_the_popped_request(seq_ref):
    eng = _engine(seq_ref.params, queue_capacity=4)

    def boom(P):
        raise RuntimeError("prefill exploded")

    eng._lane._prefill_program = boom
    eng.start()
    r = eng.submit(np.array([1, 2, 3], dtype="int64"), 4)
    with pytest.raises(RuntimeError, match="prefill exploded"):
        r.result(timeout=30)
    eng._thread.join(timeout=30)
    assert not eng._thread.is_alive()
    with pytest.raises(RuntimeError, match="DecodeEngine failed"):
        eng.submit(np.array([1], dtype="int64"), 2)
    eng.stop()


def test_engine_stop_cancels_queued_requests(seq_ref):
    eng = _engine(seq_ref.params, b_max=1, queue_capacity=4)
    r = eng.submit(np.array([1, 2], dtype="int64"), 3)
    eng.stop()
    with pytest.raises(Cancelled):
        r.result(timeout=1)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(np.array([1], dtype="int64"), 2)


def test_engine_splices_write_the_captured_caches_in_place(seq_ref):
    """The admission splice writes into the engine scope's cache
    tensors, never a new tensor: a captured decode graph holds them."""
    eng = _engine(seq_ref.params)
    names = eng._lane.cache_names
    before = [eng._lane.scope.find_var(n) for n in names]
    (p,) = _prompts(6, 1, length=5)
    eng._lane.prefill_insert(1, p)
    for n, t in zip(names, before):
        assert eng._lane.scope.find_var(n) is t
        small = eng._lane._prefill_scope.find_var(n)
        assert torch.equal(t[1:2], small)
    eng.stop()


# ------------------------------------------------ against the JAX package
def test_engine_matches_the_jax_package_engine(seq_ref):
    from paddle_tpu.serving import DecodeEngine as JaxEngine

    jparams = {n: v.numpy() for n, v in seq_ref.params.items()}
    jeng = JaxEngine(CFG, params=jparams, b_max=2, max_len=MAX_LEN)
    eng = _engine(seq_ref.params)
    prompts = _prompts(7, 3, length=5)
    # the lanes' logits: a prefill, then one decode step of both slots
    for i, p in enumerate(prompts[:2]):
        want = np.asarray(jeng._lane.prefill_insert(i, p))
        got = eng._lane.prefill_insert(i, p)
        np.testing.assert_allclose(got, want, atol=JAX_LOGITS_ATOL, rtol=0)
    token = np.array([[3], [7]], "int64")
    pos = np.array([[5], [5]], "int64")
    np.testing.assert_allclose(eng._lane.decode(token, pos),
                               np.asarray(jeng._lane.decode(token, pos)),
                               atol=JAX_LOGITS_ATOL, rtol=0)
    jeng.stop()
    eng.stop()
    # greedy tokens of whole requests through both engines
    jeng = JaxEngine(CFG, params=jparams, b_max=2, max_len=MAX_LEN).start()
    eng = _engine(seq_ref.params).start()
    try:
        jr = [jeng.submit(p, 8) for p in prompts]
        tr = [eng.submit(p, 8) for p in prompts]
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(b.result(timeout=TIMEOUT),
                                          a.result(timeout=TIMEOUT))
    finally:
        jeng.stop()
        eng.stop()


def test_params_from_the_jax_package_serve_alike(seq_ref):
    """A JAX-package GPT scope moved with ``params_from_jax`` serves in
    the port's engine like the port's ``generate`` on that scope."""
    from paddle_tpu.models import gpt as jgpt

    prog, start = jf.Program(), jf.Program()
    with jf.program_guard(prog, start), jf.unique_name.guard():
        jgpt.build_decode_step(CFG, batch=1, max_len=MAX_LEN)
    jscope = jf.Scope()
    jf.Executor(jf.CPUPlace()).run(start, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in prog.list_vars() if v.persistable}
    tprog = pt.Program()
    with pt.program_guard(tprog, pt.Program()), pt.unique_name.guard():
        gpt.build_decode_step(CFG, batch=1, max_len=MAX_LEN)
    moved = params_from_jax(state, tprog, torch.device("cpu"))
    ref = _SeqRef({n: v for n, v in moved.items() if n.startswith("gpt_")})
    eng = _engine(ref.params).start()
    try:
        (p,) = _prompts(8, 1)
        np.testing.assert_array_equal(eng.submit(p, 6).result(
            timeout=TIMEOUT), ref.generate(p, 6))
    finally:
        eng.stop()


# ------------------------------------------------- multi-token decode step
def test_multi_token_step_bitwise_matches_single_steps():
    """Logits of a 3-token dispatch == three single-token dispatches,
    bit for bit, and the cache state it leaves drives the next step
    alike: both fleet levers rest on it."""
    B, S = 2, 3
    toks = np.random.RandomState(0).randint(1, 64, (B, 8)).astype("int64")
    exe = pt.Executor(CPU)
    ref_scope, scope = Scope(), Scope()
    dec, dstart = pt.Program(), pt.Program()
    with pt.program_guard(dec, dstart):
        lg, _ = gpt.build_serving_decode_step(CFG, batch=B, max_len=16)
    multi, mstart = pt.Program(), pt.Program()
    with pt.program_guard(multi, mstart):
        mlg, _ = gpt.build_multi_token_decode_step(CFG, batch=B, steps=S,
                                                   max_len=16)
    exe.run(dstart, scope=ref_scope)
    ref = []
    for t in range(7):
        (lv,) = exe.run(dec, feed={"token": toks[:, t:t + 1],
                                   "pos": np.full((B, 1), t, "int64")},
                        fetch_list=[lg], scope=ref_scope)
        ref.append(lv.copy())
    exe.run(dstart, scope=scope)
    for n in dec.global_block().vars:
        if not n.endswith(("_cache_k", "_cache_v")) and \
                ref_scope.find_var(n) is not None:
            scope.set_var(n, ref_scope.find_var(n))
    scratch = Scope()
    exe.run(mstart, scope=scratch)
    for n in multi.global_block().vars:
        if scope.find_var(n) is None and scratch.find_var(n) is not None:
            scope.set_var(n, scratch.find_var(n))
    for t in range(3):
        exe.run(dec, feed={"token": toks[:, t:t + 1],
                           "pos": np.full((B, 1), t, "int64")},
                fetch_list=[lg], scope=scope)
    (mv,) = exe.run(multi, feed={
        "token": toks[:, 3:6],
        "pos": np.stack([np.arange(3, 6)] * B).astype("int64")},
        fetch_list=[mlg], scope=scope)
    for s in range(S):
        np.testing.assert_array_equal(mv[:, s], ref[3 + s][:, 0])
    (lv6,) = exe.run(dec, feed={"token": toks[:, 6:7],
                                "pos": np.full((B, 1), 6, "int64")},
                     fetch_list=[lg], scope=scope)
    np.testing.assert_array_equal(lv6, ref[6])


def test_verify_programs_run_products_per_position(seq_ref):
    """Only the engine's verify programs carry ``slot_rows``: each of
    their ``mul`` ops runs once per position over the b_max slots
    (ops/math.py), the bits of the decode step's product of those rows;
    the decode step and the prefills keep one product."""
    from paddle_tpu_torch.core.lowering import LowerContext
    from paddle_tpu_torch.core.registry import get_op

    (p,) = _prompts(4, 1, length=5)
    eng = _engine(seq_ref.params, draft_cfg=DRAFT_CFG, spec_k=3).start()
    try:
        np.testing.assert_array_equal(eng.submit(p, 10).result(
            timeout=TIMEOUT), seq_ref.generate(p, 10))
    finally:
        eng.stop()
    lane = eng._lane

    def muls(progs):
        return [op for prog in progs for op in prog.global_block().ops
                if op.type == "mul"]

    verify = muls(prog for prog, _ in lane._multi.values())
    assert verify and all(op.attrs["slot_rows"] == 2 for op in verify)
    plain = muls([lane._decode_prog] + [prog for prog, _ in
                                         lane._prefill.values()])
    assert plain and not any("slot_rows" in op.attrs for op in plain)

    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 4, 32).astype("float32"))
    w = torch.from_numpy(rs.randn(32, 48).astype("float32"))
    ctx = LowerContext(None, None, torch.device("cpu"))

    def mul(a, **attrs):
        return get_op("mul").lowering(
            ctx, {"X": [a], "Y": [w]}, dict(x_num_col_dims=2, **attrs)
        )["Out"][0]

    got = mul(x, slot_rows=2)
    for s in range(4):
        assert torch.equal(got[:, s], mul(x[:, s:s + 1].contiguous())[:, 0])
    with pytest.raises(ValueError, match="slot_rows=2"):
        mul(x.reshape(1, 8, 32)[:, :7], slot_rows=2)


# ----------------------------------------------------- prefix-cached engine
def test_prefix_cache_bitwise_outputs_and_telemetry(seq_ref):
    rs = np.random.RandomState(3)
    shared = rs.randint(1, 64, (10,)).astype("int64")
    prompts = [np.concatenate([shared,
                               rs.randint(1, 64, (4,)).astype("int64")])
               for _ in range(4)]
    eng = _engine(seq_ref.params, prefix_store=PrefixStore(64 << 20))
    eng.start()
    try:
        h0 = _value("paddle_serving_prefix_hits_total")
        m0 = _value("paddle_serving_prefix_misses_total")
        s0 = _value("paddle_serving_prefix_tokens_saved_total")
        outs = [eng.submit(p, 6, prefix_len=10).result(timeout=TIMEOUT)
                for p in prompts]
        for p, o in zip(prompts, outs):
            np.testing.assert_array_equal(o, seq_ref.generate(p, 6))
        assert _value("paddle_serving_prefix_misses_total") == m0 + 1
        assert _value("paddle_serving_prefix_hits_total") == h0 + 3
        assert _value("paddle_serving_prefix_tokens_saved_total") == \
            s0 + 3 * 10
        assert len(eng.prefix_store) == 1
        got = eng.submit(prompts[0], 6, prefix_len=10, temperature=0.9,
                         top_k=8, seed=11).result(timeout=TIMEOUT)
        np.testing.assert_array_equal(
            got, seq_ref.generate(prompts[0], 6, temperature=0.9, top_k=8,
                                  seed=11))
    finally:
        eng.stop()


def test_prefix_store_shared_across_fresh_engine_stays_bitwise(seq_ref):
    params = {n: v * 1.5 for n, v in seq_ref.params.items()}
    ref = _SeqRef(params)
    rs = np.random.RandomState(14)
    shared = rs.randint(1, 64, (8,)).astype("int64")
    p1, p2 = (np.concatenate([shared, rs.randint(1, 64, (3,)).astype(
        "int64")]) for _ in range(2))
    store = PrefixStore(16 << 20)
    eng_a = _engine(params, b_max=1, prefix_store=store).start()
    try:
        np.testing.assert_array_equal(
            eng_a.submit(p1, 5, prefix_len=8).result(timeout=TIMEOUT),
            ref.generate(p1, 5))
    finally:
        eng_a.stop()
    eng_b = _engine(params, b_max=1, prefix_store=store).start()
    try:
        h0 = _value("paddle_serving_prefix_hits_total")
        out = eng_b.submit(p2, 5, prefix_len=8).result(timeout=TIMEOUT)
        assert _value("paddle_serving_prefix_hits_total") == h0 + 1
        np.testing.assert_array_equal(out, ref.generate(p2, 5))
    finally:
        eng_b.stop()


def test_prefix_len_validation_and_no_store(seq_ref):
    eng = _engine(seq_ref.params, b_max=1, prefix_cache_bytes=1 << 20)
    p = np.arange(1, 9, dtype="int64")
    with pytest.raises(ValueError, match="prefix_len"):
        eng.submit(p, 4, prefix_len=0)
    with pytest.raises(ValueError, match="prefix_len"):
        eng.submit(p, 4, prefix_len=9)
    eng.stop()
    eng = _engine(seq_ref.params, b_max=1).start()
    fams = ("paddle_serving_prefix_hits_total",
            "paddle_serving_prefix_misses_total",
            "paddle_serving_prefix_inserts_total")
    try:
        before = {f: _value(f) for f in fams}
        eng.submit(p, 4, prefix_len=4).result(timeout=TIMEOUT)
        assert {f: _value(f) for f in fams} == before
    finally:
        eng.stop()


# ------------------------------------------------------- speculative decode
def test_spec_decode_bitwise_with_disagreeing_draft(seq_ref):
    p1, p2 = _prompts(4, 2, length=5)
    eng = _engine(seq_ref.params, draft_cfg=DRAFT_CFG, spec_k=3).start()
    try:
        pr0 = _value("paddle_serving_spec_proposed_tokens_total")
        r1 = eng.submit(p1, 10)
        r2 = eng.submit(p2, 8, temperature=0.9, top_k=8, seed=13)
        np.testing.assert_array_equal(r1.result(timeout=TIMEOUT),
                                      seq_ref.generate(p1, 10))
        np.testing.assert_array_equal(
            r2.result(timeout=TIMEOUT),
            seq_ref.generate(p2, 8, temperature=0.9, top_k=8, seed=13))
        assert _value("paddle_serving_spec_proposed_tokens_total") > pr0
    finally:
        eng.stop()


def test_spec_decode_agreeing_draft_accepts_k_per_dispatch(seq_ref):
    (p,) = _prompts(5, 1)
    eng = _engine(seq_ref.params, b_max=1, draft_cfg=CFG,
                  draft_params=seq_ref.params, spec_k=3).start()
    try:
        pr0 = _value("paddle_serving_spec_proposed_tokens_total")
        a0 = _value("paddle_serving_spec_accepted_tokens_total")
        v0 = _value("paddle_serving_spec_verify_steps_total")
        out = eng.submit(p, 13).result(timeout=TIMEOUT)
        np.testing.assert_array_equal(out, seq_ref.generate(p, 13))
        proposed = _value("paddle_serving_spec_proposed_tokens_total") - pr0
        accepted = _value("paddle_serving_spec_accepted_tokens_total") - a0
        assert accepted == proposed > 0
        assert _value("paddle_serving_spec_verify_steps_total") - v0 == 3
    finally:
        eng.stop()


def test_spec_decode_plain_fallback_near_cache_end(seq_ref):
    """5 prompt tokens + 11 new = max_len 16 with an agreeing draft: the
    admission's token and two verify dispatches of k + 1 make 14 tokens,
    where a third slab of k + 1 rows would run past the cache, so the
    last two tokens take plain steps, and stay bitwise."""
    (p,) = _prompts(6, 1, length=5)
    eng = DecodeEngine(CFG, params=seq_ref.params, b_max=1, max_len=16,
                       place=CPU, draft_cfg=CFG,
                       draft_params=seq_ref.params, spec_k=3).start()
    try:
        d0 = _value("paddle_serving_decode_steps_total")
        v0 = _value("paddle_serving_spec_verify_steps_total")
        out = eng.submit(p, 11).result(timeout=TIMEOUT)
        np.testing.assert_array_equal(out, seq_ref.generate(p, 11))
        assert _value("paddle_serving_spec_verify_steps_total") - v0 == 2
        assert _value("paddle_serving_decode_steps_total") - d0 == 2
    finally:
        eng.stop()


# ------------------------------------------------------------------ router
def _factory(seq_ref, store=None, b_max=2, faults=None):
    def factory(idx):
        eng = _engine(seq_ref.params, b_max=b_max, prefix_store=store,
                      queue_capacity=16)
        if faults is not None and faults.get(idx):
            _inject(eng, faults.pop(idx))
        return eng
    return factory


def _inject(eng, at_call):
    """Replica fault: the engine's ``at_call``-th decode dispatch raises,
    which ends its scheduler thread (the engine fails its slots)."""
    decode, calls = eng._lane.decode, [0]

    def faulty(token, pos):
        calls[0] += 1
        if calls[0] == at_call:
            raise RuntimeError("injected replica fault")
        return decode(token, pos)

    eng._lane.decode = faulty


def _wait_until(cond, what, timeout_s=TIMEOUT):
    ev = threading.Event()
    for _ in range(int(timeout_s / 0.05)):
        if cond():
            return
        ev.wait(0.05)
    assert cond(), "timed out waiting for " + what


def test_router_routes_quota_and_tenant_label(seq_ref):
    router = ReplicaRouter(_factory(seq_ref), n_replicas=2,
                           tenant_quotas={"burst": 1})
    try:
        ok0 = _value("paddle_serving_requests_total", outcome="ok",
                     tenant="burst")
        prompts = _prompts(7, 6)
        reqs = [router.submit(p, 6) for p in prompts]
        b1 = router.submit(prompts[0], 6, tenant="burst")
        with pytest.raises(TenantQuotaExceeded):
            router.submit(prompts[1], 6, tenant="burst")
        for p, r in zip(prompts, reqs):
            np.testing.assert_array_equal(r.result(timeout=TIMEOUT),
                                          seq_ref.generate(p, 6))
        np.testing.assert_array_equal(b1.result(timeout=TIMEOUT),
                                      seq_ref.generate(prompts[0], 6))
        router.submit(prompts[2], 6, tenant="burst").result(timeout=TIMEOUT)
        assert _value("paddle_serving_requests_total", outcome="ok",
                      tenant="burst") == ok0 + 2
        assert _value("paddle_serving_requests_total", outcome="rejected",
                      tenant="burst") >= 1
        assert sum(_value("paddle_serving_router_routed_total",
                          replica=str(i)) for i in (0, 1)) >= 8
    finally:
        router.close()
    with pytest.raises(NotImplementedError, match="export"):
        ReplicaRouter(_factory(seq_ref), n_replicas=1).roll("artifact")


def test_router_slo_reject_early(seq_ref):
    router = ReplicaRouter(_factory(seq_ref, b_max=1), n_replicas=1,
                           service_rate_tps=0.5)
    try:
        prompts = _prompts(8, 5)
        slow = [router.submit(p, 20) for p in prompts[:3]]
        s0 = _value("paddle_serving_router_rejected_total", reason="slo")
        with pytest.raises(DeadlineExpired, match="projected"):
            router.submit(prompts[3], 4, deadline_s=0.5)
        assert _value("paddle_serving_router_rejected_total",
                      reason="slo") == s0 + 1
        ok = router.submit(prompts[4], 4, deadline_s=1e6)
        for r in slow + [ok]:
            r.result(timeout=TIMEOUT)
    finally:
        router.close()


def test_router_chaos_fault_readmit_restart(seq_ref):
    store = PrefixStore(16 << 20)
    faults = {}
    router = ReplicaRouter(_factory(seq_ref, store=store, faults=faults),
                           n_replicas=2, poll_s=0.05, max_readmissions=3)
    try:
        rs = np.random.RandomState(9)
        shared = rs.randint(1, 64, (8,)).astype("int64")
        prompts = [np.concatenate(
            [shared, rs.randint(1, 64, (3,)).astype("int64")])
            for _ in range(8)]
        for p in prompts[:2]:
            router.submit(p, 6, prefix_len=8).result(timeout=TIMEOUT)
        # the fault arms on replica 0's running engine: its 3rd decode
        # dispatch from here raises
        _inject(router.replicas[0].engine, 3)
        re0 = _value("paddle_serving_router_readmitted_total")
        rs0 = _value("paddle_serving_router_replica_restarts_total",
                     replica="0")
        ok0 = _value("paddle_serving_requests_total", outcome="ok",
                     tenant="default")
        done = []
        reqs = [router.submit(p, 6, prefix_len=8) for p in prompts]
        for r in reqs:
            r.add_done_callback(done.append)
        outs = [r.result(timeout=TIMEOUT) for r in reqs]
        for p, o in zip(prompts, outs):
            np.testing.assert_array_equal(o, seq_ref.generate(p, 6))
        assert _value("paddle_serving_router_readmitted_total") > re0
        assert len(done) == len(reqs)
        assert {id(r) for r in done} == {id(r) for r in reqs}
        assert _value("paddle_serving_requests_total", outcome="ok",
                      tenant="default") == ok0 + len(reqs)
        _wait_until(lambda: _value(
            "paddle_serving_router_replica_restarts_total",
            replica="0") > rs0, "replica 0's restart")
        _wait_until(lambda: all(r.engine.alive()
                                for r in router.replicas),
                    "both replicas alive")
        # the rebuilt replica serves
        np.testing.assert_array_equal(
            router.submit(prompts[0], 4).result(timeout=TIMEOUT),
            seq_ref.generate(prompts[0], 4))
    finally:
        router.close()


# ---------------------------------------------------------------- batcher
@pytest.fixture(scope="module")
def predictor(tmp_path_factory):
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)

    model_dir = str(tmp_path_factory.mktemp("serving_pred"))
    scope = Scope()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [8], dtype="float32")
        pred = pt.layers.fc(x, 4, act="softmax")
    exe = pt.Executor(CPU)
    exe.run(startup, scope=scope)
    with scope_guard(scope):
        pt.io.save_inference_model(model_dir, ["x"], [pred], exe,
                                   main_program=main)
    config = AnalysisConfig(model_dir=model_dir).disable_gpu()
    config.warmup_batch_sizes = [1, 4]
    return create_paddle_predictor(config)


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=BATCH_ATOL, rtol=0)


def test_batcher_coalesces_backlog_into_one_dispatch(predictor):
    rs = np.random.RandomState(0)
    feeds = [{"x": rs.randn(1, 8).astype("float32")} for _ in range(3)]
    solo = [predictor.run(f)[0] for f in feeds]
    b0 = _value("paddle_serving_batches_total")
    rows0 = _hist("paddle_serving_batch_rows")
    mb = MicroBatcher(predictor, max_rows=4, max_wait_s=0.2,
                      autostart=False)
    try:
        reqs = [mb.submit(f) for f in feeds]
        mb.start()
        outs = [r.result(timeout=30) for r in reqs]
    finally:
        mb.close()
    assert _value("paddle_serving_batches_total") == b0 + 1
    rows1 = _hist("paddle_serving_batch_rows")
    assert rows1[0] == rows0[0] + 1 and rows1[1] == rows0[1] + 3
    for got, ref in zip(outs, solo):
        assert len(got) == 1 and got[0].shape == (1, 4)
        _close(got[0], ref)


def test_batcher_multi_row_requests_and_the_row_cap(predictor):
    rs = np.random.RandomState(1)
    f2 = {"x": rs.randn(2, 8).astype("float32")}
    f1 = {"x": rs.randn(1, 8).astype("float32")}
    with MicroBatcher(predictor, max_rows=4, max_wait_s=0.2,
                      autostart=False) as mb:
        r2, r1 = mb.submit(f2), mb.submit(f1)
        mb.start()
        _close(r2.result(timeout=30)[0], predictor.run(f2)[0])
        _close(r1.result(timeout=30)[0], predictor.run(f1)[0])
    feeds = [{"x": rs.randn(2, 8).astype("float32")} for _ in range(3)]
    b0 = _value("paddle_serving_batches_total")
    with MicroBatcher(predictor, max_rows=3, max_wait_s=0.2,
                      autostart=False) as mb:
        reqs = [mb.submit(f) for f in feeds]
        mb.start()
        for f, r in zip(feeds, reqs):
            _close(r.result(timeout=30)[0], predictor.run(f)[0])
    assert _value("paddle_serving_batches_total") == b0 + 3


def test_batcher_validates_feeds(predictor):
    with MicroBatcher(predictor, autostart=False) as mb:
        with pytest.raises(ValueError, match="do not match"):
            mb.submit({"wrong": np.zeros((1, 8), "float32")})
        with pytest.raises(ValueError, match="row count"):
            mb.submit({"x": np.zeros((0, 8), "float32")})
    with pytest.raises(ValueError):
        MicroBatcher(predictor, max_rows=0)
    with pytest.raises(ValueError):
        MicroBatcher(predictor, max_wait_s=-1)


def test_batcher_run_error_fails_the_batch_futures(predictor):
    with MicroBatcher(predictor, max_rows=4, max_wait_s=0.1) as mb:
        bad = mb.submit({"x": np.zeros((1, 5), "float32")})
        with pytest.raises(Exception):
            bad.result(timeout=30)
        ok = mb.submit({"x": np.zeros((1, 8), "float32")})
        assert ok.result(timeout=30)[0].shape == (1, 4)


def test_batcher_close_cancels_pending(predictor):
    mb = MicroBatcher(predictor, autostart=False)
    r = mb.submit({"x": np.zeros((1, 8), "float32")})
    mb.close()
    with pytest.raises(Cancelled):
        r.result(timeout=1)
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit({"x": np.zeros((1, 8), "float32")})


def test_serving_exports_what_the_jax_package_exports():
    import paddle_tpu.serving as js
    import paddle_tpu_torch.serving as ts

    assert sorted(ts.__all__) == sorted(js.__all__)
    for name in js.__all__:
        assert hasattr(ts, name), name
