"""GPT in the port (paddle_tpu_torch/models/gpt.py, a copy) against the
JAX package: training over 5 Adam steps, KV-cache decoding and
``generate``, and the port's counterparts of the JAX package's GPT,
rope, modern-decoder and packing property tests.

Training: both packages build the same Program; the port starts from the
JAX package's post-startup scope (``convert.params_from_jax``), dropout
0 (the two RNGs cannot match), the same numpy batches with trailing
padding (id 0, 0-10% of a row, as real batches carry), and both take 5
Adam steps. Losses agree to a relative 1e-5 and params to atol 1e-4
(tests/test_torch_training.py's tolerances: f32 sums in another order).
The JAX side runs its Pallas flash kernels in interpret mode at every S
(tests/conftest.py); the port's CPU tensors take the kernels' plain
versions. With trailing padding no query row sees only padding (a real
token precedes it), so the documented difference of a fully masked row
(ROADMAP §C) does not arise; in packed rows the padding rows (segment 0)
are fully masked, and their outputs differ between the packages by that
difference, but they reach no loss (the loss masks them) and no real
row (a key must be real to be seen), so losses and params still agree
at the same tolerances.

Decoding: the JAX package's weights after 3 Adam steps go into both
packages' decode and prefill programs; greedy ``generate`` gives the
same tokens in both, stepwise and with one prefill dispatch, and so does
seeded sampling (``sample_token`` is numpy in both). Within the port,
the decode step's logits at every position match the training graph's
``is_test`` forward over the same ids at 1e-4 (the decode step reduces
over its cache of max_len rows, the full forward over the causal rows).
"""

import functools

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu import reader as jreader
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import reader
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import gpt

CPU = torch.device("cpu")
CFG = dict(d_model=64, d_ff=128, n_head=4, n_layer=2, vocab=128,
           max_length=32, dropout=0.0)
MODERN = dict(CFG, n_kv_head=2, pos_emb="rope", norm="rms",
              ffn_act="swiglu", tie_embeddings=True)
S, B, LR, STEPS = 32, 3, 1e-3, 5


# ------------------------------------------------------------- training
def _build(pkg, mod, cfg, **kw):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, feeds = mod.build(cfg, seq_len=S, **kw)
        pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
    return main, startup, loss


def _batches(packed, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        if packed:
            docs = [rs.randint(1, CFG["vocab"], rs.randint(3, 15)).tolist()
                    for _ in range(4)]
            out.append(reader.pack_sequences(docs, seq_len=S, n_rows=B))
            continue
        ids = rs.randint(1, CFG["vocab"], (B, S)).astype("int64")
        for i in range(B):
            pad = rs.randint(0, S // 10 + 1)
            ids[i, S - pad:] = 0
        out.append({"ids": ids})
    return out


CONFIGS = {
    "defaults_fused": (CFG, dict(use_fused_attention=True)),
    "defaults_composed": (CFG, dict(use_fused_attention=False)),
    "modern_knobs": (MODERN, dict(use_fused_attention=True)),
    "packed": (CFG, dict(use_fused_attention=True, packed=True)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gpt_trains_like_the_jax_package(name):
    cfg, kw = CONFIGS[name]
    jmain, jstart, jloss = _build(jf, jgpt, cfg, **kw)
    tmain, tstart, tloss = _build(pt, gpt, cfg, **kw)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    feeds = _batches(kw.get("packed", False))

    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jmain.list_vars() if v.persistable}
    want = [float(np.asarray(jexe.run(jmain, feed=f, fetch_list=[jloss],
                                      scope=jscope)[0]).reshape(()))
            for f in feeds]

    scope = pt.Scope()
    for n, v in params_from_jax(state, tmain, CPU).items():
        scope.set_var(n, v)
    exe = pt.Executor(pt.CPUPlace())
    got = [float(np.asarray(exe.run(tmain, feed=f, fetch_list=[tloss],
                                    scope=scope)[0]).reshape(()))
           for f in feeds]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    params = tmain.global_block().all_parameters()
    assert len(params) == len(jmain.global_block().all_parameters())
    for p in params:
        np.testing.assert_allclose(scope.find_var(p.name).numpy(),
                                   np.asarray(jscope.find_var(p.name)),
                                   atol=1e-4, rtol=0, err_msg=p.name)


def test_packed_fused_attention_folds_the_segment_mask():
    """The port's ``fused_attention`` takes SegmentIds (it raised
    NotImplementedError): the ids fold into a [B, 1, S, S] mask, so the
    fused loss equals the composed build's (which folds its own mask
    from layers), as in the JAX package."""
    feed = _batches(True)[0]

    def loss(fused):
        main, startup = pt.Program(), pt.Program()
        main.random_seed = startup.random_seed = 13
        with pt.program_guard(main, startup), pt.unique_name.guard():
            lv, _ = gpt.build(CFG, seq_len=S, packed=True,
                              use_fused_attention=fused)
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        exe.run(startup, scope=scope)
        types = [op.type for op in main.global_block().ops]
        assert ("fused_attention" in types) == fused
        return float(exe.run(main, feed=feed, fetch_list=[lv],
                             scope=scope)[0].reshape(()))

    np.testing.assert_allclose(loss(True), loss(False), rtol=1e-5, atol=0)


# -------------------------------------------------------------- decoding
DCFG = dict(d_model=32, d_ff=64, n_head=2, n_layer=2, vocab=64,
            max_length=16, dropout=0.0)
DMODERN = dict(DCFG, n_head=4, n_kv_head=2, pos_emb="rope", norm="rms")
DECODE_CFGS = {"mha": DCFG, "gqa_rope_rms": DMODERN}


def _frozen(cfg):
    return tuple(sorted(cfg.items()))


@functools.lru_cache(maxsize=None)
def _jax_weights(frozen):
    """The JAX package's persistables after 3 Adam steps (non-degenerate
    weights), as numpy."""
    cfg = dict(frozen)
    main, startup = jf.Program(), jf.Program()
    main.random_seed = startup.random_seed = 5
    with jf.program_guard(main, startup), jf.unique_name.guard():
        loss, _ = jgpt.build(cfg, seq_len=8, use_fused_attention=False)
        jf.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    exe, scope = jf.Executor(jf.CPUPlace()), jf.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(0)
    feed = {"ids": rs.randint(1, cfg["vocab"], (2, 8)).astype("int64")}
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return {p.name: np.asarray(scope.find_var(p.name))
            for p in main.global_block().all_parameters()}


def _decoder(pkg, mod, cfg, batch, max_len, prompt_len=None):
    """(exe, scope, decode program, its logits, prefill program or None,
    its logits) on one scope holding the JAX package's weights."""
    dec, dstart = pkg.Program(), pkg.Program()
    with pkg.program_guard(dec, dstart), pkg.unique_name.guard():
        logits, _ = mod.build_decode_step(cfg, batch=batch, max_len=max_len)
    pre = plogits = None
    if prompt_len:
        pre, pstart = pkg.Program(), pkg.Program()
        with pkg.program_guard(pre, pstart), pkg.unique_name.guard():
            plogits, _ = mod.build_prefill_step(cfg, batch=batch,
                                                prompt_len=prompt_len,
                                                max_len=max_len)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(dstart, scope=scope)
    if pre is not None:
        exe.run(pstart, scope=scope)
    for n, v in _jax_weights(_frozen(cfg)).items():
        if scope.find_var(n) is not None:
            scope.set_var(n, torch.tensor(v) if pkg is pt else v)
    return exe, scope, dec, logits, pre, plogits


def _generate(pkg, mod, cfg, prompt, n_new, max_len=12, prefill=False,
              **kw):
    exe, scope, dec, logits, pre, pl = _decoder(
        pkg, mod, cfg, prompt.shape[0], max_len,
        prompt.shape[1] if prefill else None)
    extra = dict(prefill_prog=pre, prefill_logits=pl) if prefill else {}
    return mod.generate(exe, dec, logits, prompt, n_new, scope, **kw,
                        **extra)


@pytest.mark.parametrize("name", sorted(DECODE_CFGS))
@pytest.mark.parametrize("prefill", [False, True])
def test_greedy_generate_gives_the_jax_package_tokens(name, prefill):
    cfg = DECODE_CFGS[name]
    prompt = np.random.RandomState(1).randint(
        1, cfg["vocab"], (2, 5)).astype("int64")
    want = _generate(jf, jgpt, cfg, prompt, 6, prefill=prefill)
    got = _generate(pt, gpt, cfg, prompt, 6, prefill=prefill)
    assert got.shape == (2, 11)
    np.testing.assert_array_equal(got, want)
    if prefill:  # one prefill dispatch gives the stepwise tokens
        np.testing.assert_array_equal(
            got, _generate(pt, gpt, cfg, prompt, 6, prefill=False))


@pytest.mark.parametrize("name", sorted(DECODE_CFGS))
def test_sampling_on_one_seed_gives_the_jax_package_tokens(name):
    cfg = DECODE_CFGS[name]
    prompt = np.array([[5, 9, 3]], "int64")
    for kw in (dict(temperature=1.0, top_k=8, seed=3),
               dict(temperature=0.7, seed=4)):
        want = _generate(jf, jgpt, cfg, prompt, 5, **kw)
        got = _generate(pt, gpt, cfg, prompt, 5, **kw)
        np.testing.assert_array_equal(got, want)
    # top_k=1 is greedy; a hot temperature is not
    greedy = _generate(pt, gpt, cfg, prompt, 5)
    np.testing.assert_array_equal(
        _generate(pt, gpt, cfg, prompt, 5, temperature=1.0, top_k=1,
                  seed=3), greedy)
    assert not np.array_equal(
        _generate(pt, gpt, cfg, prompt, 5, temperature=100.0, seed=4),
        greedy)


def _full_logits(cfg, ids):
    """The training graph's is_test forward over ``ids``: logits
    [B, T, vocab] (the LM head's output)."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        gpt.build(cfg, seq_len=ids.shape[1], is_test=True)
    name = None
    for op in main.global_block().ops:
        if op.type == "mul" and "gpt_out_proj.w_0" in op.inputs["Y"]:
            name = op.outputs["Out"][0]
        if op.type == "matmul" and "gpt_word_emb" in op.inputs["Y"]:
            name = op.outputs["Out"][0]
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    for n, v in _jax_weights(_frozen(cfg)).items():
        scope.set_var(n, torch.tensor(v))
    return exe.run(main, feed={"ids": ids}, fetch_list=[name],
                   scope=scope)[0]


@pytest.mark.parametrize("name", sorted(DECODE_CFGS) + ["tied_swiglu"])
def test_decode_logits_match_the_full_forward(name):
    """The port's counterpart of the JAX package's decode-vs-full tests
    (test_gpt_decode.py, test_rope.py, test_modern_decoder.py): each
    decode step's logits, over the KV cache, are the full forward's at
    that position, and greedy decoding is the full forward's argmax."""
    cfg = DECODE_CFGS.get(name) or dict(DCFG, tie_embeddings=True,
                                        ffn_act="swiglu")
    T = 10
    ids = np.random.RandomState(2).randint(1, cfg["vocab"],
                                           (2, T)).astype("int64")
    exe, scope, dec, logits, _, _ = _decoder(pt, gpt, cfg, 2, 12)
    steps = [exe.run(dec, feed={"token": ids[:, t:t + 1],
                                "pos": np.array([t], "int64")},
                     fetch_list=[logits], scope=scope)[0][:, 0]
             for t in range(T)]
    full = _full_logits(cfg, ids)
    np.testing.assert_allclose(np.stack(steps, 1), full, atol=1e-4, rtol=0)
    got = gpt.generate(exe, dec, logits, ids[:, :4], 4, scope)
    ref = ids[:, :4]
    for _ in range(4):
        nxt = _full_logits(cfg, ref)[:, -1].argmax(-1)
        ref = np.concatenate([ref, nxt[:, None].astype("int64")], 1)
    np.testing.assert_array_equal(got, ref)


def test_the_cache_is_state_written_in_place():
    """The port's counterpart of test_kv_cache_is_donated_state: every
    layer's caches are read-write state of the decode plan, and a step
    updates the scope's cache tensors in place (the same objects), at
    the fed position only."""
    exe, scope, dec, logits, _, _ = _decoder(pt, gpt, DCFG, 1, 8)
    names = [n for n in dec.global_block().vars if "_cache_" in n]
    assert len(names) == 2 * DCFG["n_layer"]
    before = {n: scope.find_var(n) for n in names}
    exe.run(dec, feed={"token": np.array([[3]], "int64"),
                       "pos": np.array([2], "int64")},
            fetch_list=[logits], scope=scope)
    plan = list(exe._cache.values())[-1]  # the decode step's
    assert set(names) <= set(plan.mut_state)
    for n in names:
        c = scope.find_var(n)
        assert c is before[n]
        rows = (c.abs().sum(dim=(0, 1, 3)) > 0).nonzero().flatten()
        assert rows.tolist() == [2], (n, rows)


def test_generate_errors():
    exe, scope, dec, logits, _, _ = _decoder(pt, gpt, DCFG, 1, 8)
    with pytest.raises(ValueError, match="max_len"):
        gpt.generate(exe, dec, logits, np.ones((1, 5), "int64"), 4, scope)
    with pytest.raises(ValueError, match="temperature"):
        gpt.generate(exe, dec, logits, np.ones((1, 2), "int64"), 2, scope,
                     temperature=-1.0)
    exe, scope, dec, logits, pre, pl = _decoder(pt, gpt, DCFG, 1, 12, 4)
    with pytest.raises(ValueError, match="prompt_len=4"):
        gpt.generate(exe, dec, logits, np.ones((1, 3), "int64"), 2, scope,
                     prefill_prog=pre, prefill_logits=pl)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        with pytest.raises(ValueError, match="learned position table"):
            gpt.build_decode_step(DCFG, max_len=DCFG["max_length"] + 1)


def test_serving_and_multi_token_steps_build_and_match_the_decode_step():
    """The per-slot serving step and the multi-token step lower in the
    port: at positions every row shares, their logits are the lockstep
    step's."""
    cfg = DMODERN
    exe, scope, dec, logits, _, _ = _decoder(pt, gpt, cfg, 2, 12)
    srv, sstart = pt.Program(), pt.Program()
    with pt.program_guard(srv, sstart), pt.unique_name.guard():
        slog, _ = gpt.build_serving_decode_step(cfg, batch=2, max_len=12)
    multi, mstart = pt.Program(), pt.Program()
    with pt.program_guard(multi, mstart), pt.unique_name.guard():
        mlog, _ = gpt.build_multi_token_decode_step(cfg, batch=2, steps=3,
                                                    max_len=12)
    ids = np.random.RandomState(4).randint(1, 64, (2, 3)).astype("int64")
    want = [exe.run(dec, feed={"token": ids[:, t:t + 1],
                               "pos": np.array([t], "int64")},
                    fetch_list=[logits], scope=scope)[0][:, 0]
            for t in range(3)]
    for t in range(3):
        (got,) = exe.run(srv, feed={"token": ids[:, t:t + 1],
                                    "pos": np.full((2, 1), t, "int64")},
                         fetch_list=[slog], scope=scope)
        np.testing.assert_allclose(got[:, 0], want[t], atol=1e-5, rtol=0)
    (got,) = exe.run(multi, feed={"token": ids,
                                  "pos": np.tile(np.arange(3), (2, 1))},
                     fetch_list=[mlog], scope=scope)
    np.testing.assert_allclose(got, np.stack(want, 1), atol=1e-5, rtol=0)


# ------------------------------------------ property tests (no JAX side)
def _rope(x, pos):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        xv = pt.layers.data("x", list(x.shape), append_batch_size=False)
        pv = pt.layers.data("p", list(pos.shape), dtype="int64",
                            append_batch_size=False)
        out = pt.layers.rope(xv, pv)
    return pt.Executor(pt.CPUPlace()).run(
        main, feed={"x": x, "p": pos}, fetch_list=[out],
        scope=pt.Scope())[0]


def test_rope_relative_position_property():
    rs = np.random.RandomState(1)
    q = rs.randn(1, 1, 6, 32).astype("float32")
    k = rs.randn(1, 1, 6, 32).astype("float32")

    def scores(shift):
        pos = (np.arange(6) + shift).astype("int64")
        return np.einsum("bhqd,bhkd->bhqk", _rope(q, pos), _rope(k, pos))

    np.testing.assert_allclose(scores(0), scores(37), atol=1e-3, rtol=1e-3)


def test_rope_norm_preserved_and_zero_pos_identity():
    x = np.random.RandomState(2).randn(1, 2, 4, 16).astype("float32")
    out = _rope(x, np.arange(4).astype("int64"))
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1),
                               np.linalg.norm(x, axis=-1), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(out[:, :, 0], x[:, :, 0], atol=1e-6)


def test_cfg_typos_and_odd_head_dims_raise_at_build_time():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        for bad in (dict(MODERN, pos_emb="ROPE"),
                    dict(MODERN, norm="rmsnorm"),
                    dict(MODERN, ffn_act="siglu")):
            with pytest.raises(ValueError, match="must be one of"):
                gpt.build(bad, seq_len=8)
        with pytest.raises(ValueError, match="unknown gpt cfg"):
            gpt.build(dict(MODERN, tied_embeddings=True), seq_len=8)
        x = pt.layers.data("x", [2, 4, 5], append_batch_size=False)
        p = pt.layers.data("p", [4], dtype="int64", append_batch_size=False)
        with pytest.raises(ValueError, match="even head dim"):
            pt.layers.rope(x, p)


def test_pack_sequences_structure_matches_the_jax_package():
    """The port's reader packs as the JAX package's: whole documents per
    row, overlong ones split into new segments, fixed rows, and the
    empty-input error."""
    cases = [([[5, 6, 7], [8, 9], [10, 11, 12, 13, 14, 15, 16]], 8, None),
             ([[1, 2, 3], list(range(10, 22))], 8, None),
             ([[5, 6, 7]], 8, 3)]
    for docs, seq_len, rows in cases:
        got = reader.pack_sequences(docs, seq_len=seq_len, n_rows=rows)
        want = jreader.pack_sequences(docs, seq_len=seq_len, n_rows=rows)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    feed = reader.pack_sequences(cases[0][0], seq_len=8)
    np.testing.assert_array_equal(feed["segment_ids"][0],
                                  [1, 1, 1, 2, 2, 0, 0, 0])
    np.testing.assert_array_equal(feed["pos_ids"][0],
                                  [0, 1, 2, 0, 1, 0, 0, 0])
    with pytest.raises(ValueError, match="n_rows"):
        reader.pack_sequences([[1] * 8, [2] * 8], seq_len=8, n_rows=1)
    for seqs in ([], [[]], [[], []]):
        with pytest.raises(ValueError, match="no tokens to pack"):
            reader.pack_sequences(seqs, seq_len=8, n_rows=2)


def test_an_all_padding_packed_row_trains_finitely():
    feed = reader.pack_sequences([[5, 6, 7]], seq_len=8, n_rows=3)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = gpt.build(dict(CFG, max_length=8), seq_len=8, packed=True,
                            use_fused_attention=True)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    for _ in range(2):
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        assert np.isfinite(lv).all()


def test_gpt_programs_need_the_card_unless_told_otherwise(monkeypatch):
    """No fallback: an ``Executor()`` that runs GPT's programs without a
    card and without ``CPUPlace()`` raises; ``CPUPlace()`` runs them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: gpt.build(DCFG, seq_len=8),
                  lambda: gpt.build_decode_step(DCFG, max_len=8)):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), pt.unique_name.guard():
            build()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.Executor().run(startup, scope=pt.Scope())
        pt.Executor(pt.CPUPlace()).run(startup, scope=pt.Scope())
