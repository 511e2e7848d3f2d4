"""Decoder-only causal language model (GPT-style).

Beyond-reference model family: the reference era (Fluid v1.3) predates
decoder-only LMs, but the long-context story this framework is built
around (causal flash attention with above-diagonal block skipping, ring
attention under an sp mesh, recompute boundaries) is exactly a
decoder-only workload — this model is its showcase. Built from the same
fluid-style layer calls as models/transformer.py (whose provenance is
the reference's python/paddle/fluid/tests/unittests/dist_transformer.py).

A copy of paddle_tpu/models/gpt.py (tests/test_torch_isolation.py pins
it); in the port the KV caches are written in place on the card
(ops/tensor_ops.py ``kv_cache_write``), also inside a replayed step.

Feeds: ids [B, S] int64 tokens; the loss is next-token cross entropy
with the final position dropped (labels are ids shifted left), pad id 0
masked out of the loss.
"""

from .. import layers
from ..param_attr import ParamAttr
from .transformer import (_causal_bias, _ffn, _pad_bias, _prenorm,
                          multi_head_attention)

__all__ = ["base_config", "build"]


def base_config():
    """Optional modern-decoder knobs (all compose, train AND decode):
    ``n_kv_head`` (< n_head, dividing it) — grouped-query attention:
    smaller k/v projections and an H/Hkv-times smaller KV cache;
    ``pos_emb='rope'`` — rotary positions instead of the learned
    table; ``norm='rms'`` — RMSNorm (scale-only, f32 rsqrt);
    ``ffn_act='swiglu'`` — the gated FFN; ``tie_embeddings=True`` — one table serves lookup and LM head."""
    return dict(d_model=768, d_ff=3072, n_head=12, n_layer=12,
                vocab=50304, max_length=1024, dropout=0.1)


_CFG_KEYS = frozenset([
    "d_model", "d_ff", "n_head", "n_layer", "vocab", "max_length",
    "dropout", "n_kv_head", "pos_emb", "norm", "ffn_act",
    "tie_embeddings",
])


def _check_cfg(cfg):
    """Knob typos must fail at build time, not silently fall back to
    the default architecture — covers both bad VALUES for the string
    knobs and unknown KEYS (e.g. 'tied_embeddings') that would
    otherwise be ignored."""
    unknown = set(cfg) - _CFG_KEYS
    if unknown:
        raise ValueError("unknown gpt cfg key(s) %s — known keys: %s"
                         % (sorted(unknown), sorted(_CFG_KEYS)))
    for key, allowed in (("pos_emb", ("learned", "rope")),
                         ("norm", ("layer", "rms")),
                         ("ffn_act", ("relu", "gelu", "swish",
                                      "swiglu"))):
        val = cfg.get(key)
        if val is not None and val not in allowed:
            raise ValueError("cfg[%r] must be one of %s; got %r"
                             % (key, allowed, val))


def _lm_head(cfg, x):
    """Final projection to vocab logits. ``tie_embeddings=True`` reuses
    the input embedding (logits = x @ word_emb^T — no gpt_out_proj
    parameter; gradients accumulate into the one table from both the
    lookup and the head), the standard LM weight-tying."""
    if cfg.get("tie_embeddings"):
        from ..core.program import default_main_program

        emb = default_main_program().global_block().var("gpt_word_emb")
        return layers.matmul(x, emb, transpose_y=True)
    return layers.fc(x, cfg["vocab"], num_flatten_dims=2,
                     bias_attr=False,
                     param_attr=ParamAttr(name="gpt_out_proj.w_0"))


def _final_norm(cfg, x):
    """The shared final norm (training build + decode step use the SAME
    parameter names, so decode can overwrite by name)."""
    if cfg.get("norm", "layer") == "rms":
        return layers.rms_norm(x, begin_norm_axis=2,
                               param_attr=ParamAttr(name="gpt_ln_f_s"))
    return layers.layer_norm(x, begin_norm_axis=2,
                             param_attr=ParamAttr(name="gpt_ln_f_s"),
                             bias_attr=ParamAttr(name="gpt_ln_f_b"))


def _norm_of(cfg, t, prefix):
    """Per-layer norm for the inference graphs (decode + prefill),
    matching the training build's _prenorm parameter names."""
    if cfg.get("norm", "layer") == "rms":
        return layers.rms_norm(t, begin_norm_axis=2,
                               param_attr=ParamAttr(name=prefix + "_ln_s"))
    return layers.layer_norm(t, begin_norm_axis=2,
                             param_attr=ParamAttr(name=prefix + "_ln_s"),
                             bias_attr=ParamAttr(name=prefix + "_ln_b"))


def _kv_heads_of(cfg):
    """(n_kv, group size) with the divisibility contract enforced —
    one check shared by every build path."""
    n_head = cfg["n_head"]
    n_kv = cfg.get("n_kv_head") or n_head
    if n_head % n_kv:
        raise ValueError("n_head %d must divide by n_kv_head %d"
                         % (n_head, n_kv))
    return n_kv, n_head // n_kv


def build(cfg=None, seq_len=256, is_test=False, use_fused_attention=None,
          checkpoints=None, packed=False):
    """Causal LM training graph; returns (avg_loss, feed_names).

    On the fused path, decoder self-attention uses the kernel's causal
    mask with above-diagonal block skipping; the composed path folds a
    dense causal bias. checkpoints collects per-layer recompute
    boundaries for RecomputeOptimizer.

    ``packed=True`` trains on PACKED rows (multiple documents per
    [B, S] row — ``reader.pack_sequences`` builds them): two extra
    feeds, ``segment_ids`` [B, S] (0 = padding; equal ids attend) and
    ``pos_ids`` [B, S] (within-segment positions, driving RoPE or the
    learned table); attention is block-diagonal-causal, and next-token
    targets never cross a segment boundary. Padding-free long-context
    training — no FLOPs spent on pad rows.
    """
    if use_fused_attention is None:
        from ..ops.attention import fused_attention_enabled

        use_fused_attention = fused_attention_enabled()
    cfg = cfg or base_config()
    _check_cfg(cfg)
    ids = layers.data("ids", [seq_len], dtype="int64")
    seg = pos_feed = None
    self_seg = None
    if packed:
        seg = layers.data("segment_ids", [seq_len], dtype="int64")
        pos_feed = layers.data("pos_ids", [seq_len], dtype="int64")
    if use_fused_attention:
        if packed:
            # the fused op takes the segment ids DIRECTLY — no [S,S]
            # pack bias is ever materialized; single-device it folds to
            # a mask once, under an sp mesh the ids ride the ring
            # (ops/attention.py SegmentIds, ring_attention seg=)
            self_bias, self_causal, self_seg = None, True, seg
        else:
            self_bias, self_causal = _pad_bias(ids), True
    else:
        if packed:
            # composed fallback: materialized same-segment visibility
            # (and key must be real): [B, 1, S, S]
            a = layers.reshape(seg, [-1, 1, seq_len, 1])
            b = layers.reshape(seg, [-1, 1, 1, seq_len])
            same = layers.cast(layers.equal(a, b), "float32")
            realk = layers.cast(layers.greater_than(
                b, layers.fill_constant([1], "int64", 0)), "float32")
            keep = layers.elementwise_mul(same, realk)
            pack_bias = layers.scale(layers.elementwise_sub(
                layers.fill_constant([1], "float32", 1.0), keep),
                scale=-1e9)
        else:
            pack_bias = _pad_bias(ids)
        self_bias = layers.elementwise_add(pack_bias,
                                           _causal_bias(seq_len))
        self_causal = False

    use_rope = cfg.get("pos_emb", "learned") == "rope"
    word = layers.embedding(ids, [cfg["vocab"], cfg["d_model"]],
                            param_attr=ParamAttr(name="gpt_word_emb"))
    rope_pos = None
    if use_rope:
        # positions enter through the per-layer q/k rotation instead of
        # an additive learned table; packed rows reset per segment
        x = word
        rope_pos = (pos_feed if packed
                    else layers.range(0, seq_len, 1, "int64"))
    else:
        pos_ids = (pos_feed if packed
                   else layers.reshape(
                       layers.range(0, seq_len, 1, "int64"),
                       [1, seq_len]))
        pos = layers.embedding(pos_ids,
                               [cfg["max_length"], cfg["d_model"]],
                               param_attr=ParamAttr(name="gpt_pos_emb"))
        x = layers.elementwise_add(word, pos)
    if cfg["dropout"]:
        x = layers.dropout(x, cfg["dropout"], is_test=is_test)

    norm = cfg.get("norm", "layer")
    ffn_act = cfg.get("ffn_act", "relu")
    for i in range(cfg["n_layer"]):
        nm = "gpt_%d" % i
        x = _prenorm(x, lambda h, nm=nm: multi_head_attention(
            h, h, self_bias, cfg["d_model"], cfg["n_head"], cfg["dropout"],
            is_test, nm + "_att", use_fused_attention,
            causal=self_causal, n_kv_head=cfg.get("n_kv_head"),
            rope_pos=rope_pos, segment_ids=self_seg),
            cfg["dropout"], is_test, nm + "_pre1", norm=norm)
        x = _prenorm(x, lambda h, nm=nm: _ffn(h, cfg["d_model"],
                                              cfg["d_ff"], nm,
                                              act=ffn_act),
                     cfg["dropout"], is_test, nm + "_pre2", norm=norm)
        if checkpoints is not None:
            checkpoints.append(x)
    x = _final_norm(cfg, x)

    logits = _lm_head(cfg, x)

    def shift_left(t):
        # t[:, 1:] with a 0 (pad) in the vacated last column
        return layers.concat([
            layers.slice(t, axes=[1], starts=[1], ends=[seq_len]),
            layers.fill_constant_batch_size_like(t, [-1, 1], "int64", 0),
        ], axis=1)

    # next-token targets: ids shifted left; the last position has no
    # target, and pad positions (id 0) are masked out of the loss
    labels = shift_left(ids)
    cost = layers.softmax_with_cross_entropy(
        logits, layers.reshape(labels, [-1, seq_len, 1]))
    valid = layers.cast(
        layers.greater_than(
            labels, layers.fill_constant([1], "int64", 0)), "float32")
    if packed:
        # a target in a DIFFERENT segment (the next document's first
        # token) must not train this position
        same_seg = layers.cast(layers.equal(shift_left(seg), seg),
                               "float32")
        valid = layers.elementwise_mul(valid, same_seg)
    valid = layers.reshape(valid, [-1, seq_len, 1])
    total = layers.reduce_sum(layers.elementwise_mul(cost, valid))
    count = layers.elementwise_max(
        layers.reduce_sum(valid), layers.fill_constant([1], "float32", 1.0))
    avg = layers.elementwise_div(total, count)
    return avg, (["ids", "segment_ids", "pos_ids"] if packed
                 else ["ids"])



def build_prefill_step(cfg=None, batch=1, prompt_len=8, max_len=None):
    """Prompt prefill as ONE dispatch: forward over the whole [B, P]
    prompt with causal attention, writing every layer's K/V slab into
    the caches at positions 0..P-1 (dynamic_update_slice of the full
    slab — one in-place write per layer, not P), and returning logits
    [B, P, vocab]. Pair with ``build_decode_step`` over the SAME scope
    (shared cache/weight names) and drive both via ``generate(...,
    prefill_prog=...)`` — prompt latency drops from P dispatches to 1.

    Returns (logits_var, cache_names)."""
    cfg = cfg or base_config()
    _check_cfg(cfg)
    if max_len is None:
        max_len = cfg["max_length"]
    P = int(prompt_len)
    assert 0 < P <= max_len, (P, max_len)
    d_model, n_head = cfg["d_model"], cfg["n_head"]
    d_head = d_model // n_head
    n_kv, _g = _kv_heads_of(cfg)
    from ..layer_helper import LayerHelper
    from .transformer import repeat_kv_heads

    helper = LayerHelper("gpt_prefill")
    tokens = layers.data("tokens", [P], dtype="int64")
    zero = layers.fill_constant([1], "int64", 0)

    use_rope = cfg.get("pos_emb", "learned") == "rope"
    word = layers.embedding(tokens, [cfg["vocab"], d_model],
                            param_attr=ParamAttr(name="gpt_word_emb"))
    pos_range = layers.range(0, P, 1, "int64")
    if use_rope:
        x = word
    else:
        pos = layers.embedding(layers.reshape(pos_range, [1, P]),
                               [cfg["max_length"], d_model],
                               param_attr=ParamAttr(name="gpt_pos_emb"))
        x = layers.elementwise_add(word, pos)

    bias = _causal_bias(P)
    cache_names = []
    for i in range(cfg["n_layer"]):
        nm = "gpt_%d" % i
        ck = helper.create_global_variable(
            name=nm + "_cache_k", shape=(batch, n_kv, max_len, d_head))
        cv = helper.create_global_variable(
            name=nm + "_cache_v", shape=(batch, n_kv, max_len, d_head))
        cache_names += [ck.name, cv.name]

        h = _norm_of(cfg, x, nm + "_pre1")
        q = layers.fc(h, d_model, num_flatten_dims=2, bias_attr=False,
                      param_attr=ParamAttr(name=nm + "_att_q.w_0"))
        k = layers.fc(h, n_kv * d_head, num_flatten_dims=2,
                      bias_attr=False,
                      param_attr=ParamAttr(name=nm + "_att_k.w_0"))
        v = layers.fc(h, n_kv * d_head, num_flatten_dims=2,
                      bias_attr=False,
                      param_attr=ParamAttr(name=nm + "_att_v.w_0"))

        def heads(t, n):
            t = layers.reshape(t, [-1, P, n, d_head])
            return layers.transpose(t, perm=[0, 2, 1, 3])  # [B,n,P,Dh]

        q, k, v = heads(q, n_head), heads(k, n_kv), heads(v, n_kv)
        if use_rope:
            q = layers.rope(q, pos_range)
            k = layers.rope(k, pos_range)
        # one slab write per layer: the cache holds rotated keys
        layers.kv_cache_write(ck, k, zero)
        layers.kv_cache_write(cv, v, zero)
        kr = repeat_kv_heads(k, n_kv, n_head, P, d_head)
        vr = repeat_kv_heads(v, n_kv, n_head, P, d_head)
        scores = layers.matmul(q, kr, transpose_y=True,
                               alpha=d_head ** -0.5)   # [B,H,P,P]
        scores = layers.elementwise_add(scores, bias)
        w = layers.softmax(scores)
        ctxv = layers.matmul(w, vr)                    # [B,H,P,Dh]
        ctxv = layers.transpose(ctxv, perm=[0, 2, 1, 3])
        ctxv = layers.reshape(ctxv, [-1, P, d_model])
        att = layers.fc(ctxv, d_model, num_flatten_dims=2,
                        bias_attr=False,
                        param_attr=ParamAttr(name=nm + "_att_o.w_0"))
        x = layers.elementwise_add(x, att)

        h2 = _norm_of(cfg, x, nm + "_pre2")
        f = _ffn(h2, d_model, cfg["d_ff"], nm,
                 act=cfg.get("ffn_act", "relu"))
        x = layers.elementwise_add(x, f)

    x = _final_norm(cfg, x)
    logits = _lm_head(cfg, x)
    return logits, cache_names


def build_decode_step(cfg=None, batch=1, max_len=None,
                      per_slot_pos=False):
    """Incremental decoding step graph with donated KV caches.

    Feeds: token [B, 1] int64 (the current position's input token) and
    pos int64 — a [1] scalar shared by every row (the classic lockstep
    loop, default) or, with ``per_slot_pos=True``, a [B, 1] per-row
    position so each cache slot advances independently (the serving
    engine's continuous-batching step — see
    ``build_serving_decode_step``). Per-layer K/V caches live as
    persistable [B, n_kv_head (default n_head), max_len, Dh] state the
    executor DONATES — the `kv_cache_write` update is in-place on
    device, so a decode step moves O(1) data (GQA shrinks the cache
    H/Hkv-fold; RoPE caches store rotated keys). Weights share the
    training graph's parameter names
    (gpt_*), so after running this program's startup, overwrite them
    with trained values (same names) — see `generate`.

    Returns (logits_var, cache_names). Fetch logits [B, 1, vocab].
    """
    cfg = cfg or base_config()
    _check_cfg(cfg)
    if max_len is None:
        max_len = cfg["max_length"]
    use_rope = cfg.get("pos_emb", "learned") == "rope"
    if not use_rope and max_len > cfg["max_length"]:
        # the learned gpt_pos_emb table has cfg['max_length'] rows;
        # positions past it would read NaN rows in the lookup (the
        # JAX package's jnp.take fill) and corrupt every later token
        raise ValueError(
            "max_len=%d exceeds the learned position table "
            "(cfg['max_length']=%d) — raise max_length or use "
            "pos_emb='rope'" % (max_len, cfg["max_length"]))
    d_model, n_head = cfg["d_model"], cfg["n_head"]
    d_head = d_model // n_head
    from ..layer_helper import LayerHelper

    helper = LayerHelper("gpt_decode")
    token = layers.data("token", [1], dtype="int64")
    if per_slot_pos:
        pos = layers.data("pos", [1], dtype="int64")   # batched: [B, 1]
    else:
        pos = layers.data("pos", [1], dtype="int64",
                          append_batch_size=False)     # one shared [1]

    # lookup_table squeezes trailing-1 id dims (reference semantics):
    # [B,1] ids -> [B,D]; restore the [B,1,D] step layout explicitly
    word = layers.reshape(
        layers.embedding(token, [cfg["vocab"], d_model],
                         param_attr=ParamAttr(name="gpt_word_emb")),
        [-1, 1, d_model])
    if use_rope:
        x = word                              # positions rotate q/k below
    else:
        pos_ids = pos if per_slot_pos else layers.reshape(pos, [1, 1])
        posv = layers.reshape(
            layers.embedding(pos_ids, [cfg["max_length"], d_model],
                             param_attr=ParamAttr(name="gpt_pos_emb")),
            [-1, 1, d_model] if per_slot_pos else [1, 1, d_model])
        x = layers.elementwise_add(word, posv)    # [B, 1, D]

    # visibility over cache rows: positions <= pos attend, later rows
    # mask out — zeros from init in the lockstep loop; per-slot, row b
    # attends to `cache row <= pos[b]`, so a retired neighbor's stale
    # rows never leak into a live slot's attention
    ar = layers.reshape(layers.range(0, max_len, 1, "int64"), [1, max_len])
    vis = layers.cast(layers.less_equal(
        ar, pos if per_slot_pos else layers.reshape(pos, [1, 1])),
        "float32")                      # [B, S] per-slot, else [1, S]
    bias = layers.scale(layers.elementwise_sub(
        layers.fill_constant([1], "float32", 1.0), vis), scale=-1e9)
    bias = layers.reshape(
        bias, [-1 if per_slot_pos else 1, 1, 1, max_len])

    n_kv, g = _kv_heads_of(cfg)
    cache_names = []
    for i in range(cfg["n_layer"]):
        nm = "gpt_%d" % i
        # GQA: the cache stores n_kv heads — H/Hkv-times less decode
        # HBM, the whole point of grouped-query attention at inference
        ck = helper.create_global_variable(
            name=nm + "_cache_k", shape=(batch, n_kv, max_len, d_head))
        cv = helper.create_global_variable(
            name=nm + "_cache_v", shape=(batch, n_kv, max_len, d_head))
        cache_names += [ck.name, cv.name]

        h = _norm_of(cfg, x, nm + "_pre1")
        q = layers.fc(h, d_model, num_flatten_dims=2, bias_attr=False,
                      param_attr=ParamAttr(name=nm + "_att_q.w_0"))
        k = layers.fc(h, n_kv * d_head, num_flatten_dims=2,
                      bias_attr=False,
                      param_attr=ParamAttr(name=nm + "_att_k.w_0"))
        v = layers.fc(h, n_kv * d_head, num_flatten_dims=2,
                      bias_attr=False,
                      param_attr=ParamAttr(name=nm + "_att_v.w_0"))

        def kv_heads(t):
            t = layers.reshape(t, [-1, 1, n_kv, d_head])
            return layers.transpose(t, perm=[0, 2, 1, 3])  # [B,Hkv,1,Dh]

        k, v = kv_heads(k), kv_heads(v)
        if use_rope:
            # rotate at THIS position; the cache stores rotated keys,
            # so dot products against it are relative-position exact.
            # Per-slot [B, 1] positions broadcast per-row angles over
            # the head axis — each slot rotates at ITS position
            k = layers.rope(k, pos)
        ck = layers.kv_cache_write(ck, k, pos)   # per-row vmapped when
        cv = layers.kv_cache_write(cv, v, pos)   # pos is [B]/[B, 1]
        # GQA grouped attention: query heads fold as [B, Hkv, g, Dh]
        # (h = kv*g + j, row-major — the same h//g mapping as
        # transformer.repeat_kv_heads) and batch-matmul DIRECTLY
        # against the n_kv-head cache: no H-head repeated cache is
        # ever materialized, so the per-step working set stays at the
        # n_kv size too. g == 1 degenerates to plain MHA.
        q = layers.reshape(q, [-1, n_kv, g, d_head])
        if use_rope:
            # a [1] pos yields [1, Dh/2] sin/cos that broadcast over
            # every leading layout ([B, 1] per-slot pos: [B,1,1,Dh/2])
            # — rotating the folded q directly is exact: all g query
            # heads of a row sit at that row's position
            q = layers.rope(q, pos)
        scores = layers.matmul(q, ck, transpose_y=True,
                               alpha=d_head ** -0.5)    # [B,Hkv,g,S]
        scores = layers.elementwise_add(scores, bias)
        w = layers.softmax(scores)
        ctxv = layers.matmul(w, cv)                     # [B,Hkv,g,Dh]
        ctxv = layers.reshape(ctxv, [-1, 1, d_model])
        att = layers.fc(ctxv, d_model, num_flatten_dims=2, bias_attr=False,
                        param_attr=ParamAttr(name=nm + "_att_o.w_0"))
        x = layers.elementwise_add(x, att)

        h2 = _norm_of(cfg, x, nm + "_pre2")
        f = _ffn(h2, d_model, cfg["d_ff"], nm,
                 act=cfg.get("ffn_act", "relu"))
        x = layers.elementwise_add(x, f)

    x = _final_norm(cfg, x)
    logits = _lm_head(cfg, x)
    return logits, cache_names


def build_multi_token_decode_step(cfg=None, batch=1, steps=2,
                                  max_len=None):
    """S tokens per slot in ONE dispatch, against the decode caches.

    The fixed-shape primitive the fleet tier composes twice
    (serving/engine.py):

    * **speculative verification** — the target model scores a slot's
      current token plus its k draft tokens (S = k + 1) in one
      dispatch; greedy acceptance walks the S logits rows.
    * **suffix prefill after a prefix-cache hit** — a prompt whose
      first L tokens were spliced from the prefix store prefills only
      its S = P - L suffix (batch=1).

    Feeds: ``token`` [B, S] int64 and ``pos`` [B, S] int64 where every
    row MUST be contiguous ascending (``pos[b] = start_b + arange(S)``)
    — the per-layer cache write is one vmapped slab update at
    ``pos[:, 0]``, so non-contiguous rows would silently write the slab
    at the wrong rows. The caller also guarantees
    ``pos[b, -1] < max_len`` for every row: ``dynamic_update_slice``
    CLAMPS an overflowing start and would shift the write window down
    over valid rows (the engine degrades to plain single-token steps
    near the cache end for exactly this reason).

    Per-slot semantics match ``build_serving_decode_step``: query row
    (b, s) sees cache rows ``<= pos[b, s]`` (later rows — including the
    speculative K/V this very dispatch writes — are masked to exact
    zeros), every op is row-local, and cache/parameter names are shared
    with ``build_decode_step``. Attention is computed PER POSITION with
    exactly the decode step's shapes (q folded [B, n_kv, g, Dh], one
    M=g matmul against the n_kv cache, per-position visibility bias):
    the S-wide GEMM variant is NOT bitwise the step's M=g form on CPU
    (a GEMV reduces in a different order than a GEMM), and the fleet
    tier's whole contract is that a verified/suffix-prefilled token
    stream is bitwise ``generate``'s — so position s's logits are the
    plain step's BY CONSTRUCTION, not by tolerance. S stays small in
    both uses (k+1 drafts, the un-cached prompt suffix), so the op
    count is bounded.

    Returns (logits_var, cache_names); fetch logits [B, S, vocab]."""
    cfg = cfg or base_config()
    _check_cfg(cfg)
    if max_len is None:
        max_len = cfg["max_length"]
    S = int(steps)
    assert 0 < S <= max_len, (S, max_len)
    use_rope = cfg.get("pos_emb", "learned") == "rope"
    if not use_rope and max_len > cfg["max_length"]:
        raise ValueError(
            "max_len=%d exceeds the learned position table "
            "(cfg['max_length']=%d) — raise max_length or use "
            "pos_emb='rope'" % (max_len, cfg["max_length"]))
    d_model, n_head = cfg["d_model"], cfg["n_head"]
    d_head = d_model // n_head
    n_kv, g = _kv_heads_of(cfg)
    from ..layer_helper import LayerHelper

    helper = LayerHelper("gpt_multi_decode")
    token = layers.data("token", [S], dtype="int64")   # [B, S]
    pos = layers.data("pos", [S], dtype="int64")       # [B, S]

    # explicit [B, S, D] reshape: lookup_table squeezes trailing-1 id
    # dims, so S=1 (a one-token suffix) would otherwise come out [B, D]
    word = layers.reshape(
        layers.embedding(token, [cfg["vocab"], d_model],
                         param_attr=ParamAttr(name="gpt_word_emb")),
        [-1, S, d_model])
    if use_rope:
        x = word                             # positions rotate q/k below
    else:
        posv = layers.reshape(
            layers.embedding(pos, [cfg["max_length"], d_model],
                             param_attr=ParamAttr(name="gpt_pos_emb")),
            [-1, S, d_model])
        x = layers.elementwise_add(word, posv)

    # per-position [B, 1] position columns + the decode step's exact
    # visibility bias per position: query (b, s) attends cache rows
    # <= pos[b, s]; everything later — a neighbor's rows, this
    # dispatch's own still-speculative writes — masks to an exact zero
    # after softmax
    ar = layers.reshape(layers.range(0, max_len, 1, "int64"),
                        [1, max_len])
    pos_cols, biases = [], []
    for s in range(S):
        ps = layers.slice(pos, axes=[1], starts=[s], ends=[s + 1])
        pos_cols.append(ps)                              # [B, 1]
        vis = layers.cast(layers.less_equal(ar, ps), "float32")
        b_s = layers.scale(layers.elementwise_sub(
            layers.fill_constant([1], "float32", 1.0), vis), scale=-1e9)
        biases.append(layers.reshape(b_s, [-1, 1, 1, max_len]))

    cache_names = []
    for i in range(cfg["n_layer"]):
        nm = "gpt_%d" % i
        ck = helper.create_global_variable(
            name=nm + "_cache_k", shape=(batch, n_kv, max_len, d_head))
        cv = helper.create_global_variable(
            name=nm + "_cache_v", shape=(batch, n_kv, max_len, d_head))
        cache_names += [ck.name, cv.name]

        h = _norm_of(cfg, x, nm + "_pre1")
        q = layers.fc(h, d_model, num_flatten_dims=2, bias_attr=False,
                      param_attr=ParamAttr(name=nm + "_att_q.w_0"))
        k = layers.fc(h, n_kv * d_head, num_flatten_dims=2,
                      bias_attr=False,
                      param_attr=ParamAttr(name=nm + "_att_k.w_0"))
        v = layers.fc(h, n_kv * d_head, num_flatten_dims=2,
                      bias_attr=False,
                      param_attr=ParamAttr(name=nm + "_att_v.w_0"))

        def kv_heads(t):
            t = layers.reshape(t, [-1, S, n_kv, d_head])
            return layers.transpose(t, perm=[0, 2, 1, 3])  # [B,n_kv,S,Dh]

        k, v = kv_heads(k), kv_heads(v)
        if use_rope:
            # [B, S] positions -> per-(row, step) angles broadcast over
            # the kv-head axis (elementwise — bitwise the per-position
            # rotation); the cache stores rotated keys
            k = layers.rope(k, pos)
        # ONE vmapped slab write per cache tensor at the per-row start
        # (rows are contiguous by contract)
        ck = layers.kv_cache_write(ck, k, pos_cols[0])
        cv = layers.kv_cache_write(cv, v, pos_cols[0])
        # attention per position, in the decode step's exact shapes:
        # q_s folds to [B, n_kv, g, Dh] and batch-matmuls the n_kv
        # cache directly — scores/softmax/ctx of position s are the
        # single-token step's bit for bit (an S-wide GEMM would not be)
        ctxs = []
        for s in range(S):
            q_s = layers.reshape(
                layers.slice(q, axes=[1], starts=[s], ends=[s + 1]),
                [-1, n_kv, g, d_head])
            if use_rope:
                q_s = layers.rope(q_s, pos_cols[s])
            scores = layers.matmul(q_s, ck, transpose_y=True,
                                   alpha=d_head ** -0.5)  # [B,n_kv,g,S']
            scores = layers.elementwise_add(scores, biases[s])
            w = layers.softmax(scores)
            ctxs.append(layers.reshape(layers.matmul(w, cv),
                                       [-1, 1, d_model]))
        ctxv = ctxs[0] if S == 1 else layers.concat(ctxs, axis=1)
        att = layers.fc(ctxv, d_model, num_flatten_dims=2,
                        bias_attr=False,
                        param_attr=ParamAttr(name=nm + "_att_o.w_0"))
        x = layers.elementwise_add(x, att)

        h2 = _norm_of(cfg, x, nm + "_pre2")
        f = _ffn(h2, d_model, cfg["d_ff"], nm,
                 act=cfg.get("ffn_act", "relu"))
        x = layers.elementwise_add(x, f)

    x = _final_norm(cfg, x)
    logits = _lm_head(cfg, x)
    return logits, cache_names


def build_serving_decode_step(cfg=None, batch=1, max_len=None):
    """Continuous-batching decode step: ``build_decode_step`` with
    PER-SLOT positions. Feeds are token [B, 1] int64 (each slot's
    current input token) and pos [B, 1] int64 (each slot's own sequence
    position), so the B cache slots advance independently — the serving
    engine (serving/engine.py) admits a new sequence into a free slot
    mid-flight while its neighbors keep decoding, and retires finished
    slots without draining the batch. Every per-slot op is row-local
    (embedding lookup, fc = per-row dots, rope with [B, 1] positions,
    per-row visibility bias, vmapped kv_cache_write), so an active
    slot's logits are bitwise those of the same tokens run through a
    smaller-batch ``build_decode_step`` — the engine's parity contract
    with ``generate`` rests on it.

    Cache/parameter names match ``build_decode_step``; caches are
    [B, n_kv, max_len, Dh] donated state whose batch rows the engine
    treats as independent slots (a free slot's rows are garbage until
    the next prefill-then-insert overwrites them; the per-row mask
    ``cache row <= pos[b]`` keeps garbage out of every live slot's
    attention). Returns (logits_var, cache_names)."""
    return build_decode_step(cfg, batch=batch, max_len=max_len,
                             per_slot_pos=True)


def sample_token(logits_row, rng, temperature=0.0, top_k=0):
    """Sample ONE next token from a single row of logits: float64
    softmax(logits/temperature), optional top-k truncation, seeded
    choice; temperature=0 is greedy argmax. The ONE sampling
    implementation shared by ``generate`` (applied per batch row, in
    row order, on one RandomState) and the serving engine's per-slot
    sampler (its own RandomState per request) — sharing it is what
    makes the engine's outputs bitwise ``generate``'s by construction,
    not just by test."""
    import numpy as np

    lg = logits_row.astype("float64")
    if temperature > 0:
        lg = lg / float(temperature)
        if top_k and top_k > 0:
            k = min(int(top_k), lg.shape[-1])
            kth = np.partition(lg, -k)[-k]
            lg = np.where(lg < kth, -np.inf, lg)
        p = np.exp(lg - lg.max())
        p = p / p.sum()
        return int(rng.choice(p.shape[0], p=p))
    return int(np.argmax(lg))


def generate(exe, decode_prog, logits_var, prompt_ids, n_new, scope,
             temperature=0.0, top_k=0, seed=0, prefill_prog=None,
             prefill_logits=None):
    """Autoregressive generation with the KV-cache decode step.

    prompt_ids: [B, P] int array. Prefills the caches (P one-token
    steps through the decode executable — or ONE dispatch when a
    ``build_prefill_step`` program for this prompt length is passed as
    ``prefill_prog``/``prefill_logits``), then runs n_new sampling
    steps. Returns [B, P + n_new] ids.

    temperature=0 (default) is greedy argmax; temperature>0 samples from
    softmax(logits / temperature), optionally truncated to the top_k
    most likely tokens. Sampling happens host-side (numpy, seeded) —
    the device step stays deterministic and cache-compatible.
    """
    import numpy as np

    ids = np.asarray(prompt_ids, dtype="int64")
    B, P = ids.shape
    max_len = None
    for v in decode_prog.global_block().vars.values():
        if v.name.endswith("_cache_k"):
            max_len = v.shape[2]
    if max_len is not None and P + n_new > max_len:
        raise ValueError(
            "generate: prompt (%d) + new tokens (%d) exceeds the decode "
            "step's max_len=%d — positions past the cache silently clamp "
            "(dynamic_update_slice) and would corrupt output" %
            (P, n_new, max_len))
    if temperature < 0:
        raise ValueError("temperature must be >= 0 (0 = greedy); got %r"
                         % (temperature,))
    rng = np.random.RandomState(seed)

    def sample(lg):
        # one shared sampler applied row by row (draw order = batch
        # order on the one RandomState) — see sample_token
        return np.array([sample_token(lg[b], rng, temperature, top_k)
                         for b in range(B)], dtype="int64")

    out = [ids[:, i] for i in range(P)]
    start = 0
    if prefill_prog is not None and n_new > 0:
        # the prefill program is compiled for ONE prompt length (its
        # 'tokens' feed: [-1, P]); check before dispatch so a mismatch
        # raises this message, not an opaque executor feed-shape error
        tok_var = prefill_prog.global_block().vars.get("tokens")
        if tok_var is not None and int(tok_var.shape[-1]) != P:
            raise ValueError(
                "generate: prefill_prog was built for prompt_len=%d but "
                "prompt_ids has P=%d — rebuild with "
                "build_prefill_step(prompt_len=%d) or pad the prompt"
                % (int(tok_var.shape[-1]), P, P))
        # one dispatch fills positions 0..P-1 and yields the first
        # sampled token from the last prompt position's logits
        (full,) = exe.run(prefill_prog, feed={"tokens": ids},
                          fetch_list=[prefill_logits], scope=scope)
        out.append(sample(full[:, P - 1]))
        start = P
    for t in range(start, P + n_new - 1):
        tok = out[t][:, None]
        (logits,) = exe.run(
            decode_prog,
            feed={"token": tok, "pos": np.array([t], dtype="int64")},
            fetch_list=[logits_var], scope=scope)
        if t + 1 < P:
            continue  # prefill: only the cache write matters
        out.append(sample(logits[:, 0]))
    return np.stack(out, axis=1)
