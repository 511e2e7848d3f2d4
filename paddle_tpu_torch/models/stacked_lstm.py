"""Stacked LSTM sentiment/LM model (reference
benchmark/fluid/models/stacked_dynamic_lstm.py): embedding → N stacked
dynamic_lstm layers → sequence max-pool → softmax classifier, on padded
batches + explicit lengths."""

from __future__ import annotations

from .. import layers

__all__ = ["config", "build"]


def config():
    return {
        "vocab": 5000,
        "emb_dim": 128,
        "hidden": 128,
        "num_layers": 3,
        "num_classes": 2,
        "seq_len": 80,
    }


def build(cfg=None, seq_len=None):
    cfg = dict(config(), **(cfg or {}))
    T = seq_len or cfg["seq_len"]
    words = layers.data("words", [T], dtype="int64")
    label = layers.data("label", [1], dtype="int64")
    length = layers.data("length", [], dtype="int64")

    x = layers.embedding(words, size=[cfg["vocab"], cfg["emb_dim"]])
    for i in range(cfg["num_layers"]):
        # unique prefix: a bare "lstm_%d" would collide with the global
        # unique_name counter's auto-generated LayerHelper names
        proj = layers.fc(x, size=cfg["hidden"] * 4, num_flatten_dims=2,
                         name="sdlstm_fc_%d" % i)
        x, _cell = layers.dynamic_lstm(proj, size=cfg["hidden"] * 4,
                                       seq_len=length,
                                       name="sdlstm_cell_%d" % i)
    pooled = layers.sequence_pool(x, "max", length=length)
    probs = layers.fc(pooled, size=cfg["num_classes"], act="softmax")
    loss = layers.mean(layers.cross_entropy(probs, label))
    acc = layers.accuracy(probs, label)
    return loss, {"words": words, "label": label, "length": length,
                  "probs": probs, "acc": acc}
