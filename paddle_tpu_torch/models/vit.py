"""Vision Transformer (ViT) image classifier.

Beyond-reference model family: the reference era (Fluid v1.3) predates
ViT, but the port's flash-attention kernels (K1-K3) and its fused
residual + layer norm (K4) apply to vision exactly as to text once
images become patch-token sequences. Built from the same fluid-style
layer calls as models/transformer.py; the patch embedding is ONE
stride-P conv2d (a product over non-overlapping patches), so the whole
model is attention + dense, no conv tail. A copy of the JAX package's
model.

Feeds: img [B, 3, H, W] float32 (NCHW, matching models/resnet.py's
convention from the reference benchmark models), label [B, 1] int64.
"""

from .. import layers
from ..param_attr import ParamAttr
from .transformer import _ffn, _prenorm, multi_head_attention

__all__ = ["base_config", "build"]


def base_config():
    """ViT-Base/16 at 224x224, ImageNet-1k classes."""
    return dict(image_size=224, patch=16, d_model=768, d_ff=3072,
                n_head=12, n_layer=12, n_class=1000, dropout=0.1)


def build(cfg=None, is_test=False, use_fused_attention=None,
          checkpoints=None):
    """Classification training graph; returns (avg_loss, accuracy).

    Patch tokens = (image_size/patch)^2, plus one learnable CLS token;
    attention is bidirectional with no padding (dense rectangular
    blocks — the flash kernel's best case; the pad-and-mask path covers
    the +1 ragged length). checkpoints collects per-layer recompute
    boundaries for RecomputeOptimizer.
    """
    if use_fused_attention is None:
        from ..ops.attention import fused_attention_enabled

        use_fused_attention = fused_attention_enabled()
    cfg = cfg or base_config()
    size, patch, d_model = cfg["image_size"], cfg["patch"], cfg["d_model"]
    if size % patch:
        raise ValueError("image_size %d must divide by patch %d"
                         % (size, patch))
    n_tok = (size // patch) ** 2

    img = layers.data("img", [3, size, size], dtype="float32")
    label = layers.data("label", [1], dtype="int64")

    # patch embedding: stride-P conv == per-patch linear projection
    x = layers.conv2d(img, num_filters=d_model, filter_size=patch,
                      stride=patch, padding=0, act=None,
                      param_attr=ParamAttr(name="vit_patch.w_0"),
                      bias_attr=ParamAttr(name="vit_patch.b_0"))
    # [B, D, size/P, size/P] -> [B, n_tok, D]
    x = layers.reshape(x, [-1, d_model, n_tok])
    x = layers.transpose(x, perm=[0, 2, 1])

    cls = layers.create_parameter([1, 1, d_model], "float32",
                                  name="vit_cls_token")
    # broadcast the learnable token over the (dynamic) batch: zeros of
    # [B, 1, D] + [1, 1, D] parameter
    zeros = layers.fill_constant_batch_size_like(x, [-1, 1, d_model],
                                                 "float32", 0.0)
    x = layers.concat([layers.elementwise_add(zeros, cls), x], axis=1)

    pos = layers.create_parameter([1, n_tok + 1, d_model], "float32",
                                  name="vit_pos_emb")
    x = layers.elementwise_add(x, pos)
    if cfg["dropout"]:
        x = layers.dropout(x, cfg["dropout"], is_test=is_test)

    for i in range(cfg["n_layer"]):
        nm = "vit_%d" % i
        x = _prenorm(x, lambda h, nm=nm: multi_head_attention(
            h, h, None, d_model, cfg["n_head"], cfg["dropout"],
            is_test, nm + "_att", use_fused_attention),
            cfg["dropout"], is_test, nm + "_pre1")
        x = _prenorm(x, lambda h, nm=nm: _ffn(h, d_model, cfg["d_ff"],
                                              nm),
                     cfg["dropout"], is_test, nm + "_pre2")
        if checkpoints is not None:
            checkpoints.append(x)

    x = layers.layer_norm(x, begin_norm_axis=2,
                          param_attr=ParamAttr(name="vit_ln_f_s"),
                          bias_attr=ParamAttr(name="vit_ln_f_b"))
    # classification head on the CLS token
    head = layers.slice(x, axes=[1], starts=[0], ends=[1])
    head = layers.reshape(head, [-1, d_model])
    logits = layers.fc(head, cfg["n_class"],
                       param_attr=ParamAttr(name="vit_head.w_0"),
                       bias_attr=ParamAttr(name="vit_head.b_0"))
    probs = layers.softmax(logits)
    loss = layers.mean(layers.cross_entropy(probs, label))
    acc = layers.accuracy(probs, label)
    return loss, acc
