"""Composite nets (reference: python/paddle/fluid/nets.py — simple_img_conv_pool,
img_conv_group, sequence_conv_pool, glu, scaled_dot_product_attention)."""

from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "glu",
           "scaled_dot_product_attention", "sequence_conv_pool"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size, pool_stride,
                         pool_padding=0, pool_type="max", global_pooling=False,
                         conv_stride=1, conv_padding=0, conv_dilation=1,
                         conv_groups=1, param_attr=None, bias_attr=None,
                         act=None, use_cudnn=True):
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr, act=act,
    )
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling,
    )


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    tmp = input
    n = len(conv_num_filter)

    def _expand(v):
        return v if isinstance(v, (list, tuple)) else [v] * n

    padding = _expand(conv_padding)
    fsize = _expand(conv_filter_size)
    pattr = _expand(param_attr)
    with_bn = _expand(conv_with_batchnorm)
    drop = _expand(conv_batchnorm_drop_rate)
    for i in range(n):
        act = conv_act if not with_bn[i] else None
        tmp = layers.conv2d(tmp, conv_num_filter[i], fsize[i], padding=padding[i],
                            param_attr=pattr[i], act=act)
        if with_bn[i]:
            tmp = layers.batch_norm(tmp, act=conv_act)
            if drop[i]:
                tmp = layers.dropout(tmp, drop[i])
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                        pool_stride=pool_stride)


def glu(input, dim=-1):
    a, b = layers.split(input, 2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Reference nets.py attention; the fused/flash path is
    layers.fused_attention (ops/pallas)."""
    d = queries.shape[-1]
    product = layers.matmul(queries, keys, transpose_y=True,
                            alpha=float(d) ** -0.5)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_rate)
    return layers.matmul(weights, values)


def sequence_conv_pool(input, num_filters, filter_size, length=None,
                       param_attr=None, act="sigmoid", pool_type="max",
                       bias_attr=None):
    """reference nets.py:248 — sequence_conv + sequence_pool over a
    padded [B, T, D] batch (`length` replaces LoD, the sequence-family
    contract of layers/sequence.py)."""
    conv = layers.sequence_conv(input, num_filters=num_filters,
                                filter_size=filter_size, length=length,
                                param_attr=param_attr, act=act,
                                bias_attr=bias_attr)
    return layers.sequence_pool(conv, pool_type=pool_type, length=length)
