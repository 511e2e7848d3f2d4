"""SE-ResNeXt for ImageNet (reference benchmark/fluid/models/se_resnext.py).

ResNeXt bottlenecks (grouped 3x3, cardinality 32/64) with
squeeze-and-excitation gates: global-avg-pool -> fc(C/r, relu) ->
fc(C, sigmoid) channel scaling, reduction_ratio 16. Depths 50/101/152
select stage repeats like the reference's SE_ResNeXt class. Grouped
convs are ``conv2d`` with ``groups``; the SE gates are elementwise ops.
A copy of the JAX package's model.
"""

from .. import layers

__all__ = ["se_resnext", "build"]

_DEPTH_CFG = {
    50: ([3, 4, 6, 3], 32),
    101: ([3, 4, 23, 3], 32),
    152: ([3, 8, 36, 3], 64),
}


def _conv_bn(input, num_filters, filter_size, stride=1, groups=1, act=None):
    conv = layers.conv2d(input, num_filters, filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         bias_attr=False)
    return layers.batch_norm(conv, act=act)


def _squeeze_excitation(input, num_channels, reduction_ratio=16):
    pool = layers.pool2d(input, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(pool, size=num_channels // reduction_ratio,
                        act="relu")
    excite = layers.fc(squeeze, size=num_channels, act="sigmoid")
    # [N, C] gate scales [N, C, H, W] channels
    gate = layers.unsqueeze(layers.unsqueeze(excite, [2]), [3])
    return layers.elementwise_mul(input, gate)


def _shortcut(input, ch_out, stride):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return _conv_bn(input, ch_out, 1, stride)
    return input


def _bottleneck(input, num_filters, stride, cardinality, reduction_ratio):
    c0 = _conv_bn(input, num_filters, 1, act="relu")
    c1 = _conv_bn(c0, num_filters, 3, stride=stride, groups=cardinality,
                  act="relu")
    c2 = _conv_bn(c1, num_filters * 2, 1)
    se = _squeeze_excitation(c2, num_filters * 2, reduction_ratio)
    short = _shortcut(input, num_filters * 2, stride)
    return layers.relu(layers.elementwise_add(se, short))


def se_resnext(img, class_dim=1000, depth=50):
    repeats, cardinality = _DEPTH_CFG[depth]
    if depth == 152:
        t = _conv_bn(img, 64, 3, stride=2, act="relu")
        t = _conv_bn(t, 64, 3, act="relu")
        t = _conv_bn(t, 128, 3, act="relu")
    else:
        t = _conv_bn(img, 64, 7, stride=2, act="relu")
    t = layers.pool2d(t, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    num_filters = [128, 256, 512, 1024]
    for stage, n in enumerate(repeats):
        for block in range(n):
            stride = 2 if block == 0 and stage != 0 else 1
            t = _bottleneck(t, num_filters[stage], stride, cardinality,
                            reduction_ratio=16)
    pool = layers.pool2d(t, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool, dropout_prob=0.5)
    return layers.fc(drop, size=class_dim, act="softmax")


def build(class_dim=1000, depth=50, image_shape=(3, 224, 224)):
    """Training graph: returns (avg_loss, accuracy, probs) like
    models/resnet.build."""
    img = layers.data("img", list(image_shape))
    label = layers.data("label", [1], dtype="int64")
    probs = se_resnext(img, class_dim=class_dim, depth=depth)
    loss = layers.mean(layers.cross_entropy(probs, label))
    acc = layers.accuracy(probs, label)
    return loss, acc, probs
