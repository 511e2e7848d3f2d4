"""ResNet for ImageNet/cifar (reference benchmark/fluid/models/resnet.py).

Bottleneck-v1 topology: conv7x7/2 -> maxpool/2 -> 4 stages of bottleneck
blocks -> global avgpool -> fc. Depth 50/101/152 select the stage repeat
counts, as in the reference's `resnet_imagenet` model zoo. BN uses the
moving-average train/test split (the running stats are persistables the
step writes; the Predictor serves them with ``is_test``). A copy of the
JAX package's model.
"""

from .. import layers

__all__ = ["resnet_imagenet", "build"]

_DEPTH_CFG = {
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}


def _conv_bn(input, num_filters, filter_size, stride=1, act=None):
    conv = layers.conv2d(input, num_filters, filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, bias_attr=False)
    return layers.batch_norm(conv, act=act)


def _shortcut(input, ch_out, stride):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return _conv_bn(input, ch_out, 1, stride)
    return input


def _bottleneck(input, num_filters, stride):
    c0 = _conv_bn(input, num_filters, 1, act="relu")
    c1 = _conv_bn(c0, num_filters, 3, stride=stride, act="relu")
    c2 = _conv_bn(c1, num_filters * 4, 1)
    short = _shortcut(input, num_filters * 4, stride)
    return layers.relu(layers.elementwise_add(c2, short))


def resnet_imagenet(img, class_dim=1000, depth=50):
    cfg = _DEPTH_CFG[depth]
    conv = _conv_bn(img, 64, 7, stride=2, act="relu")
    pool = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1,
                         pool_type="max")
    x = pool
    for stage, count in enumerate(cfg):
        filters = 64 * (2 ** stage)
        for i in range(count):
            stride = 2 if i == 0 and stage > 0 else 1
            x = _bottleneck(x, filters, stride)
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    return layers.fc(pool, size=class_dim, act="softmax")


def build(class_dim=1000, depth=50, image_shape=(3, 224, 224)):
    img = layers.data("img", list(image_shape))
    label = layers.data("label", [1], dtype="int64")
    probs = resnet_imagenet(img, class_dim=class_dim, depth=depth)
    loss = layers.mean(layers.cross_entropy(probs, label))
    acc = layers.accuracy(probs, label)
    return loss, acc, [img, label]
