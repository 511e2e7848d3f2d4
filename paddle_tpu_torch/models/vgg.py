"""VGG-16 (reference benchmark/fluid/models/vgg.py vgg16_bn_drop)."""

from .. import layers, nets

__all__ = ["vgg16", "build"]


def _conv_block(input, num_filter, groups, dropouts):
    return nets.img_conv_group(
        input=input,
        conv_num_filter=[num_filter] * groups,
        conv_filter_size=3,
        conv_act="relu",
        conv_with_batchnorm=True,
        conv_batchnorm_drop_rate=dropouts,
        pool_size=2,
        pool_stride=2,
        pool_type="max",
    )


def vgg16(img, class_dim=1000):
    c1 = _conv_block(img, 64, 2, [0.3, 0.0])
    c2 = _conv_block(c1, 128, 2, [0.4, 0.0])
    c3 = _conv_block(c2, 256, 3, [0.4, 0.4, 0.0])
    c4 = _conv_block(c3, 512, 3, [0.4, 0.4, 0.0])
    c5 = _conv_block(c4, 512, 3, [0.4, 0.4, 0.0])
    d1 = layers.dropout(c5, dropout_prob=0.5)
    fc1 = layers.fc(d1, size=512)
    bn = layers.batch_norm(fc1, act="relu")
    d2 = layers.dropout(bn, dropout_prob=0.5)
    fc2 = layers.fc(d2, size=512)
    return layers.fc(fc2, size=class_dim, act="softmax")


def build(class_dim=1000, image_shape=(3, 224, 224)):
    img = layers.data("img", list(image_shape))
    label = layers.data("label", [1], dtype="int64")
    probs = vgg16(img, class_dim=class_dim)
    loss = layers.mean(layers.cross_entropy(probs, label))
    acc = layers.accuracy(probs, label)
    return loss, acc, [img, label]
