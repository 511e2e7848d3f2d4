"""MNIST models (reference benchmark/fluid/models/mnist.py cnn_model and
tests/book/test_recognize_digits.py MLP)."""

from .. import layers, nets

__all__ = ["mlp", "cnn", "build"]


def mlp(img):
    h = layers.fc(img, size=200, act="tanh")
    h = layers.fc(h, size=200, act="tanh")
    return layers.fc(h, size=10, act="softmax")


def cnn(img):
    if len(img.shape) == 2:
        img = layers.reshape(img, [-1, 1, 28, 28])
    c1 = nets.simple_img_conv_pool(img, num_filters=20, filter_size=5,
                                   pool_size=2, pool_stride=2, act="relu")
    c2 = nets.simple_img_conv_pool(c1, num_filters=50, filter_size=5,
                                   pool_size=2, pool_stride=2, act="relu")
    return layers.fc(c2, size=10, act="softmax")


def build(net="cnn"):
    """Returns (loss, acc, feeds) — the benchmark-model contract."""
    img = layers.data("img", [784])
    label = layers.data("label", [1], dtype="int64")
    probs = (cnn if net == "cnn" else mlp)(img)
    loss = layers.mean(layers.cross_entropy(probs, label))
    acc = layers.accuracy(probs, label)
    return loss, acc, [img, label]
