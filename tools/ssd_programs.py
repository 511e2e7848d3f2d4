"""SSD300 on a VGG-16 base (Liu et al. 2016, "SSD: Single Shot MultiBox
Detector"; the settings of its Caffe ``ssd_pascal.py``): a user's
program over ``multi_box_head``, ``ssd_loss`` and ``detection_output``,
built with either package's layer API (``paddle_tpu`` or
``paddle_tpu_torch``: the two build the same Program), with synthetic
images and boxes made from a seed. No dataset is read.

- Base: VGG-16's conv1-conv5 blocks (3 x 3 convs, ReLU, no batch norm),
  2 x 2 max pools; pool3 pads by 1 so conv4_3 is 38 x 38 (Caffe's pool
  rounds up: neither package's ``pool2d`` has ``ceil_mode``); pool5 3 x
  3 / 1 / pad 1; fc6 a 3 x 3 conv of 1024 at dilation 6, pad 6; fc7 a 1 x
  1 conv of 1024.
- Extras: 1 x 1 256 -> 3 x 3 / 2 512; 1 x 1 128 -> 3 x 3 / 2 256; twice
  1 x 1 128 -> 3 x 3 pad 0 256.
- Heads on conv4_3 (38^2; ``l2_normalize`` over channels times a
  per-channel scale that starts at 20), fc7 (19^2), 10^2, 5^2, 3^2 and
  1^2; ``multi_box_head`` with min sizes 30-264, max sizes 60-315,
  aspect ratios [2], [2, 3] x 3, [2], [2], steps 8-300, flip, variance
  (0.1, 0.1, 0.2, 0.2), 3 x 3 heads: 4 / 6 / 6 / 6 / 4 / 4 priors a
  cell, 8732 priors.
- Training: ``ssd_loss`` (overlap 0.5, 3 negatives a positive) over gt
  padded to 16 boxes an image by zero-area rows, its batch mean, Adam
  at 1e-3. Inference: ``detection_output`` over softmaxed confidences
  (NMS 0.45, nms_top_k 400, keep_top_k 200, score threshold 0.01): [B,
  200, 6] rows (class, score, box), -1 padded.

``multi_box_head`` reshapes each head with its feature map's static
batch, so an SSD program's batch is fixed: build one program a batch
size (the weights are shared by name: build each under a fresh
``unique_name.guard``). ``width`` divides every conv's channels (the
tests run at 1/16 on the CPU).

    python3 tools/ssd_programs.py     # 3 steps at 1/16 width, CPU
"""

from __future__ import annotations

import os
import sys

import numpy as np

SSD300 = dict(
    image=300, classes=21, gt=16, lr=1e-3,
    min_sizes=[30.0, 60.0, 111.0, 162.0, 213.0, 264.0],
    max_sizes=[60.0, 111.0, 162.0, 213.0, 264.0, 315.0],
    aspect_ratios=[[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0], [2.0]],
    steps=[8.0, 16.0, 32.0, 64.0, 100.0, 300.0],
    variance=(0.1, 0.1, 0.2, 0.2),
    overlap=0.5, neg_pos_ratio=3.0,
    nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
    score_threshold=0.01)
N_PRIORS = 8732


def _features(fluid, img, width):
    """The six head inputs: conv4_3 (normalized, scaled), fc7 and the
    four extras' outputs."""
    L = fluid.layers

    def conv(x, n, k, **kw):
        return L.conv2d(x, num_filters=max(n // width, 1), filter_size=k,
                        act="relu", **kw)

    def block(x, n, reps):
        for _ in range(reps):
            x = conv(x, n, 3, padding=1)
        return x

    x = L.pool2d(block(img, 64, 2), 2, "max", 2)
    x = L.pool2d(block(x, 128, 2), 2, "max", 2)
    x = L.pool2d(block(x, 256, 3), 2, "max", 2, pool_padding=1)
    conv4_3 = block(x, 512, 3)
    x = L.pool2d(conv4_3, 2, "max", 2)
    x = L.pool2d(block(x, 512, 3), 3, "max", 1, pool_padding=1)
    fc7 = conv(conv(x, 1024, 3, padding=6, dilation=6), 1024, 1)
    # the scale as [1, C, 1, 1]: the layers' static shape of an
    # elementwise op ignores ``axis`` (ROADMAP §C), and the heads read it
    c4 = max(512 // width, 1)
    scale = L.create_parameter(
        [c4], "float32", default_initializer=fluid.initializer.Constant(20.0))
    norm4_3 = L.elementwise_mul(L.l2_normalize(conv4_3, axis=1),
                                L.reshape(scale, [1, c4, 1, 1]))
    c6 = conv(conv(fc7, 256, 1), 512, 3, stride=2, padding=1)
    c7 = conv(conv(c6, 128, 1), 256, 3, stride=2, padding=1)
    c8 = conv(conv(c7, 128, 1), 256, 3)
    c9 = conv(conv(c8, 128, 1), 256, 3)
    return [norm4_3, fc7, c6, c7, c8, c9]


def build(fluid, batch, train=True, width=1):
    """SSD300 into the current ``program_guard`` at a static ``batch``.
    Training: Adam on the mean ``ssd_loss``, returns (loss, priors);
    otherwise (detections [batch, keep_top_k, 6], priors). Feeds:
    ``img`` [batch, 3, 300, 300] f32, and for training ``gt_box``
    [batch, gt, 4] (normalized xyxy, zero rows pad) and ``gt_label``
    [batch, gt] int64."""
    L = fluid.layers
    s = SSD300["image"]
    img = L.data("img", [batch, 3, s, s], append_batch_size=False)
    locs, confs, priors, pvar = L.multi_box_head(
        _features(fluid, img, width), img, base_size=s,
        num_classes=SSD300["classes"], aspect_ratios=SSD300["aspect_ratios"],
        min_sizes=SSD300["min_sizes"], max_sizes=SSD300["max_sizes"],
        steps=SSD300["steps"], flip=True, variance=SSD300["variance"],
        kernel_size=3, pad=1)
    if not train:
        return L.detection_output(
            locs, L.softmax(confs), priors, pvar,
            nms_threshold=SSD300["nms_threshold"],
            nms_top_k=SSD300["nms_top_k"], keep_top_k=SSD300["keep_top_k"],
            score_threshold=SSD300["score_threshold"]), priors
    gt_box = L.data("gt_box", [batch, SSD300["gt"], 4],
                    append_batch_size=False)
    gt_label = L.data("gt_label", [batch, SSD300["gt"]], dtype="int64",
                      append_batch_size=False)
    loss = L.reduce_mean(L.ssd_loss(
        locs, confs, gt_box, gt_label, priors, pvar,
        overlap_threshold=SSD300["overlap"],
        neg_pos_ratio=SSD300["neg_pos_ratio"]))
    fluid.optimizer.Adam(learning_rate=SSD300["lr"]).minimize(loss)
    return loss, priors


def batch_feed(batch, seed, train=True):
    """Synthetic images (N(0, 1) pixels) and, for training, 1 to 8 boxes
    an image (sides 0.1-0.6 of the image, labels 1-20) padded to ``gt``
    rows by zero-area boxes, made from ``seed``."""
    rs = np.random.RandomState(seed)
    s = SSD300["image"]
    feed = {"img": rs.randn(batch, 3, s, s).astype("float32")}
    if not train:
        return feed
    box = np.zeros((batch, SSD300["gt"], 4), "float32")
    label = np.zeros((batch, SSD300["gt"]), "int64")
    for b in range(batch):
        n = rs.randint(1, 9)
        wh = rs.uniform(0.1, 0.6, (n, 2))
        lo = rs.uniform(0.0, 1.0, (n, 2)) * (1.0 - wh)
        box[b, :n] = np.concatenate([lo, lo + wh], 1)
        label[b, :n] = rs.randint(1, SSD300["classes"], n)
    feed["gt_box"], feed["gt_label"] = box, label
    return feed


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import paddle_tpu_torch as fluid

    main_p, startup = fluid.Program(), fluid.Program()
    main_p.random_seed = startup.random_seed = 1234
    with fluid.program_guard(main_p, startup), fluid.unique_name.guard():
        loss, priors = build(fluid, 2, width=16)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    for step in range(3):
        (lv, pv) = exe.run(main_p, feed=batch_feed(2, step),
                           fetch_list=[loss, priors], scope=scope)
        print("step %d: loss %.5f, %d priors" % (step, float(lv),
                                                 pv.shape[0]))


if __name__ == "__main__":
    main()
