"""Op lowerings: importing this package registers every op.

The port registers torch lowerings for the op types of the BERT-base,
GPT, transformer and image-classification (ResNet, VGG, SE-ResNeXt,
ViT, the MNIST CNN) and CTR training programs (forward, grads, Adam,
metrics), their startup programs, the learning-rate schedules and
recompute segments, module by module beside their paddle_tpu/ops
counterparts.
"""

from . import (activations, attention, basic, fused_ops,  # noqa: F401
               math, metrics, nn, optimizer_ops, recompute_ops, tensor_ops)
