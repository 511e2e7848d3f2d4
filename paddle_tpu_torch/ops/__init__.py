"""Op lowerings: importing this package registers every op.

The port registers torch lowerings for the op types of the BERT-base,
GPT, transformer, image-classification (ResNet, VGG, SE-ResNeXt, ViT,
the MNIST CNN), CTR and sequence (stacked LSTM, GRU machine
translation) training programs (forward, grads, Adam, metrics), their
startup programs, the learning-rate schedules, recompute segments,
control flow, the recurrent ops and beam search, module by module
beside their paddle_tpu/ops counterparts.
"""

from . import (activations, attention, basic,  # noqa: F401
               beam_search_ops, control_flow_ops, fused_ops, math,
               metrics, misc_ops, nn, optimizer_ops, recompute_ops, rnn,
               scan_ops, sequence, tensor_ops)
