"""Op lowerings: importing this package registers every op.

The port registers torch lowerings for the op types of the BERT-base,
GPT, transformer, image-classification (ResNet, VGG, SE-ResNeXt, ViT,
the MNIST CNN), CTR and sequence (stacked LSTM, GRU machine
translation) training programs (forward, grads, Adam, metrics), their
startup programs, the learning-rate schedules, recompute segments,
control flow, the recurrent ops, beam search, the loss and
structured-prediction ops, the Fluid book's models, the quantization ops,
the detection ops, the rest of the layers' op tail, the mesh-parallel
``moe_ffn`` and ``pipeline`` and the parameter server's six wire and
barrier ops, module by module
beside their paddle_tpu/ops counterparts.
"""

from . import (activations, attention, basic,  # noqa: F401
               beam_search_ops, control_flow_ops, detection_ops,
               distributed_ops, fused_ops,
               loss_ops, math, metrics, misc_ops, moe_ops, nn,
               optimizer_ops, pipeline_ops, quant_ops, recompute_ops, rnn,
               scan_ops, sequence, tensor_ops)
