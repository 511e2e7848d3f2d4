"""Contrib: the port's share of paddle_tpu/contrib.

``mixed_precision`` (bf16 AMP: ``decorate(optimizer)``), ``decoder``
(``StateCell``, ``TrainingDecoder``, ``BeamSearchDecoder``; a copy) and
``quantize`` (``QuantizeTranspiler``, quantization-aware training with
the fake-quant ops of ops/quant_ops.py; a copy) are ported; the JAX
package's other contrib modules (the inferencer, trainer, int8
inference and slim tools, readers) are not.
"""

from . import decoder, mixed_precision, quantize  # noqa: F401
from .quantize import QuantizeTranspiler  # noqa: F401
