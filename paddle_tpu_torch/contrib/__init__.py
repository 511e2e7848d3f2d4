"""Contrib: the port's share of paddle_tpu/contrib.

``mixed_precision`` (bf16 AMP: ``decorate(optimizer)``) and ``decoder``
(``StateCell``, ``TrainingDecoder``, ``BeamSearchDecoder``; a copy) are
ported; the JAX package's other contrib modules (the inferencer,
trainer, quantization and slim tools, readers) are not.
"""

from . import decoder, mixed_precision  # noqa: F401
