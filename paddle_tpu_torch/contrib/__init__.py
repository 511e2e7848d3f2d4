"""Contrib: the port's share of paddle_tpu/contrib.

Only ``mixed_precision`` (bf16 AMP: ``decorate(optimizer)``) is ported
so far; the JAX package's other contrib modules (the inferencer,
trainer, quantization and slim tools, readers) are not.
"""

from . import mixed_precision  # noqa: F401
