"""Contrib: the port's share of paddle_tpu/contrib.

``mixed_precision`` (bf16 AMP: ``decorate(optimizer)``), ``decoder``
(``StateCell``, ``TrainingDecoder``, ``BeamSearchDecoder``; a copy),
``quantize`` (``QuantizeTranspiler``, quantization-aware training with
the fake-quant ops of ops/quant_ops.py; a copy), ``trainer`` /
``inferencer`` (the book tests' driver pair with its four events),
``int8_inference`` (the post-training ``Calibrator``),
``reader.ctr_reader`` and ``utils`` (the distributed lookup table's
checkpoint tools and the HDFS client; copies) are ported; the JAX
package's other contrib modules (``memory_usage_calc``,
``op_frequence``, ``slim``) are not.
"""

from . import inferencer, mixed_precision, trainer  # noqa: F401
from .inferencer import Inferencer  # noqa: F401
from .trainer import (BeginEpochEvent, BeginStepEvent,  # noqa: F401
                      EndEpochEvent, EndStepEvent, Trainer)
from . import quantize  # noqa: F401
from .quantize import QuantizeTranspiler  # noqa: F401
from . import decoder, int8_inference  # noqa: F401
from .reader import ctr_reader  # noqa: F401  (module, per reference usage)
from .int8_inference import Calibrator  # noqa: F401
from . import utils  # noqa: F401
