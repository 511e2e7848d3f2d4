"""fluid.learning_rate_decay (reference: the pre-layers alias of
python/paddle/fluid/layers/learning_rate_scheduler.py — same functions,
older import path kept public in v1.3)."""

from .layers.learning_rate_scheduler import *  # noqa: F401,F403
from .layers.learning_rate_scheduler import __all__  # noqa: F401
