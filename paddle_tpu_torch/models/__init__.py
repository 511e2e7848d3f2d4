"""Model zoo: the paddle_tpu models this package serves so far (copies;
each is a pure program-builder over the layer API)."""

from . import bert, gpt, transformer  # noqa: F401

__all__ = ["bert", "gpt", "transformer"]
