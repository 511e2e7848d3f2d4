"""Model zoo: the paddle_tpu models (copies; each is a pure
program-builder over the layer API), all eleven of the JAX package's."""

from . import (bert, ctr, gpt, machine_translation, mnist,  # noqa: F401
               resnet, se_resnext, stacked_lstm, transformer, vgg, vit)

__all__ = ["bert", "ctr", "gpt", "machine_translation", "mnist", "resnet",
           "se_resnext", "stacked_lstm", "transformer", "vgg", "vit"]
