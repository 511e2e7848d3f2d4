"""Model zoo: the paddle_tpu models this package serves so far (copies;
each is a pure program-builder over the layer API)."""

from . import (bert, ctr, gpt, mnist, resnet, se_resnext,  # noqa: F401
               transformer, vgg, vit)

__all__ = ["bert", "ctr", "gpt", "mnist", "resnet", "se_resnext",
           "transformer", "vgg", "vit"]
