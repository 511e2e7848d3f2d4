"""Datasets (reference: python/paddle/dataset/ — mnist, cifar, imdb,
uci_housing, movielens, wmt14/16...). The reference downloads real corpora;
the package reads no network, so each module synthesizes a deterministic,
*learnable* surrogate with the same sample schema and reader API. Point
PADDLE_TPU_DATA_HOME at real data to swap in actual corpora."""

from . import (cifar, common, conll05, flowers, image, imdb, imikolov, mnist,  # noqa: F401
               movielens, mq2007, sentiment, uci_housing, voc2012, wmt14,
               wmt16)
