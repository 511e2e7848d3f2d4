from . import ctr_reader  # noqa: F401
