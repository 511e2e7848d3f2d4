"""Global flag registry (the reference's gflags tier, SURVEY §5 config).

The reference defines ~60 DEFINE_* gflags in C++, surfaces them through
core.init_gflags (pybind.cc:880) and reads `FLAGS_*` env vars through the
allowlist in python/paddle/fluid/__init__.py:97-160 (__bootstrap__).
Here the same contract: every flag has a default, can be overridden by a
`FLAGS_<name>` environment variable at import, and is readable/writable
via get_flag / set_flag (fluid.core.globals() analog).

The port of paddle_tpu/flags.py. Most reference flags govern machinery
that PyTorch's caching allocator and the port's executor subsume
(allocator strategy, GPU memory fraction, eager-deletion thresholds);
those are kept as inert knobs for API compatibility and documented as
such. The live one the executor reads is ``check_nan_inf``: with it on,
``Executor.run`` and ``run_repeated`` raise ``FloatingPointError`` on a
fetched float value that is not finite. The JAX package's
``enable_compile_cache`` (a JAX compilation cache) has no counterpart.
"""

from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["DEFINE_flag", "get_flag", "set_flag", "all_flags"]

_FLAGS: Dict[str, Any] = {}
_SUBSUMED = "inert in the port (kept for API compatibility)"


def DEFINE_flag(name: str, default, help_str: str = ""):
    env = os.environ.get("FLAGS_" + name)
    value = default
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    _FLAGS[name] = {"value": value, "default": default, "help": help_str}
    return value


def get_flag(name: str):
    return _FLAGS[name]["value"]


def set_flag(name: str, value) -> None:
    if name not in _FLAGS:
        raise KeyError("unknown flag %r (known: %s)" % (name, sorted(_FLAGS)))
    _FLAGS[name]["value"] = value


def all_flags() -> Dict[str, Any]:
    return {k: v["value"] for k, v in _FLAGS.items()}


# ---- live flags (consumed by this framework) ------------------------------
DEFINE_flag("rpc_deadline", 60.0,
            "seconds a PS RPC client retries before failing "
            "(grpc_client.cc FLAGS_rpc_deadline analog)")
DEFINE_flag("v", 0, "verbose logging level (glog FLAGS_v analog)")
DEFINE_flag("cpu_deterministic", True,
            "XLA lowering is deterministic by construction; flag reads True")
DEFINE_flag("check_nan_inf", False,
            "fetch-side NaN/Inf assertion after each Executor.run")
DEFINE_flag("benchmark", False, "block on results each step when timing")

# ---- inert flags (subsumed by the caching allocator) -----------------------
DEFINE_flag("allocator_strategy", "naive_best_fit", _SUBSUMED)
DEFINE_flag("fraction_of_gpu_memory_to_use", 0.92, _SUBSUMED)
DEFINE_flag("eager_delete_tensor_gb", 0.0, _SUBSUMED)
DEFINE_flag("fast_eager_deletion_mode", True, _SUBSUMED)
DEFINE_flag("memory_fraction_of_eager_deletion", 1.0, _SUBSUMED)
DEFINE_flag("use_pinned_memory", True, _SUBSUMED)
DEFINE_flag("init_allocated_mem", False, _SUBSUMED)
DEFINE_flag("limit_of_tmp_allocation", -1, _SUBSUMED)
