"""Checkpoint save/load and inference-model export.

The port's counterpart of paddle_tpu/io.py, in the same on-disk format:
``__model__.json`` holds the pruned Program, and the persistables go
into one PTCK file (native/tensor_store.py). A directory either package
writes loads in the other. Values leave the device as numpy and come
back as tensors on the executor's device, at the on-device dtype.

One var is the exception: the executor's RNG chain
(``core.executor.RNG_VAR``). The JAX package keeps a
threefry key there, the port a ``torch.Generator`` (a host generator
whose draws seed each step's random ops, eager or replayed). The port
saves the generator's state as a uint8 tensor under that name and
restores a generator from it, so a resumed run replays its dropout
masks bitwise within the port; neither package reads the other's chain.

``save_persistables_async`` takes its snapshot before it returns: a
replayed CUDA graph updates the scope's tensors in place at the next
step, so every value is copied to pinned host memory (one non-blocking
copy each on the current stream, then one event waited on) before the
background thread writes the file.
"""

from __future__ import annotations

import json
import os
import threading
from typing import List

import numpy as np
import torch

from .core.executor import RNG_VAR
from .core.lowering import as_torch_dtype
from .core.place import require_device
from .core.program import (Block, Operator, Parameter, Program, Variable,
                           default_main_program)
from .core.scope import global_scope
from .native import tensor_store
from .native.tensor_store import MAGIC, load_tensors

__all__ = [
    "save_vars",
    "save_params",
    "save_persistables",
    "save_persistables_async",
    "AsyncCheckpoint",
    "load_vars",
    "load_params",
    "load_persistables",
    "save_inference_model",
    "load_inference_model",
]

_COMBINED = "__model_combined__"
_MODEL_FILE = "__model__.json"


def _load_blob(dirname, filename):
    path = os.path.join(dirname, filename or _COMBINED)
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic != MAGIC:
        raise IOError("%s is not a PTCK checkpoint (legacy .npz "
                      "checkpoints are not read by this package)" % path)
    return path, load_tensors(path)


def _persistable_names(program: Program, predicate) -> List[str]:
    names = []
    for var in program.list_vars():
        if var.persistable and predicate(var):
            names.append(var.name)
    return sorted(set(names))


def _var_names(program, vars, predicate) -> List[str]:
    if vars is not None:
        return [v.name if hasattr(v, "name") else v for v in vars]
    return _persistable_names(program, predicate or (lambda v: True))


def _scope_values(scope, names):
    """(name, value) of each name; a missing one raises in the caller's
    thread."""
    vals = []
    for n in names:
        v = scope.find_var(n)
        if v is None:
            raise RuntimeError("variable %r not initialized; cannot save" % n)
        vals.append((n, v))
    return vals


def _snapshot(vals):
    """Every value as a host numpy array the caller owns, complete when
    this returns: a generator as its state, a CPU tensor copied, a CUDA
    tensor copied into pinned memory (all copies issued non-blocking on
    the current stream, then one event waited on)."""
    out, card = {}, None
    for n, v in vals:
        if isinstance(v, torch.Generator):
            out[n] = v.get_state()
        elif isinstance(v, torch.Tensor) and v.device.type == "cuda":
            out[n] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            out[n].copy_(v, non_blocking=True)
            card = v.device
        elif isinstance(v, torch.Tensor):
            out[n] = v.detach().clone()
        else:
            out[n] = np.array(v)
    if card is not None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(card))
        event.synchronize()
    return {n: t.numpy() if isinstance(t, torch.Tensor) else t
            for n, t in out.items()}


class _EventThread:
    """Thread-shaped wrapper over an Event so an inline (sync) writer can
    occupy a slot in the _PENDING chain: async writers only ever call
    ``join()``/``is_alive()`` on the previous entry's ``_thread``."""

    def __init__(self):
        self._done = threading.Event()

    def finish(self):
        self._done.set()

    def join(self, timeout=None):
        self._done.wait(timeout)

    def is_alive(self):
        return not self._done.is_set()


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None, scope=None):
    program = main_program or default_main_program()
    scope = scope or global_scope()
    names = _var_names(program, vars, predicate)
    os.makedirs(dirname, exist_ok=True)
    arrays = _snapshot(_scope_values(scope, names))
    path = os.path.join(dirname, filename or _COMBINED)
    # a sync save racing in-flight async writes to the same path: the
    # sync caller expects its snapshot to be the final file, so the
    # sync write rides the same serialize-on-prev chain the async
    # writers use: it registers in _PENDING (later async saves chain
    # behind it), joins every earlier writer, then writes inline.
    handle = AsyncCheckpoint(_EventThread(), path)
    with _PENDING_LOCK:
        prev = _PENDING.get(path)
        _PENDING[path] = handle
    try:
        if prev is not None:
            prev._thread.join()
        tensor_store.save_tensors(path, arrays)
    finally:
        handle._thread.finish()
        with _PENDING_LOCK:
            if _PENDING.get(path) is handle:
                del _PENDING[path]


def save_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    save_vars(executor, dirname, main_program,
              predicate=lambda v: isinstance(v, Parameter), filename=filename,
              scope=scope)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    save_vars(executor, dirname, main_program,
              predicate=lambda v: v.persistable, filename=filename,
              scope=scope)


class AsyncCheckpoint:
    """Handle for a background checkpoint write started by
    ``save_persistables_async``. ``wait()`` blocks until the file is
    durably in place and re-raises any write error; ``done()`` polls.
    The checkpoint is atomic either way (tensor_store writes a temp
    file and ``os.replace``\\ s it), so a crash mid-write never leaves
    a torn file at the target path."""

    def __init__(self, thread, path):
        self._thread = thread
        self._err = []
        self.path = path

    def done(self) -> bool:
        return not self._thread.is_alive()

    def wait(self) -> None:
        self._thread.join()
        if self._err:
            raise self._err[0]

    result = wait


# in-flight writes keyed by target path: a second save to the same path
# must wait for the first (both would stage the same '<path>.tmp' file),
# and interpreter exit must not truncate a write. The lock is created
# eagerly: a lazy check-then-set could mint two distinct locks under
# first-call contention, unguarding _PENDING.
_PENDING_LOCK = threading.Lock()
_PENDING = {}


def save_persistables_async(executor, dirname, main_program=None,
                            filename=None, scope=None,
                            extra_vars=()) -> AsyncCheckpoint:
    """Non-blocking ``save_persistables``: the snapshot is synchronous
    (every value off the device and complete before control returns,
    since the next replayed step updates the scope's tensors in place),
    then serialization and the atomic rename run on a background thread
    while training continues. Returns an :class:`AsyncCheckpoint`: call
    ``wait()`` before depending on the file.

    ``extra_vars``: additional scope var names snapshotted alongside the
    program's persistables when present (names absent from the scope
    are skipped, not errors). Pass ``[core.executor.RNG_VAR]`` so a resumed
    run replays its dropout masks bitwise (``load_vars(vars=...)``
    restores the chain)."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    names = _persistable_names(program, lambda v: v.persistable)
    for n in extra_vars:
        if n not in names and scope.find_var(n) is not None:
            names.append(n)
    arrays = _snapshot(_scope_values(scope, names))
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, filename or _COMBINED)

    def write(prev, handle):
        try:
            if prev is not None:
                prev._thread.join()  # serialize same-path writes
            tensor_store.save_tensors(path, arrays)
        except BaseException as e:  # surfaced by wait()
            handle._err.append(e)
        finally:
            with _PENDING_LOCK:
                if _PENDING.get(path) is handle:
                    del _PENDING[path]

    with _PENDING_LOCK:
        prev = _PENDING.get(path)
        handle = AsyncCheckpoint(None, path)
        handle._thread = threading.Thread(
            target=write, args=(prev, handle), daemon=False,
            name="paddle-tpu-ckpt-write")
        _PENDING[path] = handle
        handle._thread.start()
    return handle


def _restored_chain(path, value) -> torch.Generator:
    """The RNG chain from its saved state (a uint8 tensor the port
    wrote; the JAX package's threefry key is refused)."""
    if value.dtype != np.uint8:
        raise RuntimeError(
            "checkpoint %s holds %s as %s %s, not a torch.Generator state: "
            "the RNG chain is the one var the JAX package and the port do "
            "not share" % (path, RNG_VAR, value.dtype, value.shape))
    rng = torch.Generator()
    rng.set_state(torch.from_numpy(np.array(value)))
    return rng


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None, scope=None):
    program = main_program or default_main_program()
    scope = scope or global_scope()
    path, data = _load_blob(dirname, filename)
    names = _var_names(program, vars, predicate)
    device = require_device(executor.device)
    block = program.global_block()
    for n in names:
        if n not in data:
            raise RuntimeError("checkpoint %s lacks variable %r" % (path, n))
        if n == RNG_VAR:
            scope.set_var(n, _restored_chain(path, data[n]))
            continue
        var = block.vars.get(n)
        t = torch.from_numpy(data[n])
        dtype = as_torch_dtype(var.dtype) if var is not None else t.dtype
        scope.set_var(n, t.to(device=device, dtype=dtype))


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    load_vars(executor, dirname, main_program,
              predicate=lambda v: isinstance(v, Parameter), filename=filename,
              scope=scope)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    load_vars(executor, dirname, main_program,
              predicate=lambda v: v.persistable, filename=filename, scope=scope)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None):
    """Prune to the inference subgraph + save params (reference io.py:863 /
    framework/prune.cc)."""
    program = main_program or default_main_program()
    pruned = program._prune(target_vars)
    os.makedirs(dirname, exist_ok=True)
    meta = {
        "feed": list(feeded_var_names),
        "fetch": [v.name if hasattr(v, "name") else v for v in target_vars],
        "program": pruned.to_dict(),
    }
    with open(os.path.join(dirname, model_filename or _MODEL_FILE), "w") as f:
        json.dump(meta, f)
    save_persistables(executor, dirname, pruned, filename=params_filename)
    return meta["fetch"]


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, scope=None):
    with open(os.path.join(dirname, model_filename or _MODEL_FILE)) as f:
        meta = json.load(f)
    program = _program_from_dict(meta["program"])
    load_persistables(executor, dirname, program, filename=params_filename,
                      scope=scope)
    return program, meta["feed"], [program.global_block().var(n)
                                   for n in meta["fetch"]]


def _program_from_dict(d) -> Program:
    p = Program()
    p.random_seed = d.get("random_seed")
    p.amp = bool(d.get("amp", False))
    p.grad_accum_steps = int(d.get("grad_accum_steps", 1))
    p.blocks = []
    for bd in d["blocks"]:
        b = Block(p, bd["idx"], bd["parent_idx"])
        for name, vd in bd["vars"].items():
            v = Variable(
                b, name,
                shape=vd["shape"], dtype=vd["dtype"],
                persistable=vd["persistable"], stop_gradient=vd["stop_gradient"],
                is_data=vd["is_data"], lod_level=vd.get("lod_level", 0),
            )
            b.vars[name] = v
        for od in bd["ops"]:
            op = Operator(b, od["type"], None, None, od["attrs"])
            op.inputs = {k: list(v) for k, v in od["inputs"].items()}
            op.outputs = {k: list(v) for k, v in od["outputs"].items()}
            b.ops.append(op)
        p.blocks.append(b)
    return p
