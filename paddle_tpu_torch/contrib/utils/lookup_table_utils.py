"""Distributed-lookup-table checkpoint utilities.

Reference: python/paddle/fluid/contrib/utils/lookup_table_utils.py —
convert a distributed-trained program (remote sparse table) back to a
local program, and rebuild full parameters from a parameter-server
checkpoint for inference or incremental training.

The TPU build's PS checkpoints are written by the pserver loop
(distributed/ps.py _save_shards) as ``dirname/<ip_port>/shard.npz``
holding this server's parameter blocks — ``name`` for unsliced vars or
``name.block<i>`` slices (distributed/transpiler.py VarBlock naming) —
plus optimizer state; the distributed table lives whole on one server.

The port's copy of paddle_tpu/contrib/utils/lookup_table_utils.py: a
loaded value enters the scope as a tensor on the executor's device (the
executor's ``feed_to_device``), as every scope value of the port does.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional

import numpy as np

from ...core.executor import feed_to_device
from ...core.program import Operator, Program
from ...core.scope import Scope, global_scope

__all__ = ["convert_dist_to_sparse_program",
           "load_persistables_for_increment",
           "load_persistables_for_inference"]

_BLOCK_RE = re.compile(r"^(?P<base>.+)\.block(?P<idx>\d+)$")


def convert_dist_to_sparse_program(program: Program) -> Program:
    """Undo the trainer-side sparse-table surgery: every remote
    ``prefetch`` op (distributed/transpiler.py _rewrite_sparse_tables)
    becomes a local ``lookup_table`` against a recreated table var, so
    the program runs without a cluster (reference :81)."""
    p = program.clone()
    blk = p.global_block()
    new_ops: List[Operator] = []
    for op in blk.ops:
        if op.type == "prefetch":
            wname = op.attrs["table_name"]
            if wname not in blk.vars:
                blk.create_var(name=wname, dtype=op.attrs.get("dtype",
                                                              "float32"),
                               shape=(-1, int(op.attrs["width"])),
                               persistable=True)
            new_ops.append(Operator(
                blk, "lookup_table",
                {"Ids": [op.input("Ids")[0]], "W": [wname]},
                {"Out": [op.output("Out")[0]]},
                {"padding_idx": op.attrs.get("padding_idx", -1)}))
            continue
        if op.type in ("send_sparse",):
            continue  # gradient push has no local meaning
        new_ops.append(op)
    blk.ops = new_ops
    p._bump()
    return p


def _read_shards(dirname: str) -> Dict[str, Dict[int, np.ndarray]]:
    """{base name: {block idx: array}} across every server subdir."""
    pieces: Dict[str, Dict[int, np.ndarray]] = {}
    shard_files = sorted(glob.glob(os.path.join(dirname, "*", "shard.npz")))
    if not shard_files:
        raise FileNotFoundError(
            "no pserver shards (*/shard.npz) under %r — is this a "
            "checkpoint_notify output dir?" % dirname)
    for path in shard_files:
        with np.load(path) as z:
            for name in z.files:
                m = _BLOCK_RE.match(name)
                base, idx = (m.group("base"), int(m.group("idx"))) if m \
                    else (name, 0)
                pieces.setdefault(base, {})[idx] = z[name]
    return pieces


def _merge_blocks(blocks: Dict[int, np.ndarray]) -> np.ndarray:
    return np.concatenate([blocks[i] for i in sorted(blocks)], axis=0) \
        if len(blocks) > 1 else next(iter(blocks.values()))


def load_persistables_for_inference(dirname: str, executor, program: Program,
                                    lookup_table_var_name: Optional[str]
                                    = None, scope: Optional[Scope] = None
                                    ) -> List[str]:
    """Rebuild the program's persistable params (including the sparse
    table) from a PS checkpoint into the scope (reference :229). Only
    parameter values load — optimizer state is skipped. Returns the
    loaded names."""
    scope = scope or global_scope()
    pieces = _read_shards(dirname)
    wanted = {n for b in program.blocks for n, v in b.vars.items()
              if getattr(v, "persistable", False)}
    if lookup_table_var_name:
        wanted.add(lookup_table_var_name)
    loaded = []
    for base, blocks in pieces.items():
        if base in wanted:
            scope.set_var(base, feed_to_device(
                base, _merge_blocks(blocks), None, executor.device))
            loaded.append(base)
    missing = sorted(n for n in wanted
                     if n not in set(loaded) and _is_param(program, n))
    if lookup_table_var_name and lookup_table_var_name not in loaded:
        raise KeyError("lookup table %r not present in checkpoint %r "
                       "(found: %s)" % (lookup_table_var_name, dirname,
                                        sorted(pieces)[:10]))
    if missing:
        import logging

        logging.getLogger(__name__).warning(
            "params not found in PS checkpoint (kept at current values): %s",
            missing[:10])
    return sorted(loaded)


def load_persistables_for_increment(dirname: str, executor,
                                    program: Program,
                                    lookup_table_var=None,
                                    lookup_table_var_path=None,
                                    scope: Optional[Scope] = None
                                    ) -> List[str]:
    """Like load_persistables_for_inference, but also restores optimizer
    state found in the shards so training can continue (reference
    :177). ``lookup_table_var`` (a Variable or name) with
    ``lookup_table_var_path`` (.npy/.npz file) loads a separately-saved
    distributed table on top of the shard contents."""
    scope = scope or global_scope()
    pieces = _read_shards(dirname)
    loaded = []
    for base, blocks in pieces.items():
        scope.set_var(base, feed_to_device(base, _merge_blocks(blocks),
                                           None, executor.device))
        loaded.append(base)
    if (lookup_table_var is None) != (lookup_table_var_path is None):
        raise ValueError("lookup_table_var and lookup_table_var_path must "
                         "be passed together")
    if lookup_table_var is not None:
        name = getattr(lookup_table_var, "name", lookup_table_var)
        arr = np.load(lookup_table_var_path)
        if hasattr(arr, "files"):  # npz: single-array archive
            if len(arr.files) != 1:
                raise ValueError(
                    "%r holds %d arrays; expected exactly one table"
                    % (lookup_table_var_path, len(arr.files)))
            arr = arr[arr.files[0]]
        scope.set_var(name, feed_to_device(name, arr, None,
                                           executor.device))
        loaded.append(name)
    return sorted(loaded)


def _is_param(program: Program, name: str) -> bool:
    from ...core.program import Parameter

    for b in program.blocks:
        if isinstance(b.vars.get(name), Parameter):
            return True
    return False
