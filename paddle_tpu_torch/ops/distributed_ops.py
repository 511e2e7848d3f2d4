"""Distributed PS ops: send / recv / barriers / distributed lookup prefetch.

Analogs of /root/reference/paddle/fluid/operators/distributed_ops/
(send_op.cc, recv_op.cc, send_barrier_op.cc, fetch_barrier_op.cc,
prefetch_op.cc), and the port's counterparts of
paddle_tpu/ops/distributed_ops.py. The reference runs these as C++
kernels calling the gRPC client; the JAX package runs each as an
ordered ``io_callback`` inside its one XLA step. Here each is a lowering
registered with ``host_sync``: the executor runs the step's ops in
program order, so each op reads its inputs on the host (a copy off the
card), drives the native TCP RPC client (distributed/rpc.py ->
native/ps_service.cc), and returns its outputs on the executor's
device. A plan that holds one runs eagerly at every run and is never
captured as a CUDA graph (core/executor.py). The flags the send and
barrier ops return are read by nothing: their ``dist`` role keeps them
through the pass pipeline's dead-op elimination.

Row ids travel as int64 on the wire although the device holds int32
(an int64 var runs as int32 on the device, range-checked at the feed).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.executor import to_numpy
from ..core.lowering import as_torch_dtype
from ..core.registry import register_op

_clients: Dict[Tuple[str, int], object] = {}


def _trainer_id() -> int:
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def client_for(endpoint: str):
    """Process-wide RPCClient pool (RPCClient::GetInstance analog,
    rpc_client.h:59)."""
    key = (endpoint, _trainer_id())
    c = _clients.get(key)
    if c is None:
        from ..distributed.rpc import RPCClient

        c = RPCClient(endpoint, trainer_id=_trainer_id())
        c.connect()
        _clients[key] = c
    return c


def reset_clients():
    for c in _clients.values():
        try:
            c.close()
        except Exception:
            pass
    _clients.clear()


def complete_and_reset():
    """SendComplete to every connected pserver, then drop the pool
    (Executor.close path — rpc_client.h:86 analog)."""
    for c in _clients.values():
        try:
            c.send_complete()
        except Exception:
            pass
    reset_clients()


def _grad_compress(wire_name: str):
    """The gradient-compression hook: only ``@GRAD``-named sends opt
    into the PADDLE_TPU_RPC_COMPRESS codec — params and barriers always
    travel verbatim (a bf16 init push would corrupt the weights the
    cycle is supposed to agree on)."""
    if "@GRAD" not in wire_name:
        return None
    from ..distributed.rpc import compress_mode

    return compress_mode()


def _flag(ctx) -> torch.Tensor:
    """The int32 scalar a send or barrier op returns, on the device."""
    return torch.zeros((), dtype=torch.int32, device=ctx.device)


@register_op("send", no_grad=True, host_sync=True)
def _send(ctx, ins, attrs):
    wire_name = attrs["var_name"]
    client_for(attrs["endpoint"]).send_var(
        wire_name, to_numpy(ins["X"][0]), compress=_grad_compress(wire_name))
    return {"Out": [_flag(ctx)]}


@register_op("send_sparse", no_grad=True, host_sync=True)
def _send_sparse(ctx, ins, attrs):
    """Sparse grad send: rows + values as SelectedRows
    (sendrecvop_utils.cc SelectedRows serde analog)."""
    from ..distributed.rpc import SelectedRows

    wire_name = attrs["var_name"]
    pad = attrs.get("padding_idx", -1)
    rows = to_numpy(ins["Rows"][0]).astype(np.int64)
    values = to_numpy(ins["Values"][0])
    if pad is not None and pad != -1:
        # padding rows never trained locally (forward used zeros):
        # zero their grad so the pad embedding doesn't drift
        values = np.where((rows == pad)[:, None], 0, values)
    client_for(attrs["endpoint"]).send_var(
        wire_name, SelectedRows(rows, values, height=int(attrs["height"])),
        compress=_grad_compress(wire_name))
    return {"Out": [_flag(ctx)]}


@register_op("send_barrier", no_grad=True, host_sync=True)
def _send_barrier(ctx, ins, attrs):
    for ep in attrs["endpoints"]:
        client_for(ep).send_barrier()
    return {"Out": [_flag(ctx)]}


@register_op("recv", no_grad=True, host_sync=True)
def _recv(ctx, ins, attrs):
    """The pserver's current value of ``var_name``, of the declared
    shape and dtype, on the device."""
    shape = tuple(int(s) for s in attrs["shape"])
    dtype = attrs.get("dtype", "float32")
    got = np.asarray(client_for(attrs["endpoint"]).get_var(
        attrs["var_name"]), dtype=np.dtype(dtype))
    if got.shape != shape:
        raise ValueError("recv(%s) from %s: got shape %s, the program "
                         "declares %s" % (attrs["var_name"],
                                          attrs["endpoint"], got.shape,
                                          shape))
    # np.ascontiguousarray makes a 0-d array 1-d: keep the declared shape
    out = torch.from_numpy(np.ascontiguousarray(got).reshape(shape))
    return {"Out": [out.to(device=ctx.device, dtype=as_torch_dtype(dtype))]}


@register_op("fetch_barrier", no_grad=True, host_sync=True)
def _fetch_barrier(ctx, ins, attrs):
    for ep in attrs["endpoints"]:
        client_for(ep).fetch_barrier()
    return {"Out": [_flag(ctx)]}


@register_op("prefetch", no_grad=True, host_sync=True)
def _prefetch(ctx, ins, attrs):
    """Remote sparse-table row fetch (prefetch_op.cc →
    parameter_prefetch.cc analog): Ids -> rows of the pserver-resident
    table. Gradient flows back via an explicit send_sparse op appended by
    the transpiler, not by autodiff (the table never lives on the trainer).
    Matches lookup_table's shape contract: a trailing ids dim of 1 is
    squeezed, and padding_idx rows come back as zeros."""
    width = int(attrs["width"])
    dtype = attrs.get("dtype", "float32")
    pad = attrs.get("padding_idx", -1)
    ids = ins["Ids"][0]
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    flat = to_numpy(ids).astype(np.int64).ravel()
    rows = np.asarray(client_for(attrs["endpoint"]).prefetch(
        attrs["table_name"], flat), dtype=np.dtype(dtype))
    out = torch.from_numpy(np.ascontiguousarray(rows)).to(
        device=ctx.device, dtype=as_torch_dtype(dtype))
    out = out.reshape(tuple(ids.shape) + (width,))
    if pad is not None and pad != -1:
        out = torch.where((ids != pad)[..., None], out,
                          torch.zeros_like(out))
    return {"Out": [out]}
