"""RPCClient / RPCServer: ctypes wrappers over the native PS transport.

Analog of the reference's transport-agnostic RPC API
(/root/reference/paddle/fluid/operators/distributed/rpc_client.h:32 —
AsyncSendVar/AsyncGetVar/AsyncPrefetchVar/barriers/Complete — and
rpc_server.h). The wire transport is the port's own copy of the native
C++ service, paddle_tpu_torch/native/ps_service.cc (gRPC/BRPC stack
analog), built into paddle_tpu_torch/_build/ at first use; vars cross as
numpy arrays, sparse grads as (rows, values) pairs (SelectedRows analog,
selected_rows.h:32). The wire bytes are the JAX package's: the same
frames, dtype codes and bf16 codec, whose bfloat16 payloads travel as
``native.dtypes.BF16`` bits (numpy has no bfloat16 of its own).
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..native import load
from ..native.dtypes import CODE_OF_DTYPE as _DTYPES
from ..native.dtypes import DTYPE_OF_CODE as _NP_OF_CODE
from ..native.dtypes import bf16_decode, bf16_encode
from ..resilience.backoff import backoff_delay, millis_env
from ..resilience.faults import fault_point
from ..observe import trace as _tr
from ..observe.families import (RPC_BYTES_RECV, RPC_BYTES_SENT, RPC_CALLS,
                                RPC_COMPRESS_BYTES_SAVED,
                                RPC_COMPRESSED_VARS,
                                RPC_DEADLINE_EXPIRATIONS, RPC_ERRORS,
                                RPC_RETRIES, RPC_SECONDS,
                                RPC_SERVER_REQUESTS)

# trace metadata rides RPC message name fields after this separator
# ("w@GRAD\x1ft=<trace_id>,s=<span_id>"): the server strips it before any
# name-keyed semantics (C store lookup for get_var; _batch_read for
# sends) and emits a server-side span event linked to the CALLING
# trainer's trace. 0x1f (ASCII unit separator) cannot appear in var
# names. Absent metadata = the exact pre-trace wire bytes, so mixed
# traced/untraced peers interoperate.
_TRACE_SEP = "\x1f"


def _wire_name(name: str) -> str:
    """Suffix ``name`` with the current trace context (no-op when
    tracing is off or no context is active)."""
    meta = _tr.wire_metadata()
    return name if meta is None else name + _TRACE_SEP + meta


def _split_wire(name: str):
    """``(clean_name, metadata_or_None)`` — inverse of ``_wire_name``."""
    sep = name.find(_TRACE_SEP)
    if sep < 0:
        return name, None
    return name[:sep], name[sep + 1:]


# wire-encoding marker for the gradient-compression hook: a compressed
# send_var's name carries "\x1ebf16" BEFORE any trace metadata. 0x1e
# (ASCII record separator) cannot appear in var names; the marker never
# reaches the C store-lookup path (compression applies only to
# trainer->server sends, whose names pass through the transport opaque
# and are decoded Python-side in ``_batch_read``). Absent marker = the
# exact pre-compression wire bytes, so mixed peers interoperate.
_ENC_SEP = "\x1e"
ENV_COMPRESS = "PADDLE_TPU_RPC_COMPRESS"

__all__ = ["RPCClient", "RPCServer", "RPCError", "PeerGoneError",
           "SelectedRows", "parse_endpoint", "compress_mode"]


def compress_mode() -> Optional[str]:
    """The active wire-compression codec for gradient sends, or None.
    ``PADDLE_TPU_RPC_COMPRESS=bf16`` enables fp32->bf16 encoding
    (decoded back to fp32 on receipt — relative error <= 2^-8, bounded
    by test); anything else (including the default, unset) is off."""
    import os as _os

    mode = _os.environ.get(ENV_COMPRESS, "").strip().lower()
    return mode if mode == "bf16" else None


def _encode_payload(name: str, value, mode: Optional[str]):
    """(wire_name, wire_value): bf16-encode an fp32 payload when the
    codec asks for it, marking the name so the receiver decodes."""
    if mode != "bf16":
        return name, value
    if isinstance(value, SelectedRows):
        if value.values.dtype != np.float32:
            return name, value
        enc = SelectedRows(value.rows, bf16_encode(value.values),
                           height=value.height)
        saved = value.values.nbytes - enc.values.nbytes
    else:
        arr = np.asarray(value)
        if arr.dtype != np.float32:
            return name, value
        enc = bf16_encode(arr)
        saved = arr.nbytes - enc.nbytes
    RPC_COMPRESSED_VARS.inc()
    RPC_COMPRESS_BYTES_SAVED.inc(saved)
    return name + _ENC_SEP + "bf16", enc


def _decode_payload(name: str, arr):
    """Inverse of ``_encode_payload``: strip the marker and cast the
    payload back to fp32 so consumers never see the wire dtype."""
    sep = name.find(_ENC_SEP)
    if sep < 0:
        return name, arr
    codec = name[sep + 1:]
    name = name[:sep]
    if codec == "bf16":
        if isinstance(arr, SelectedRows):
            arr = SelectedRows(arr.rows, bf16_decode(arr.values),
                               height=arr.height)
        else:
            arr = bf16_decode(arr)
    return name, arr


def _deadline_seconds() -> float:
    """PADDLE_TPU_RPC_DEADLINE_MS, parsed exactly like the native
    DeadlineMs(): junk or <=0 falls back to 60s."""
    import os as _os

    try:
        ms = int(_os.environ.get("PADDLE_TPU_RPC_DEADLINE_MS", "60000"))
    except ValueError:
        ms = 60000
    return (ms if ms > 0 else 60000) / 1000.0


def _retry_backoff_seconds() -> Tuple[float, float]:
    """(base, cap) for the get_var retry backoff, in seconds. Env-tuned:
    ``PADDLE_TPU_RPC_RETRY_BASE_MS`` (default 50) and
    ``PADDLE_TPU_RPC_RETRY_CAP_MS`` (default 1000) — full jitter doubles
    the envelope per attempt up to the cap, so a herd of trainers
    polling one recovering pserver decorrelates instead of stampeding
    on a fixed cadence (docs/RESILIENCE.md)."""
    return (millis_env("PADDLE_TPU_RPC_RETRY_BASE_MS", 50),
            millis_env("PADDLE_TPU_RPC_RETRY_CAP_MS", 1000))


class _rpc_call:
    """Per-method telemetry for one client call: call count on entry,
    latency histogram on exit, error counter when the call raises
    RPCError — plus the deadline-expiration counter when the failing
    call actually burned the reconnect deadline (a fast failure, e.g.
    get_var exhausting its retry COUNT against a live server, is an
    error but not an expiration — the distinction a wedged-tunnel
    post-mortem needs). Also opens the ``rpc.client`` trace span, whose
    context is what ``_wire_name`` serializes onto the wire — so the
    server-side event parents to THIS call, not just the trainer."""

    __slots__ = ("method", "_t0", "_sp")

    def __init__(self, method: str):
        self.method = method

    def __enter__(self):
        RPC_CALLS.labels(method=self.method).inc()
        self._sp = _tr.trace_span("rpc.client", method=self.method) \
            if _tr.trace_enabled() else None
        if self._sp is not None:
            self._sp.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        if self._sp is not None:
            self._sp.__exit__(exc_type, exc, tb)
            self._sp = None
        RPC_SECONDS.labels(method=self.method).observe(dt)
        if exc_type is not None and issubclass(exc_type, RPCError):
            RPC_ERRORS.labels(method=self.method).inc()
            if dt >= _deadline_seconds():
                RPC_DEADLINE_EXPIRATIONS.labels(method=self.method).inc()
        return False


def _payload_nbytes(value) -> int:
    if isinstance(value, SelectedRows):
        return int(value.values.nbytes + value.rows.nbytes)
    return int(np.asarray(value).nbytes)


class RPCError(RuntimeError):
    """A trainer→pserver RPC failed after the transport exhausted its
    reconnect deadline (PADDLE_TPU_RPC_DEADLINE_MS, default 60s — the
    FLAGS_rpc_deadline analog of the reference's grpc_client.cc). The
    pserver died, was partitioned, or never came up; the current
    barrier cycle's grads were NOT applied."""

    def __init__(self, op: str, endpoint: str, detail: str = ""):
        self.op, self.endpoint = op, endpoint
        msg = ("%s to pserver %s failed: peer unreachable after the RPC "
               "deadline (died / partitioned / never started)"
               % (op, endpoint))
        if detail:
            msg += " — " + detail
        super().__init__(msg)


class PeerGoneError(RPCError):
    """The endpoint VANISHED: after the native call failed, nothing is
    accepting TCP connections at the peer's address (checked with a
    direct bounded probe). Raised by ``get_var``/``send_var`` so a
    supervisor can tell a dead peer (tear the world down, reshard) from
    a transient failure against a live server (retry in place) — an
    init-race miss or a torn frame with the peer still listening stays
    a plain :class:`RPCError`."""


def _peer_alive(endpoint: str, timeout_s: float = 2.0) -> bool:
    """Is anything accepting TCP connections at ``endpoint``? The
    classification probe behind :class:`PeerGoneError` — independent of
    the native client's connection state (a dead fd inside the C client
    fails fast without ever re-probing the peer)."""
    import socket as _socket

    try:
        with _socket.create_connection(parse_endpoint(endpoint),
                                       timeout=max(timeout_s, 0.1)):
            return True
    except OSError:
        return False


def parse_endpoint(ep: str) -> Tuple[str, int]:
    host, port = ep.rsplit(":", 1)
    return host or "127.0.0.1", int(port)


class SelectedRows:
    """Sparse rows {row ids -> value rows} of a bigger tensor — the wire
    format for embedding gradients (reference selected_rows.h:32)."""

    def __init__(self, rows: np.ndarray, values: np.ndarray, height: int = -1):
        self.rows = np.ascontiguousarray(rows, dtype=np.int64)
        self.values = np.ascontiguousarray(values)
        self.height = height  # dim0 of the dense tensor this represents

    def __repr__(self):
        return "SelectedRows(%d rows of %s)" % (len(self.rows), self.values.shape)


def _lib():
    lib = load("ps_service")
    if getattr(lib, "_ps_typed", False):
        return lib
    c = ctypes
    lib.ps_server_create.restype = c.c_void_p
    lib.ps_server_create.argtypes = [c.c_int, c.c_int, c.c_int]
    for fn in ("ps_server_port", "ps_server_active"):
        getattr(lib, fn).restype = c.c_int
        getattr(lib, fn).argtypes = [c.c_void_p]
    for fn in ("ps_server_start", "ps_server_stop", "ps_server_destroy",
               "ps_server_serve"):
        getattr(lib, fn).restype = None
        getattr(lib, fn).argtypes = [c.c_void_p]
    lib.ps_server_set_var.restype = None
    lib.ps_server_set_var.argtypes = [c.c_void_p, c.c_char_p, c.c_int, c.c_int,
                                      c.POINTER(c.c_int64), c.c_void_p]
    lib.ps_server_var_meta.restype = c.c_int
    lib.ps_server_var_meta.argtypes = [c.c_void_p, c.c_char_p,
                                       c.POINTER(c.c_int), c.POINTER(c.c_int),
                                       c.POINTER(c.c_int64)]
    lib.ps_server_read_var.restype = c.c_int
    lib.ps_server_read_var.argtypes = [c.c_void_p, c.c_char_p, c.c_void_p,
                                       c.c_int64]
    lib.ps_server_wait_grads.restype = c.c_void_p
    lib.ps_server_wait_grads.argtypes = [c.c_void_p]
    lib.ps_server_pop_async.restype = c.c_void_p
    lib.ps_server_pop_async.argtypes = [c.c_void_p, c.c_int]
    lib.ps_server_poll_notify.restype = c.c_int
    lib.ps_server_poll_notify.argtypes = [c.c_void_p, c.c_char_p, c.c_int,
                                          c.c_int]
    lib.ps_server_pop_trace.restype = c.c_int
    lib.ps_server_pop_trace.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
    lib.ps_batch_count.restype = c.c_int
    lib.ps_batch_count.argtypes = [c.c_void_p]
    lib.ps_batch_name.restype = c.c_char_p
    lib.ps_batch_name.argtypes = [c.c_void_p, c.c_int]
    for fn in ("ps_batch_dtype", "ps_batch_ndim", "ps_batch_trainer"):
        getattr(lib, fn).restype = c.c_int
        getattr(lib, fn).argtypes = [c.c_void_p, c.c_int]
    lib.ps_batch_dims.restype = None
    lib.ps_batch_dims.argtypes = [c.c_void_p, c.c_int, c.POINTER(c.c_int64)]
    lib.ps_batch_nrows.restype = c.c_int64
    lib.ps_batch_nrows.argtypes = [c.c_void_p, c.c_int]
    lib.ps_batch_rows.restype = c.POINTER(c.c_int64)
    lib.ps_batch_rows.argtypes = [c.c_void_p, c.c_int]
    lib.ps_batch_data.restype = c.c_void_p
    lib.ps_batch_data.argtypes = [c.c_void_p, c.c_int]
    lib.ps_batch_nbytes.restype = c.c_int64
    lib.ps_batch_nbytes.argtypes = [c.c_void_p, c.c_int]
    lib.ps_batch_free.restype = None
    lib.ps_batch_free.argtypes = [c.c_void_p]
    lib.ps_client_create.restype = c.c_void_p
    lib.ps_client_create.argtypes = [c.c_char_p, c.c_int, c.c_int]
    lib.ps_client_destroy.restype = None
    lib.ps_client_destroy.argtypes = [c.c_void_p]
    lib.ps_client_connect.restype = c.c_int
    lib.ps_client_connect.argtypes = [c.c_void_p]
    lib.ps_client_send_var.restype = c.c_int
    lib.ps_client_send_var.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int, c.c_int, c.POINTER(c.c_int64),
        c.c_int64, c.POINTER(c.c_int64), c.c_void_p, c.c_int64]
    lib.ps_client_get_var.restype = c.c_void_p
    lib.ps_client_get_var.argtypes = [c.c_void_p, c.c_char_p]
    lib.ps_client_prefetch.restype = c.c_void_p
    lib.ps_client_prefetch.argtypes = [c.c_void_p, c.c_char_p,
                                       c.POINTER(c.c_int64), c.c_int64]
    for fn in ("ps_client_send_barrier", "ps_client_fetch_barrier",
               "ps_client_complete"):
        getattr(lib, fn).restype = c.c_int
        getattr(lib, fn).argtypes = [c.c_void_p]
    lib.ps_client_checkpoint.restype = c.c_int
    lib.ps_client_checkpoint.argtypes = [c.c_void_p, c.c_char_p]
    lib._ps_typed = True
    return lib


def _dims_ptr(shape):
    return (ctypes.c_int64 * max(len(shape), 1))(*shape)


def _contig(value) -> np.ndarray:
    """C-contiguous ndarray, PRESERVING 0-d shape (np.ascontiguousarray
    silently promotes 0-d to 1-d, hence the reshape)."""
    a = np.asarray(value)
    return a if a.flags["C_CONTIGUOUS"] else (
        np.ascontiguousarray(a).reshape(a.shape))


def _batch_read(lib, b, emit_site: Optional[str] = None
                ) -> List[Tuple[str, object, int]]:
    """Decode a native batch into [(name, ndarray | SelectedRows, trainer)].
    Names may carry wire trace metadata (``_wire_name``): it is ALWAYS
    stripped before the caller sees the name; when ``emit_site`` is given
    (server-side decode paths — wait_grads/pop_async) each carried
    context additionally emits a linked trace event, so the server span
    joins the calling trainer's trace."""
    out = []
    for i in range(lib.ps_batch_count(b)):
        name, meta = _split_wire(lib.ps_batch_name(b, i).decode())
        code = lib.ps_batch_dtype(b, i)
        ndim = lib.ps_batch_ndim(b, i)
        dims = (ctypes.c_int64 * max(ndim, 1))()
        if ndim:
            lib.ps_batch_dims(b, i, dims)
        shape = tuple(dims[j] for j in range(ndim))
        nbytes = lib.ps_batch_nbytes(b, i)
        raw = ctypes.string_at(lib.ps_batch_data(b, i), nbytes)
        flat = np.frombuffer(raw, dtype=_NP_OF_CODE[code])
        nrows = lib.ps_batch_nrows(b, i)
        if nrows >= 0:
            # sparse: dims carry the dense height, data only nrows rows
            if nrows > 0:
                rows = np.ctypeslib.as_array(lib.ps_batch_rows(b, i),
                                             (int(nrows),)).copy()
            else:
                rows = np.empty((0,), np.int64)
            height = shape[0] if ndim else -1
            arr = SelectedRows(rows, flat.reshape((nrows,) + shape[1:]).copy(),
                               height=height)
        else:
            arr = flat.reshape(shape).copy()
        trainer = lib.ps_batch_trainer(b, i)
        name, arr = _decode_payload(name, arr)
        if emit_site is not None and meta is not None:
            ctx = _tr.from_wire(meta)
            if ctx is not None:
                _tr.trace_event(emit_site, ctx=ctx, var=name,
                                trainer=trainer)
        out.append((name, arr, trainer))
    lib.ps_batch_free(b)
    return out


class RPCServer:
    """In-process parameter-server endpoint: var store + barrier-cycled grad
    exchange. The optimize step happens in the host runtime (ps.py), not in
    the transport — see ps_service.cc header."""

    def __init__(self, port: int = 0, num_trainers: int = 1, sync: bool = True):
        self._lib = _lib()
        self._h = self._lib.ps_server_create(port, num_trainers, int(sync))
        if not self._h:
            raise RuntimeError("could not bind PS server on port %d" % port)
        self.port = self._lib.ps_server_port(self._h)
        self.num_trainers = num_trainers
        self.sync = sync

    def start(self):
        self._lib.ps_server_start(self._h)

    def set_var(self, name: str, value: np.ndarray):
        RPC_SERVER_REQUESTS.labels(method="set_var").inc()
        value = _contig(value)
        code = _DTYPES[value.dtype]
        self._lib.ps_server_set_var(
            self._h, name.encode(), code, value.ndim, _dims_ptr(value.shape),
            value.ctypes.data_as(ctypes.c_void_p))

    def get_var(self, name: str) -> Optional[np.ndarray]:
        dt, nd = ctypes.c_int(), ctypes.c_int()
        dims = (ctypes.c_int64 * 8)()
        if not self._lib.ps_server_var_meta(self._h, name.encode(),
                                            ctypes.byref(dt), ctypes.byref(nd),
                                            dims):
            return None
        shape = tuple(dims[i] for i in range(nd.value))
        out = np.empty(shape, dtype=_NP_OF_CODE[dt.value])
        ok = self._lib.ps_server_read_var(
            self._h, name.encode(), out.ctypes.data_as(ctypes.c_void_p),
            out.nbytes)
        return out if ok else None

    def wait_grads(self) -> List[Tuple[str, object, int]]:
        """Block until every active trainer send-barriered; return the
        cycle's received vars (dense ndarray or SelectedRows). Wire
        trace metadata on the names is stripped here, each emitting a
        ``rpc.server.recv`` event linked to the sending trainer's
        trace."""
        RPC_SERVER_REQUESTS.labels(method="wait_grads").inc()
        b = self._lib.ps_server_wait_grads(self._h)
        out = _batch_read(self._lib, b, emit_site="rpc.server.recv")
        self.drain_trace_events()
        return out

    def serve(self):
        """Publish the store and open the GET window for this cycle."""
        RPC_SERVER_REQUESTS.labels(method="serve").inc()
        self._lib.ps_server_serve(self._h)
        self.drain_trace_events()

    def pop_async(self, timeout_ms: int = 100):
        b = self._lib.ps_server_pop_async(self._h, timeout_ms)
        self.drain_trace_events()
        if not b:
            return None
        return _batch_read(self._lib, b, emit_site="rpc.server.recv")[0]

    def drain_trace_events(self, limit: int = 256) -> int:
        """Drain the native get_var trace log, emitting one linked
        ``rpc.server.get_var`` event per logged request. Called
        opportunistically by wait_grads/serve/pop_async (cheap when
        empty: one C call returning 0); returns the number drained."""
        if not self._h or not _tr.trace_enabled():
            return 0
        buf = ctypes.create_string_buffer(512)
        n = 0
        while n < limit and \
                self._lib.ps_server_pop_trace(self._h, buf, 512):
            # count every POPPED entry (even a malformed/truncated one):
            # `limit` bounds consumption and the return value reports it
            n += 1
            parts = buf.value.decode(errors="replace").split(_TRACE_SEP)
            if len(parts) != 3:
                continue
            name, meta, trainer = parts
            ctx = _tr.from_wire(meta)
            if ctx is not None:
                try:
                    tid = int(trainer)
                except ValueError:
                    tid = -1
                _tr.trace_event("rpc.server.get_var", ctx=ctx, var=name,
                                trainer=tid)
        return n

    def poll_notify(self, timeout_ms: int = 0) -> Optional[str]:
        buf = ctypes.create_string_buffer(4096)
        if self._lib.ps_server_poll_notify(self._h, buf, 4096, timeout_ms):
            return buf.value.decode()
        return None

    @property
    def active_trainers(self) -> int:
        return self._lib.ps_server_active(self._h)

    def stop(self):
        if self._h:
            self._lib.ps_server_stop(self._h)

    def close(self):
        """Stop and free the native server. Idempotent: the handle is
        detached FIRST, so a double close (or a close racing another
        closer — supervisor teardown paths overlap) is a no-op instead
        of a second ``ps_server_destroy`` on a freed pointer."""
        h, self._h = self._h, None
        if h:
            self._lib.ps_server_stop(h)
            self._lib.ps_server_destroy(h)


class RPCClient:
    """Trainer-side connection to one pserver endpoint
    (rpc_client.h:32 analog; blocking calls — the reference's Async* +
    Wait pairs collapse to synchronous calls under the barrier cycle)."""

    def __init__(self, endpoint: str, trainer_id: int = 0):
        self._lib = _lib()
        host, port = parse_endpoint(endpoint)
        self.endpoint = endpoint
        self._h = self._lib.ps_client_create(host.encode(), port, trainer_id)

    def connect(self, required: bool = True) -> bool:
        with _rpc_call("connect"):
            ok = bool(self._lib.ps_client_connect(self._h))
            if required and not ok:
                raise RPCError("connect", self.endpoint)
            return ok

    def send_var(self, name: str, value,
                 compress: Optional[str] = None) -> None:
        """Push one var. ``compress`` ("bf16" or None) is the gradient-
        compression hook: callers opt grads in (ops/distributed_ops.py
        consults :func:`compress_mode` for ``@GRAD`` sends); params and
        non-fp32 payloads always travel verbatim."""
        with _rpc_call("send_var"):
            fault_point("rpc.send")
            wire, value = _encode_payload(name, value, compress)
            if isinstance(value, SelectedRows):
                rows, vals, height = value.rows, value.values, value.height
                dims = (height if height >= 0 else len(rows),) + vals.shape[1:]
                nrows = len(rows)
                rows_ptr = rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
            else:
                vals = _contig(value)
                dims, nrows, rows_ptr = vals.shape, -1, None
            vals = _contig(vals)
            ok = self._lib.ps_client_send_var(
                self._h, _wire_name(wire).encode(), _DTYPES[vals.dtype],
                len(dims), _dims_ptr(dims), nrows, rows_ptr,
                vals.ctypes.data_as(ctypes.c_void_p), vals.nbytes)
            if not ok:
                # dead-peer vs transient: probe the endpoint directly
                # (the native client's own fd state can't be trusted —
                # a dropped connection fails fast without re-probing)
                if not _peer_alive(self.endpoint):
                    raise PeerGoneError("send_var(%s)" % name,
                                        self.endpoint)
                raise RPCError("send_var(%s)" % name, self.endpoint,
                               "transport error against a reachable "
                               "peer (torn frame / mid-call drop)")
            RPC_BYTES_SENT.inc(_payload_nbytes(value))

    def get_var(self, name: str, retries: int = 50) -> np.ndarray:
        # retry: in async mode a GET can race the trainer-0 init push.
        # The loop is bounded by BOTH a count and the RPC deadline —
        # against a DEAD peer each native call already burns the full
        # reconnect deadline, and 50 of those would stack to minutes.
        # deadline parsed exactly like the native transport's, so the
        # two never disagree (_deadline_seconds). Sleeps are FULL-JITTER
        # exponential (PADDLE_TPU_RPC_RETRY_BASE_MS/_CAP_MS) and clamped
        # to the REMAINING deadline, checked BEFORE sleeping — a fixed
        # backoff used to burn the deadline's last slice asleep and then
        # report expiration without having retried
        deadline_s = _deadline_seconds()
        base_s, cap_s = _retry_backoff_seconds()
        with _rpc_call("get_var"):
            t0 = time.monotonic()
            wire = _wire_name(name).encode()
            for attempt in range(max(retries, 1)):
                if attempt:
                    RPC_RETRIES.labels(method="get_var").inc()
                b = self._lib.ps_client_get_var(self._h, wire)
                if b:
                    out = _batch_read(self._lib, b)[0][1]
                    RPC_BYTES_RECV.inc(_payload_nbytes(out))
                    return out
                if attempt + 1 >= max(retries, 1):
                    break  # count exhausted: no retry follows, so a
                    #        sleep here would be pure added latency
                remaining = deadline_s - (time.monotonic() - t0)
                if remaining <= 0:
                    break
                time.sleep(min(backoff_delay(attempt, base_s, cap_s),
                               remaining))
            if not _peer_alive(self.endpoint):
                # nothing is listening there: the endpoint is gone —
                # a live server answering misses (init race) stays a
                # plain RPCError below
                raise PeerGoneError("get_var(%s)" % name, self.endpoint)
            raise RPCError("get_var(%s)" % name, self.endpoint,
                           "or the variable was never pushed (init race)")

    def prefetch(self, table: str, ids: np.ndarray) -> np.ndarray:
        with _rpc_call("prefetch"):
            ids = np.ascontiguousarray(ids, dtype=np.int64).ravel()
            b = self._lib.ps_client_prefetch(
                self._h, table.encode(),
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(ids))
            if not b:
                raise RPCError("prefetch(%s)" % table, self.endpoint)
            out = _batch_read(self._lib, b)[0][1]
            RPC_BYTES_RECV.inc(_payload_nbytes(out))
            return out

    def send_barrier(self):
        # a failed barrier means the sync cycle is torn (this trainer's
        # grads were not applied) — silent continuation would train on
        # stale params, so it raises (reference: grpc_client.cc barrier
        # RPCs surface through FLAGS_rpc_deadline the same way)
        with _rpc_call("send_barrier"):
            if not self._lib.ps_client_send_barrier(self._h):
                raise RPCError("send_barrier", self.endpoint)

    def fetch_barrier(self):
        with _rpc_call("fetch_barrier"):
            if not self._lib.ps_client_fetch_barrier(self._h):
                raise RPCError("fetch_barrier", self.endpoint)

    def send_complete(self):
        with _rpc_call("send_complete"):
            self._lib.ps_client_complete(self._h)

    def checkpoint_notify(self, dirname: str):
        self._lib.ps_client_checkpoint(self._h, dirname.encode())

    def close(self):
        if self._h:
            self._lib.ps_client_destroy(self._h)
            self._h = None
