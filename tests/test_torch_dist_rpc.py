"""The port's parameter-server transport (distributed/rpc.py over its own
build of native/ps_service.cc) on localhost, in-process: the JAX
package's tests/test_dist_rpc.py cases on the port's server and client,
and the wire between the two packages, bitwise both ways, for every
dtype code, SelectedRows and bf16-compressed grads."""

import threading

import ml_dtypes
import numpy as np
import pytest

from paddle_tpu.distributed import rpc as jrpc
from paddle_tpu_torch.distributed import rpc as trpc
from paddle_tpu_torch.distributed.rpc import RPCClient, RPCServer, SelectedRows
from paddle_tpu_torch.native.dtypes import (BF16, CODE_OF_DTYPE, bf16_decode,
                                            bf16_encode)


def _ep(srv):
    return "127.0.0.1:%d" % srv.port


# ------------------------------------------- the JAX file's cases, ported
def test_send_get_barrier_cycle():
    srv = RPCServer(port=0, num_trainers=2, sync=True)
    srv.start()
    ep = _ep(srv)
    results = {}

    def trainer(tid):
        c = RPCClient(ep, trainer_id=tid)
        c.connect()
        c.send_var("w@GRAD", np.full((3, 2), float(tid + 1), np.float32))
        c.send_var("emb@GRAD",
                   SelectedRows(np.array([1, 3]),
                                np.full((2, 4), float(tid + 1), np.float32),
                                height=10))
        c.send_barrier()
        results[tid] = c.get_var("w")
        c.fetch_barrier()
        results[(tid, "pf")] = c.prefetch("emb", np.array([0, 5]))
        c.send_complete()
        c.close()

    ts = [threading.Thread(target=trainer, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()

    grads = srv.wait_grads()
    names = sorted(n for n, _, _ in grads)
    assert names == ["emb@GRAD", "emb@GRAD", "w@GRAD", "w@GRAD"]
    tids = sorted(t for n, _, t in grads if n == "w@GRAD")
    assert tids == [0, 1]

    dense = sum(v for n, v, _ in grads if n == "w@GRAD")
    srv.set_var("w", (dense / 2).astype(np.float32))
    srv.set_var("emb", np.arange(40, dtype=np.float32).reshape(10, 4))
    srv.serve()
    for t in ts:
        t.join(timeout=30)

    assert np.allclose(results[0], 1.5)
    assert np.allclose(results[1], 1.5)
    want = np.stack([np.arange(4), np.arange(20, 24)]).astype(np.float32)
    assert np.allclose(results[(0, "pf")], want)

    sp = [v for n, v, _ in grads if n == "emb@GRAD"][0]
    assert isinstance(sp, SelectedRows)
    assert list(sp.rows) == [1, 3]
    assert sp.height == 10 and sp.values.shape == (2, 4)
    assert srv.active_trainers == 0
    srv.close()


def test_dtype_roundtrip():
    srv = RPCServer(port=0, num_trainers=1, sync=False)
    srv.start()
    c = RPCClient(_ep(srv), trainer_id=0)
    c.connect()
    for arr in [np.arange(6, dtype=np.int64).reshape(2, 3),
                np.arange(5, dtype=np.float64),
                np.array([[1, 2]], dtype=np.int32),
                np.array(3.5, dtype=np.float32)]:
        srv.set_var("v", arr)
        got = c.get_var("v")
        assert got.dtype == arr.dtype and got.shape == arr.shape
        assert np.array_equal(got, arr)
    c.close()
    srv.close()


def test_async_queue_and_notify(tmp_path):
    srv = RPCServer(port=0, num_trainers=1, sync=False)
    srv.start()
    c = RPCClient(_ep(srv), trainer_id=0)
    c.connect()
    c.send_var("g", np.ones((2,), np.float32))
    item = srv.pop_async(timeout_ms=5000)
    assert item is not None and item[0] == "g"
    assert srv.pop_async(timeout_ms=50) is None
    c.checkpoint_notify(str(tmp_path))
    assert srv.poll_notify(timeout_ms=5000) == str(tmp_path)
    c.close()
    srv.close()


# ------------------------------------------------ the wire between packages
def _samples(rs):
    """One array per dtype code, as each package holds it: (port array,
    JAX array). bf16 is ml_dtypes' in the JAX package, BF16 bits in the
    port, the same 16 bits each."""
    out = []
    for dt in sorted(CODE_OF_DTYPE, key=CODE_OF_DTYPE.get):
        if dt == BF16:
            f = (rs.randn(3, 5) * 100).astype(np.float32)
            f[0, :3] = [np.nan, np.inf, -0.0]
            out.append((bf16_encode(f), f.astype(ml_dtypes.bfloat16)))
            continue
        if dt == np.dtype("bool"):
            a = rs.rand(4, 3) > 0.5
        elif dt.kind == "f":
            a = (rs.randn(2, 3, 4) * 1e3).astype(dt)
        else:
            info = np.iinfo(dt)
            a = rs.randint(max(info.min, -2 ** 31), min(info.max, 2 ** 31),
                           (7,)).astype(dt)
        out.append((a, a.copy()))
    out.append((np.array(2.25, np.float32), np.array(2.25, np.float32)))
    return out


def _bits(a):
    a = np.asarray(a)
    return a.shape, np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_every_dtype_code_crosses_bitwise(server_pkg):
    """A var the one package's server holds reads back bit for bit
    through the other package's client, for every dtype code; the two
    packages' tables give each dtype the same code."""
    assert {str(d) for d in jrpc._DTYPES} - {"bfloat16"} == \
        {str(d) for d in CODE_OF_DTYPE if d != BF16}
    for d, code in CODE_OF_DTYPE.items():
        want = np.dtype(ml_dtypes.bfloat16) if d == BF16 else d
        assert jrpc._DTYPES[want] == code
    Srv, Cli = ((jrpc.RPCServer, trpc.RPCClient) if server_pkg == "jax"
                else (trpc.RPCServer, jrpc.RPCClient))
    srv = Srv(port=0, num_trainers=1, sync=False)
    srv.start()
    c = Cli(_ep(srv), trainer_id=0)
    c.connect()
    for i, (port_a, jax_a) in enumerate(_samples(np.random.RandomState(3))):
        held, want = (jax_a, port_a) if server_pkg == "jax" else \
            (port_a, jax_a)
        srv.set_var("v%d" % i, held)
        got = c.get_var("v%d" % i)
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        assert _bits(got) == _bits(want)
    c.close()
    srv.close()


@pytest.mark.parametrize("sender", ["jax", "port"])
def test_sync_cycle_across_packages(sender):
    """A trainer of one package against the other's server: dense and
    SelectedRows grads, the barriers, a get and a prefetch, every value
    bitwise."""
    Srv, Cli = ((trpc.RPCServer, jrpc.RPCClient) if sender == "jax"
                else (jrpc.RPCServer, trpc.RPCClient))
    SR = jrpc.SelectedRows if sender == "jax" else trpc.SelectedRows
    rs = np.random.RandomState(7)
    g = rs.randn(5, 3).astype(np.float32)
    rows = np.array([4, 0, 4, 9])
    vals = rs.randn(4, 6).astype(np.float32)
    table = rs.randn(10, 6).astype(np.float32)
    w = rs.randn(5, 3).astype(np.float32)
    srv = Srv(port=0, num_trainers=1, sync=True)
    srv.start()
    out = {}

    def trainer():
        c = Cli(_ep(srv), trainer_id=0)
        c.connect()
        c.send_var("w@GRAD", g)
        c.send_var("t@GRAD", SR(rows, vals, height=10))
        c.send_barrier()
        out["w"] = c.get_var("w")
        c.fetch_barrier()
        out["pf"] = c.prefetch("t", np.array([9, 0, 9]))
        c.send_complete()
        c.close()

    th = threading.Thread(target=trainer)
    th.start()
    got = {n: v for n, v, _ in srv.wait_grads()}
    srv.set_var("w", w)
    srv.set_var("t", table)
    srv.serve()
    th.join(timeout=30)
    srv.close()
    assert _bits(got["w@GRAD"]) == _bits(g)
    sp = got["t@GRAD"]
    assert sp.height == 10 and sp.rows.dtype == np.int64
    assert list(sp.rows) == list(rows) and _bits(sp.values) == _bits(vals)
    assert _bits(out["w"]) == _bits(w)
    assert _bits(out["pf"]) == _bits(table[[9, 0, 9]])


@pytest.mark.parametrize("sender", ["jax", "port"])
def test_bf16_compressed_grads_cross_bitwise(sender, monkeypatch):
    """PADDLE_TPU_RPC_COMPRESS=bf16: a dense and a SelectedRows grad
    sent by either package arrive at the other's server decoded to the
    same float32 bits as ml_dtypes' round trip, and the compressed
    bytes counted equal."""
    monkeypatch.setenv("PADDLE_TPU_RPC_COMPRESS", "bf16")
    Srv, Cli, SR = ((trpc.RPCServer, jrpc.RPCClient, jrpc.SelectedRows)
                    if sender == "jax" else
                    (jrpc.RPCServer, trpc.RPCClient, trpc.SelectedRows))
    mode = (jrpc if sender == "jax" else trpc).compress_mode()
    assert mode == "bf16"
    rs = np.random.RandomState(11)
    dense = (rs.randn(64, 33) * 10).astype(np.float32)
    dense[0, :4] = [np.nan, -np.inf, 1.00390625, 1.01171875]  # ties
    vals = rs.randn(5, 8).astype(np.float32)
    srv = Srv(port=0, num_trainers=1, sync=False)
    srv.start()
    c = Cli(_ep(srv), trainer_id=0)
    c.connect()
    c.send_var("w@GRAD", dense, compress=mode)
    c.send_var("e@GRAD", SR(np.array([2, 7, 2, 0, 1]), vals, height=9),
               compress=mode)
    got = {}
    for _ in range(2):
        item = srv.pop_async(timeout_ms=5000)
        got[item[0]] = item[1]
    c.close()
    srv.close()
    rt = lambda a: a.astype(ml_dtypes.bfloat16).astype(np.float32)  # noqa
    assert got["w@GRAD"].dtype == np.float32
    assert _bits(got["w@GRAD"]) == _bits(rt(dense))
    assert _bits(got["e@GRAD"].values) == _bits(rt(vals))
    assert list(got["e@GRAD"].rows) == [2, 7, 2, 0, 1]
    # the codec alone: the port's bits are ml_dtypes', NaN and ties
    # included, and decode is exact
    bits = bf16_encode(dense).view(np.uint16)
    assert np.array_equal(bits, dense.astype(ml_dtypes.bfloat16)
                          .view(np.uint16))
    assert _bits(bf16_decode(bf16_encode(dense))) == _bits(rt(dense))
