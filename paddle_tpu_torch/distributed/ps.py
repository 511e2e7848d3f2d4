"""Parameter-server runtime: the listen_and_serv loop.

Analog of /root/reference/paddle/fluid/operators/distributed_ops/
listen_and_serv_op.cc — RunSyncLoop (:107), RunAsyncLoop (:223),
ParallelExecuteBlocks (:60) — and the request handlers in
operators/distributed/request_handler_impl.cc (:37 Send, :83 Get,
:189 Checkpoint).

Shape here: the native transport (ps_service.cc) owns sockets, barriers
and the var store; this loop owns semantics — drain a barrier cycle, sum
the per-trainer grads, run the optimize Program (one plan of the
executor for every shard hosted on this server: on the card, level 2
fuses its same-hyperparameter updates into one grouped-update kernel
launch, replayed as a CUDA graph from the second round on), publish
updated params. Sparse (SelectedRows) grads take the scatter-apply path
on the host. Async mode applies each grad the moment it arrives
(Hogwild analog) with per-block programs.

The port's copy of paddle_tpu/distributed/ps.py. Its scope holds
tensors on the executor's device (the card unless the caller passes an
``Executor(CPUPlace())``): every read of a scope value goes through the
executor's ``to_numpy`` (a copy on the host), every write through its
``feed_to_device`` (a tensor on its device, int64 narrowed to int32 with
the feed's range check).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from ..core.executor import feed_to_device, to_numpy
from ..core.program import Program
from ..core.scope import Scope
from .rpc import RPCServer, SelectedRows, parse_endpoint

__all__ = ["run_pserver_loop", "register_prebound_server"]

# endpoint -> RPCServer bound ahead of run_pserver_loop: a launcher can
# bind port 0 ITSELF (kernel-assigned, held from bind to serve — no
# bind/close/rebind TOCTOU) and advertise the real port to the cluster
# before entering the loop. See bench.py's --dist-ctr-pserver entry.
_PREBOUND: Dict[str, RPCServer] = {}


def register_prebound_server(endpoint: str, server: RPCServer) -> None:
    _PREBOUND[endpoint] = server


def _sparse_apply(table: np.ndarray, grads: List[SelectedRows], lr: float,
                  scale: float) -> np.ndarray:
    """Scatter SGD on a sparse table (selected_rows_functor.cc analog;
    np.add.at merges duplicate rows, touching only the selected rows)."""
    out = np.array(table, copy=True)
    for g in grads:
        if len(g.rows) == 0:
            continue
        np.add.at(out, g.rows, (-lr * scale) * np.asarray(g.values))
    return out


def run_pserver_loop(attrs: Dict, scope: Scope, executor=None):
    """Entered by Executor.run() on a program holding a listen_and_serv op
    (the reference enters ListenAndServOp::RunImpl:325 the same way)."""
    from ..core.executor import Executor

    endpoint = attrs["endpoint"]
    sync = bool(attrs.get("sync_mode", True))
    num_trainers = int(attrs.get("Fanin", 1))
    opt_prog: Program = attrs["optimize_program"]
    specs: List[dict] = attrs["block_specs"]

    # PADDLE_TPU_VALIDATE=1: prove the declared block specs internally
    # consistent (every spec backed by an optimize-program var of the
    # declared shape/dtype) BEFORE binding the port — a hand-built or
    # corrupted server program fails here instead of serving junk
    from ..analysis.infer import validation_enabled

    if validation_enabled():
        from ..analysis.distributed import pserver_spec_findings
        from ..analysis.infer import ProgramVerifyError

        probe = Program()
        probe.global_block().append_op("listen_and_serv", {}, {},
                                       dict(attrs))
        findings = pserver_spec_findings(endpoint, probe)
        if any(f.severity == "error" for f in findings):
            raise ProgramVerifyError(findings)

    exe = executor or Executor()
    server = _PREBOUND.pop(endpoint, None)
    if server is None:
        _, port = parse_endpoint(endpoint)
        server = RPCServer(port=port, num_trainers=num_trainers, sync=sync)
    elif server.num_trainers != num_trainers or server.sync != sync:
        raise ValueError(
            "prebound server for %s was created with num_trainers=%d "
            "sync=%s but the pserver program wants num_trainers=%d "
            "sync=%s" % (endpoint, server.num_trainers, server.sync,
                         num_trainers, sync))

    param_blocks = {s["param_block"]: s for s in specs}
    grad_to_param = {s["grad_block"]: s["param_block"] for s in specs}
    n_dense = sum(1 for s in specs if not s.get("sparse"))

    # crash recovery: a restarted pserver reloads its shard snapshot
    # (written by a prior checkpoint-notify) before serving, so
    # trainers that survived the crash resume from the checkpointed
    # state instead of re-initialized params (reference: the
    # load-persistables-on-pserver restart path,
    # lookup_table_utils.load_persistables_for_increment analog)
    recover = (os.environ.get("PADDLE_TPU_PS_RECOVER_DIR")
               or attrs.get("recover_dir"))
    if recover:
        shard = os.path.join(recover, endpoint.replace(":", "_"),
                             "shard.npz")
        if os.path.exists(shard):
            with np.load(shard) as data:
                for n in data.files:
                    scope.set_var(n, feed_to_device(n, data[n], None,
                                                    exe.device))

    # publish startup state (zeros until the trainer-0 init push lands)
    for name in param_blocks:
        v = scope.find_var(name)
        if v is not None:
            server.set_var(name, to_numpy(v))
    server.start()

    def publish(names):
        for n in names:
            v = scope.find_var(n)
            if v is not None:
                server.set_var(n, to_numpy(v))

    def handle_notify():
        d = server.poll_notify(0)
        if d:
            _save_shards(d, endpoint, scope, param_blocks, specs)

    subset_cache: Dict[frozenset, Program] = {}
    if sync:
        while server.active_trainers > 0:
            received = server.wait_grads()
            if not received and server.active_trainers <= 0:
                break
            dense: Dict[str, List] = defaultdict(list)
            sparse: Dict[str, List] = defaultdict(list)
            for name, val, tid in received:
                if name in param_blocks:
                    # init push: direct assignment (RequestSendHandler's
                    # non-grad var branch)
                    scope.set_var(name, feed_to_device(name, val, None,
                                                       exe.device))
                elif isinstance(val, SelectedRows):
                    sparse[name].append((tid, val))
                else:
                    dense[name].append((tid, val))
            # aggregate in TRAINER-ID order, not arrival order: float
            # reduction is order-sensitive, and the elastic tier's
            # bitwise reshard contract (docs/RESILIENCE.md) needs two
            # runs of the same world to sum the same way every cycle
            if dense:
                feed = {}
                for g, tagged in dense.items():
                    vs = [v for _t, v in sorted(tagged,
                                                key=lambda p: p[0])]
                    feed[g] = np.mean(vs, axis=0, dtype=vs[0].dtype)
                if len(feed) < n_dense:
                    # memoize per feed-set: a fresh clone per cycle would
                    # miss the Executor compile cache (keyed by program id)
                    key = frozenset(feed)
                    run_prog = subset_cache.get(key)
                    if run_prog is None:
                        run_prog = _subset_program(opt_prog, set(feed))
                        subset_cache[key] = run_prog
                else:
                    run_prog = opt_prog
                exe.run(run_prog, feed=feed, fetch_list=[], scope=scope)
            for gname, tagged in sparse.items():
                pname = grad_to_param.get(gname)
                if pname is None:
                    continue
                gs = [v for _t, v in sorted(tagged, key=lambda p: p[0])]
                spec = param_blocks[pname]
                lr = float(to_numpy(scope.find_var(spec["lr"]))[0])
                table = to_numpy(scope.find_var(pname))
                scope.set_var(pname, feed_to_device(
                    pname, _sparse_apply(table, gs, lr, 1.0 / num_trainers),
                    None, exe.device))
            publish(param_blocks)
            server.serve()
            handle_notify()
    else:
        per_block = {}
        while server.active_trainers > 0:
            item = server.pop_async(timeout_ms=200)
            handle_notify()
            if item is None:
                continue
            name, val, _tid = item
            if name in param_blocks:
                scope.set_var(name, feed_to_device(name, val, None,
                                                   exe.device))
                publish([name])
                continue
            pname = grad_to_param.get(name)
            if pname is None:
                continue
            spec = param_blocks[pname]
            if isinstance(val, SelectedRows):
                lr = float(to_numpy(scope.find_var(spec["lr"]))[0])
                table = to_numpy(scope.find_var(pname))
                scope.set_var(pname, feed_to_device(
                    pname, _sparse_apply(table, [val], lr, 1.0), None,
                    exe.device))
            else:
                prog = per_block.get(name)
                if prog is None:
                    prog = _subset_program(opt_prog, {name})
                    per_block[name] = prog
                exe.run(prog, feed={name: val}, fetch_list=[], scope=scope)
            publish([pname])
    server.stop()
    server.close()


def _subset_program(opt_prog: Program, grad_names) -> Program:
    """Slice the optimize program down to the update ops fed this round."""
    p = opt_prog.clone()
    blk = p.global_block()
    blk.ops = [op for op in blk.ops
               if op.input("Grad") and op.input("Grad")[0] in grad_names]
    p._bump()
    return p


def _save_shards(dirname: str, endpoint: str, scope: Scope, param_blocks,
                 specs):
    """Checkpoint-on-notify (request_handler_impl.cc:189 analog): snapshot
    this server's shards under dirname/<endpoint>."""
    sub = os.path.join(dirname, endpoint.replace(":", "_"))
    os.makedirs(sub, exist_ok=True)
    arrays = {}
    for s in specs:
        for n in [s["param_block"], s["lr"]] + [si[0] for si in s["state_inits"]]:
            v = scope.find_var(n)
            if v is not None:
                arrays[n] = to_numpy(v)
    # atomic: a crash mid-write (the exact moment recovery exists for)
    # must never leave a torn shard.npz for the restarted pserver
    final = os.path.join(sub, "shard.npz")
    # tmp MUST end in .npz: np.savez silently appends the suffix
    tmp = os.path.join(sub, "shard.tmp.%d.npz" % os.getpid())
    np.savez(tmp, **arrays)
    os.replace(tmp, final)
