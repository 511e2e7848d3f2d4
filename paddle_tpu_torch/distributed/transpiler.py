"""DistributeTranspiler: split one training program into trainer + pserver
programs.

Analog of /root/reference/python/paddle/fluid/transpiler/
distribute_transpiler.py:161 (transpile:280, get_trainer_program:554,
get_pserver_program:674, get_startup_program:927) with the reference's
param slicing (slice_var_up / min_block_size) and dispatchers
(ps_dispatcher.py:90 RoundRobin / HashName).

Mechanics here vs the reference:
* trainer side — the update (optimizer) ops are removed; split/send/
  send_barrier/recv/fetch_barrier/concat ops are appended. They lower to
  host-sync lowerings that run in program order inside the trainer's one
  step (see ops/distributed_ops.py): grads are read on the host and
  sent, fresh params come back onto the executor's device. Such a step
  runs eagerly at every run, never as a captured CUDA graph.
* pserver side — get_pserver_program returns a Program holding one
  `listen_and_serv` op (listen_and_serv_op.cc:325 analog). Running it with
  the ordinary Executor enters the PS loop (distributed/ps.py): the
  barrier-cycled native server collects grads, the optimize program — one
  plan of the executor covering every shard hosted on this server —
  applies them, updated params are published back to the transport.

The port's copy of paddle_tpu/distributed/transpiler.py.
* parameter init parity — trainer 0 pushes its initialized param blocks to
  the pservers during startup and every trainer then pulls them back, so
  all processes start from identical weights (the reference gets this from
  running startup on the pserver and broadcasting; push-from-trainer-0
  avoids replaying initializer RNG on a second process).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.program import Operator, Program, Variable, grad_var_name
from ..core.scope import global_scope

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig",
           "RoundRobin", "HashName"]

UPDATE_OP_TYPES = {
    "sgd", "momentum", "lars_momentum", "adagrad", "adam", "adamax",
    "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "lamb",
}


class DistributeTranspilerConfig:
    """Reference distribute_transpiler.py:130 analog."""

    def __init__(self):
        self.slice_var_up: bool = True
        self.min_block_size: int = 8192
        self.split_method = RoundRobin
        self.mode: str = "pserver"  # or "nccl2" / "collective"
        self.sync_mode: bool = True


class PSDispatcher:
    def __init__(self, eplist: Sequence[str]):
        self._eplist = list(eplist)

    def dispatch(self, varblocks) -> List[str]:
        raise NotImplementedError


class RoundRobin(PSDispatcher):
    """ps_dispatcher.py:90 analog."""

    def __init__(self, eplist):
        super().__init__(eplist)
        self._step = 0

    def dispatch(self, varblocks):
        out = []
        for _ in varblocks:
            out.append(self._eplist[self._step % len(self._eplist)])
            self._step += 1
        return out


class HashName(PSDispatcher):
    def dispatch(self, varblocks):
        out = []
        for vb in varblocks:
            h = int(hashlib.md5(vb.block_name.encode()).hexdigest(), 16)
            out.append(self._eplist[h % len(self._eplist)])
        return out


class VarBlock:
    """One shard (rows [offset, offset+rows)) of a sliced parameter."""

    def __init__(self, param_name: str, idx: int, offset: int, rows: int,
                 shape: Tuple[int, ...], n_blocks: int):
        self.param_name = param_name
        self.idx = idx
        self.offset = offset
        self.rows = rows
        self.n_blocks = n_blocks
        # full block shape: sliced along dim0
        self.shape = (rows,) + tuple(shape[1:])
        self.block_name = (param_name if n_blocks == 1
                           else "%s.block%d" % (param_name, idx))
        self.grad_name = grad_var_name(self.block_name)
        self.endpoint: Optional[str] = None


def slice_variable(name: str, shape: Sequence[int], slice_var_up: bool,
                   min_block_size: int, num_endpoints: int) -> List[VarBlock]:
    """Reference slice_var_up logic (distribute_transpiler.py slice_var_up /
    same-named helper): split along dim0 into at most num_endpoints blocks
    of at least min_block_size elements."""
    shape = tuple(int(s) for s in shape)
    numel = int(np.prod(shape)) if shape else 1
    dim0 = shape[0] if shape else 1
    n_blocks = 1
    if slice_var_up and num_endpoints > 1 and shape:
        n_blocks = min(num_endpoints, max(1, numel // max(min_block_size, 1)),
                       dim0)
        n_blocks = max(n_blocks, 1)
    base, rem = divmod(dim0, n_blocks)
    blocks = []
    off = 0
    for i in range(n_blocks):
        rows = base + (1 if i < rem else 0)
        blocks.append(VarBlock(name, i, off, rows, shape, n_blocks))
        off += rows
    return blocks


class DistributeTranspiler:
    """Reference distribute_transpiler.py:161 analog (pserver and
    collective/"nccl2" modes)."""

    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()

    # ---------------------------------------------------------- transpile
    def transpile(self, trainer_id: int, program: Optional[Program] = None,
                  pservers: str = "", trainers: int = 1,
                  sync_mode: bool = True, startup_program: Optional[Program] = None,
                  current_endpoint: str = ""):
        from ..core.program import default_main_program, default_startup_program

        self.trainer_id = trainer_id
        self.trainer_num = trainers
        self.sync_mode = sync_mode
        self.origin_program = program or default_main_program()
        self.startup_program = startup_program or default_startup_program()
        self.pserver_endpoints = [e for e in pservers.split(",") if e]
        self.current_endpoint = current_endpoint

        if self.config.mode in ("nccl2", "collective"):
            # collective data-parallel needs no program surgery: grad
            # all-reduce is emitted by the mesh engine (compiler.py); the
            # launcher env + init_parallel_env boot the global mesh
            # (gen_nccl_id_op.cc analog lives in parallel/env.py)
            self.trainer_program = self.origin_program
            self.rewrite_log = {
                "mode": self.config.mode, "trainers": trainers,
                "sync_mode": sync_mode, "endpoints": [],
                "split_method": self.config.split_method.__name__,
                "dispatch_order": [], "splits": [], "tables": [],
                "renames": {}, "removed_update_ops": [],
                "endpoint_map": {},
            }
            return

        assert self.pserver_endpoints, "pserver mode needs pserver endpoints"
        self._analyze()
        self._build_trainer_program()
        self.rewrite_log = self._build_rewrite_log()

    def _build_rewrite_log(self) -> dict:
        """The transpile's declared rewrites — the same contract the
        optimizer passes honor for per-pass translation validation
        (analysis/tv.py), lifted to the program SPLIT: which update ops
        vanished from the trainer program, how each parameter was sliced
        into endpoint-hosted blocks (offset/rows per shard), which
        names were renamed across the wire, and where every block and
        sparse table lives. analysis/distributed.py's cross-program
        verifier proves the transpiled programs equivalent to the
        origin *modulo exactly these declarations*."""
        splits = []
        renames: Dict[str, List[str]] = {}
        endpoint_map: Dict[str, str] = {}
        for pname, info in sorted(self.param_infos.items()):
            blocks = []
            for vb in info["blocks"]:
                blocks.append({
                    "name": vb.block_name, "grad": vb.grad_name,
                    "idx": vb.idx, "offset": vb.offset, "rows": vb.rows,
                    "shape": list(vb.shape), "endpoint": vb.endpoint,
                })
                endpoint_map[vb.block_name] = vb.endpoint
            splits.append({
                "param": pname, "grad": info["grad"],
                "shape": list(info["var"].shape or ()),
                "dtype": info["var"].dtype, "blocks": blocks,
            })
            renames[pname] = [vb.block_name for vb in info["blocks"]]
            renames[info["grad"]] = [vb.grad_name for vb in info["blocks"]]
        tables = []
        for wname, info in sorted(self.table_infos.items()):
            tables.append({
                "name": wname, "shape": list(info["var"].shape or ()),
                "dtype": info["var"].dtype, "endpoint": info["endpoint"],
                "grad": grad_var_name(wname),
            })
            endpoint_map[wname] = info["endpoint"]
        return {
            "mode": "pserver",
            "trainers": self.trainer_num,
            "sync_mode": self.sync_mode,
            "endpoints": list(self.pserver_endpoints),
            "split_method": self.config.split_method.__name__,
            # dispatch happens over blocks in update-op order, NOT the
            # name-sorted `splits` order — declare it so the verifier
            # can replay the dispatcher deterministically
            "dispatch_order": [vb.block_name for vb in self.all_blocks],
            "splits": splits,
            "tables": tables,
            "renames": renames,
            "removed_update_ops": [
                {"type": op.type, "param": op.input("Param")[0],
                 "grad": op.input("Grad")[0]}
                for op in self.update_ops],
            "endpoint_map": endpoint_map,
        }

    def get_rewrite_log(self) -> dict:
        """The declared rewrite log of the last :meth:`transpile` call
        (see :meth:`_build_rewrite_log`); raises if transpile has not
        run."""
        if not hasattr(self, "rewrite_log"):
            raise RuntimeError("transpile() has not run: no rewrite log")
        return self.rewrite_log

    # ------------------------------------------------------------ analyze
    def _analyze(self):
        block = self.origin_program.global_block()
        self.update_ops = []
        self.param_infos: Dict[str, dict] = {}

        # distributed sparse tables: lookup_table(is_distributed=True) keeps
        # its W on a pserver; the trainer prefetches rows and ships sparse
        # grads (reference distribute_lookup_table.py + parameter_prefetch)
        self.table_infos: Dict[str, dict] = {}
        for op in block.ops:
            if (op.type in ("lookup_table", "lookup_table_v2")
                    and op.attrs.get("is_distributed")):
                wname = op.input("W")[0]
                wvar = block.var(wname)
                self.table_infos[wname] = {"var": wvar, "op": op}

        for op in block.ops:
            if (op.attrs.get("__op_role__") == "optimize"
                    and op.type in UPDATE_OP_TYPES
                    and op.input("Param") and op.input("Grad")):
                self.update_ops.append(op)
                pname = op.input("Param")[0]
                if pname in self.table_infos:
                    if op.type != "sgd":
                        raise NotImplementedError(
                            "distributed sparse tables support sgd updates "
                            "(got %r for %s)" % (op.type, pname))
                    self.table_infos[pname]["update_op"] = op

        n_eps = len(self.pserver_endpoints)
        all_blocks: List[VarBlock] = []
        for op in self.update_ops:
            pname = op.input("Param")[0]
            if pname in self.table_infos:
                continue  # sparse path, not a dense sliced param
            gname = op.input("Grad")[0]
            pvar = block.var(pname)
            blocks = slice_variable(pname, pvar.shape, self.config.slice_var_up,
                                    self.config.min_block_size, n_eps)
            self.param_infos[pname] = {
                "op": op, "grad": gname, "var": pvar, "blocks": blocks,
            }
            all_blocks.extend(blocks)

        dispatcher = self.config.split_method(self.pserver_endpoints)
        for vb, ep in zip(all_blocks, dispatcher.dispatch(all_blocks)):
            vb.endpoint = ep
        self.all_blocks = all_blocks

        # tables are not sliced (whole-table rows served by one endpoint)
        for i, (wname, info) in enumerate(sorted(self.table_infos.items())):
            info["endpoint"] = self.pserver_endpoints[i % n_eps]

    # ----------------------------------------------- trainer-side programs
    def _append_sendrecv(self, prog: Program, per_param_src: Dict[str, str],
                         wire_of, recv_into_param: bool, barrier: bool):
        """Append split/send/barrier/recv/concat ops moving `per_param_src`
        vars out (sliced) and pulling param blocks back into the params."""
        blk = prog.global_block()
        eps = self.pserver_endpoints
        # sends
        for pname, info in self.param_infos.items():
            src = per_param_src[pname]
            blocks = info["blocks"]
            if len(blocks) == 1:
                names = [src]
            else:
                names = []
                for vb in blocks:
                    v = blk.create_var(name="%s@SPLIT.%d" % (src, vb.idx),
                                       shape=vb.shape, dtype=info["var"].dtype,
                                       stop_gradient=True)
                    names.append(v.name)
                blk.append_op("split", {"X": [src]}, {"Out": names},
                              {"axis": 0, "sections": [vb.rows for vb in blocks],
                               "__op_role__": "dist"})
            for vb, n in zip(blocks, names):
                dummy = blk.create_var(name="%s@SENT.%d" % (src, vb.idx),
                                       shape=(), dtype="int32", stop_gradient=True)
                blk.append_op("send", {"X": [n]}, {"Out": [dummy]},
                              {"endpoint": vb.endpoint,
                               "var_name": wire_of(vb),
                               "__op_role__": "dist"})
        if barrier:
            d = blk.create_var(name="@SEND_BARRIER@", shape=(), dtype="int32",
                               stop_gradient=True)
            blk.append_op("send_barrier", {}, {"Out": [d]},
                          {"endpoints": eps, "__op_role__": "dist"})
        # recvs
        for pname, info in self.param_infos.items():
            blocks = info["blocks"]
            if len(blocks) == 1 and recv_into_param:
                outs = [pname]
            else:
                outs = []
                for vb in blocks:
                    v = blk.create_var(name="%s@RECV.%d" % (pname, vb.idx),
                                       shape=vb.shape, dtype=info["var"].dtype,
                                       stop_gradient=True)
                    outs.append(v.name)
            for vb, n in zip(blocks, outs):
                blk.append_op("recv", {}, {"Out": [n]},
                              {"endpoint": vb.endpoint, "var_name": vb.block_name,
                               "shape": list(vb.shape),
                               "dtype": info["var"].dtype,
                               "__op_role__": "dist"})
            if len(blocks) > 1:
                blk.append_op("concat", {"X": outs}, {"Out": [pname]},
                              {"axis": 0, "__op_role__": "dist"})
        if barrier:
            d = blk.create_var(name="@FETCH_BARRIER@", shape=(), dtype="int32",
                               stop_gradient=True)
            blk.append_op("fetch_barrier", {}, {"Out": [d]},
                          {"endpoints": eps, "__op_role__": "dist"})

    def _build_trainer_program(self):
        prog = self.origin_program.clone()
        blk = prog.global_block()
        # drop the update ops — they now live on the pservers
        update_keys = {(op.type, tuple(op.input("Param"))) for op in self.update_ops}
        blk.ops = [op for op in blk.ops
                   if not (op.attrs.get("__op_role__") == "optimize"
                           and op.type in UPDATE_OP_TYPES
                           and (op.type, tuple(op.input("Param"))) in update_keys)]
        self._rewrite_sparse_tables(prog)
        self._append_sendrecv(
            prog,
            per_param_src={p: i["grad"] for p, i in self.param_infos.items()},
            wire_of=lambda vb: vb.grad_name,
            recv_into_param=True,
            barrier=self.sync_mode,
        )
        prog._bump()
        self.trainer_program = prog

    def _rewrite_sparse_tables(self, prog: Program):
        """Distributed-table surgery: lookup_table → prefetch (remote row
        fetch), lookup_table_grad → send_sparse of (ids, grad rows)
        (reference parameter_prefetch.cc + SelectedRows grad send)."""
        if not self.table_infos:
            return
        blk = prog.global_block()
        new_ops = []
        for op in blk.ops:
            if (op.type in ("lookup_table", "lookup_table_v2")
                    and op.input("W")
                    and op.input("W")[0] in self.table_infos):
                wname = op.input("W")[0]
                info = self.table_infos[wname]
                width = int(info["var"].shape[1])
                pref = Operator(blk, "prefetch",
                                {"Ids": [op.input("Ids")[0]]},
                                {"Out": [op.output("Out")[0]]},
                                {"endpoint": info["endpoint"],
                                 "table_name": wname, "width": width,
                                 "dtype": info["var"].dtype,
                                 "padding_idx": op.attrs.get("padding_idx", -1),
                                 "__op_role__": "dist"})
                new_ops.append(pref)
                continue
            if (op.type in ("lookup_table_grad", "lookup_table_v2_grad")
                    and op.input("W")
                    and op.input("W")[0] in self.table_infos):
                wname = op.input("W")[0]
                info = self.table_infos[wname]
                width = int(info["var"].shape[1])
                height = int(info["var"].shape[0])
                ids_name = op.input("Ids")[0]
                dout_name = op.input("Out@GRAD")[0]
                rows = blk.create_var(name="%s@ROWS" % wname, dtype="int64",
                                      stop_gradient=True)
                vals = blk.create_var(name="%s@VALROWS" % wname,
                                      dtype=info["var"].dtype,
                                      stop_gradient=True)
                dummy = blk.create_var(name="%s@SPARSE_SENT" % wname,
                                       shape=(), dtype="int32",
                                       stop_gradient=True)
                new_ops.append(Operator(
                    blk, "reshape", {"X": [ids_name]}, {"Out": [rows.name]},
                    {"shape": [-1], "__op_role__": "dist"}))
                new_ops.append(Operator(
                    blk, "reshape", {"X": [dout_name]}, {"Out": [vals.name]},
                    {"shape": [-1, width], "__op_role__": "dist"}))
                new_ops.append(Operator(
                    blk, "send_sparse",
                    {"Rows": [rows.name], "Values": [vals.name]},
                    {"Out": [dummy.name]},
                    {"endpoint": info["endpoint"],
                     "var_name": grad_var_name(wname), "height": height,
                     "padding_idx": op.attrs.get("padding_idx", -1),
                     "__op_role__": "dist"}))
                continue
            new_ops.append(op)
        blk.ops = new_ops

    def get_trainer_program(self) -> Program:
        return self.trainer_program

    def get_trainer_startup_program(self) -> Program:
        """Startup with init-parity exchange: trainer 0 pushes its param
        blocks; every trainer pulls them back (see module docstring)."""
        prog = self.startup_program.clone()
        if self.trainer_id == 0:
            # push initial sparse tables (whole-table send; the table then
            # lives only on its pserver)
            blk = prog.global_block()
            for wname, info in sorted(self.table_infos.items()):
                dummy = blk.create_var(name="%s@INIT_SENT" % wname, shape=(),
                                       dtype="int32", stop_gradient=True)
                blk.append_op("send", {"X": [wname]}, {"Out": [dummy.name]},
                              {"endpoint": info["endpoint"],
                               "var_name": wname, "__op_role__": "dist"})
            self._append_sendrecv(
                prog,
                per_param_src={p: p for p in self.param_infos},
                wire_of=lambda vb: vb.block_name,
                recv_into_param=True,
                barrier=self.sync_mode,
            )
        else:
            self._append_param_pull(prog.global_block(),
                                    create_params=False)
        prog._bump()
        return prog

    def _append_param_pull(self, blk, create_params: bool):
        """Barriered no-push param pull: send_barrier (an EMPTY grad
        cycle — the sync server only serves GETs after a cycle) →
        recv every param block (+concat) → fetch_barrier."""
        if self.sync_mode:
            d = blk.create_var(name="@SEND_BARRIER@", shape=(), dtype="int32",
                               stop_gradient=True)
            blk.append_op("send_barrier", {}, {"Out": [d]},
                          {"endpoints": self.pserver_endpoints,
                           "__op_role__": "dist"})
        for pname, info in self.param_infos.items():
            blocks = info["blocks"]
            if create_params:
                blk.create_var(name=pname, shape=info["var"].shape,
                               dtype=info["var"].dtype, persistable=True,
                               stop_gradient=True)
            outs = ([pname] if len(blocks) == 1 else
                    ["%s@RECV.%d" % (pname, vb.idx) for vb in blocks])
            for vb, n in zip(blocks, outs):
                if n != pname:
                    blk.create_var(name=n, shape=vb.shape,
                                   dtype=info["var"].dtype, stop_gradient=True)
                blk.append_op("recv", {}, {"Out": [n]},
                              {"endpoint": vb.endpoint,
                               "var_name": vb.block_name,
                               "shape": list(vb.shape),
                               "dtype": info["var"].dtype,
                               "__op_role__": "dist"})
            if len(blocks) > 1:
                blk.append_op("concat", {"X": outs}, {"Out": [pname]},
                              {"axis": 0, "__op_role__": "dist"})
        if self.sync_mode:
            d = blk.create_var(name="@FETCH_BARRIER@", shape=(), dtype="int32",
                               stop_gradient=True)
            blk.append_op("fetch_barrier", {}, {"Out": [d]},
                          {"endpoints": self.pserver_endpoints,
                           "__op_role__": "dist"})

    def get_trainer_push_program(self) -> Program:
        """Init-parity push WITHOUT initializers: push the params
        already sitting in this trainer's scope to the pservers and
        pull them back (one barrier cycle). Run by an elastic job's
        rank 0 after a checkpoint restore, paired with every other
        rank's :meth:`get_trainer_recovery_program` — a fresh pserver
        generation is seeded with the manifest's exact bytes instead
        of replayed initializer RNG. Sparse distributed tables are NOT
        pushed (they never live in trainer scope); a restarted pserver
        recovers them from its shard snapshot
        (PADDLE_TPU_PS_RECOVER_DIR)."""
        prog = Program()
        blk = prog.global_block()
        for pname, info in self.param_infos.items():
            blk.create_var(name=pname, shape=info["var"].shape,
                           dtype=info["var"].dtype, persistable=True,
                           stop_gradient=True)
        self._append_sendrecv(
            prog,
            per_param_src={p: p for p in self.param_infos},
            wire_of=lambda vb: vb.block_name,
            recv_into_param=True,
            barrier=self.sync_mode,
        )
        prog._bump()
        return prog

    def get_trainer_recovery_program(self) -> Program:
        """Crash-recovery pull: re-fetch every param block from the
        pservers into the local scope WITHOUT pushing local state —
        run after an RPCError when the failed step's donated buffers
        are gone and the (possibly restarted) pservers hold the
        authoritative params. In sync mode EVERY surviving trainer
        must run it together (the empty send-barrier cycle needs all
        active trainers). Reference analog: the trainer-restart fetch
        in the fault-tolerant PS flow (grpc_client.cc reconnect +
        recv)."""
        prog = Program()
        self._append_param_pull(prog.global_block(), create_params=True)
        prog._bump()
        return prog

    # ----------------------------------------------- pserver-side programs
    def _startup_init_attrs(self, var_name: str) -> Optional[dict]:
        """Find the startup init op writing `var_name` (fill_constant etc.)."""
        for op in self.startup_program.global_block().ops:
            if var_name in op.output_names():
                return {"type": op.type, "attrs": dict(op.attrs)}
        return None

    def _blocks_on(self, endpoint: str) -> List[VarBlock]:
        return [vb for vb in self.all_blocks if vb.endpoint == endpoint]

    def get_pserver_program(self, endpoint: str) -> Program:
        """A Program holding one listen_and_serv op
        (listen_and_serv_op.cc:325 analog); Executor.run() on it enters the
        PS loop. The optimize computation for every block hosted here is
        carried as a nested Program in the op attrs."""
        opt_prog = Program()
        blk = opt_prog.global_block()
        block_specs = []
        lr_done = set()
        for vb in self._blocks_on(endpoint):
            info = self.param_infos[vb.param_name]
            op = info["op"]
            pvar: Variable = info["var"]
            blk.create_var(name=vb.block_name, shape=vb.shape, dtype=pvar.dtype,
                           persistable=True, stop_gradient=True)
            blk.create_var(name=vb.grad_name, shape=vb.shape, dtype=pvar.dtype,
                           is_data=True, stop_gradient=True)
            rename = {info["grad"]: vb.grad_name, vb.param_name: vb.block_name}
            # optimizer state: slice param-shaped, replicate per block otherwise
            state_inits = []
            for slot, names in op.inputs.items():
                if slot in ("Param", "Grad", "LearningRate"):
                    continue
                for n in names:
                    svar = self.origin_program.global_block().var(n)
                    if tuple(svar.shape or ()) == tuple(pvar.shape or ()):
                        sshape = vb.shape
                    else:
                        sshape = tuple(svar.shape or (1,))
                    sname = (n if vb.n_blocks == 1
                             else "%s.block%d" % (n, vb.idx))
                    rename[n] = sname
                    blk.create_var(name=sname, shape=sshape, dtype=svar.dtype,
                                   persistable=True, stop_gradient=True)
                    init = self._startup_init_attrs(n)
                    value = (init or {}).get("attrs", {}).get("value", 0.0)
                    state_inits.append((sname, list(sshape), svar.dtype, value))
            # learning rate: shared persistable on this pserver
            lr_name = op.input("LearningRate")[0]
            if lr_name not in lr_done:
                lr_done.add(lr_name)
                lrvar = self.origin_program.global_block().var(lr_name)
                blk.create_var(name=lr_name, shape=lrvar.shape or (1,),
                               dtype=lrvar.dtype, persistable=True,
                               stop_gradient=True)
                init = self._startup_init_attrs(lr_name)
                value = (init or {}).get("attrs", {}).get("value", 0.0)
                state_inits.append((lr_name, list(lrvar.shape or (1,)),
                                    lrvar.dtype, value))
            new_in = {s: [rename.get(n, n) for n in ns]
                      for s, ns in op.inputs.items()}
            new_out = {s: [rename.get(n, n) for n in ns]
                       for s, ns in op.outputs.items()}
            blk.append_op(op.type, new_in, new_out, dict(op.attrs))
            block_specs.append({
                "param_block": vb.block_name,
                "grad_block": vb.grad_name,
                "shape": list(vb.shape),
                "dtype": pvar.dtype,
                "lr": lr_name,
                "opt_type": op.type,
                "state_inits": state_inits,
            })

        # sparse tables hosted here: no optimize ops (the runner applies
        # SelectedRows grads directly), just the var + lr metadata
        for wname, info in sorted(self.table_infos.items()):
            if info["endpoint"] != endpoint:
                continue
            wvar = info["var"]
            blk.create_var(name=wname, shape=wvar.shape, dtype=wvar.dtype,
                           persistable=True, stop_gradient=True)
            up = info.get("update_op")
            if up is None:
                raise ValueError(
                    "distributed table %r has no sgd update op in the "
                    "program — minimize() must run before transpile()"
                    % wname)
            lr_name = up.input("LearningRate")[0]
            state_inits = []
            if lr_name not in lr_done:
                lr_done.add(lr_name)
                init = self._startup_init_attrs(lr_name)
                value = (init or {}).get("attrs", {}).get("value", 0.0)
                state_inits.append((lr_name, [1], "float32", value))
            block_specs.append({
                "param_block": wname,
                "grad_block": grad_var_name(wname),
                "shape": list(wvar.shape),
                "dtype": wvar.dtype,
                "lr": lr_name,
                "opt_type": "sgd",
                "sparse": True,
                "state_inits": state_inits,
            })

        prog = Program()
        prog.global_block().append_op(
            "listen_and_serv", {}, {},
            {
                "endpoint": endpoint,
                "sync_mode": self.sync_mode,
                "Fanin": self.trainer_num,
                "optimize_program": opt_prog,
                "block_specs": block_specs,
                "__op_role__": "dist",
            })
        prog._is_distributed = True
        return prog

    def get_startup_program(self, endpoint: str,
                            pserver_program: Optional[Program] = None) -> Program:
        """Pserver startup: zero param blocks (real values arrive via the
        trainer-0 init push) and fill optimizer state / lr constants
        (reference get_startup_program:927)."""
        del pserver_program
        prog = Program()
        blk = prog.global_block()
        done = set()
        for vb in self._blocks_on(endpoint):
            info = self.param_infos[vb.param_name]
            blk.create_var(name=vb.block_name, shape=vb.shape,
                           dtype=info["var"].dtype, persistable=True,
                           stop_gradient=True)
            blk.append_op("fill_constant", {}, {"Out": [vb.block_name]},
                          {"shape": list(vb.shape), "value": 0.0,
                           "dtype": info["var"].dtype})
        for wname, info in sorted(self.table_infos.items()):
            if info["endpoint"] != endpoint:
                continue
            wvar = info["var"]
            blk.create_var(name=wname, shape=wvar.shape, dtype=wvar.dtype,
                           persistable=True, stop_gradient=True)
            blk.append_op("fill_constant", {}, {"Out": [wname]},
                          {"shape": list(wvar.shape), "value": 0.0,
                           "dtype": wvar.dtype})
        # state vars come from the block specs of get_pserver_program
        ps = self.get_pserver_program(endpoint)
        specs = ps.global_block().ops[0].attrs["block_specs"]
        for spec in specs:
            for sname, sshape, sdtype, value in spec["state_inits"]:
                if sname in done:
                    continue
                done.add(sname)
                blk.create_var(name=sname, shape=tuple(sshape), dtype=sdtype,
                               persistable=True, stop_gradient=True)
                blk.append_op("fill_constant", {}, {"Out": [sname]},
                              {"shape": list(sshape), "value": float(value),
                               "dtype": sdtype})
        return prog
