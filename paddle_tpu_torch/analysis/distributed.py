"""Distributed-program static verifier: cross-program wire/shard/deadlock
analysis with transpiler translation validation.

The sixth analysis engine. The other five (shapes, dataflow, ranges,
memory, cost) and the per-pass translation validator (tv.py) all stop at
a single ``Program``'s edge — but ``DistributeTranspiler`` splits one
training program into N trainer + M pserver programs with nothing
machine-checking the contract ACROSS the wire: a recv whose declared
shape skews from the hosted block, a shard silently dropped from its
endpoint, a barrier cycle the pserver waits on forever. This module
takes the transpiler's whole output (trainer program(s) + pserver
program(s) + the declared rewrite log) and statically proves the
distributed job well-formed before any process launches. Four rule
groups, each riding an existing substrate:

* **wire typing** — every ``send``/``send_sparse``/``recv``/``prefetch``
  op resolves to a registered endpoint-side var with matching
  shape/dtype through ``analysis.infer`` facts. bf16 gradient
  compression (``PADDLE_TPU_RPC_COMPRESS``, ``@GRAD`` wires only — the
  exact gate ops/distributed_ops.py applies) and SelectedRows row-slice
  semantics are modeled explicitly. Mismatches are errors carrying
  def-site provenance for BOTH sides of the wire (the trainer-side op in
  the Finding fields, the pserver-side listen_and_serv declaration in
  the message).
* **partition coverage proof** — the shards actually HOSTED across the
  pserver programs must tile each split parameter exactly (no gap, no
  overlap, dispatch matching the declared endpoint map), every
  pserver-side optimizer op pairs with exactly one shard and its grad,
  and a distributed lookup table's hosted rows cover the full vocab.
* **deadlock/ordering analysis** — send/recv/barrier ops are matched
  into a static communication graph over Dataflow positions: an
  unmatched barrier (sync pserver, no trainer ``send_barrier``), a recv
  ordered before the send cycle completes, or a ``Fanin`` that disagrees
  with the trainer count is an error — each is a job that hangs, not a
  job that crashes.
* **cross-program translation validation** — a tv.py-shaped proof that
  the trainer program preserves the origin program's reaching-definition
  facts modulo the transpiler's DECLARED rewrite log
  (``DistributeTranspiler.get_rewrite_log()``): update ops may vanish
  only if declared removed, table lookups may be replaced only by their
  declared prefetch/send_sparse images, every other op must survive
  in order reading the same definitions, every appended op must carry
  the ``dist`` role, and every split parameter must be written back by
  its pserver round-trip image (recv/concat).

The memory engine is extended per-role: :func:`pserver_memory_findings`
prices each pserver program's resident shard set (``MemoryAnalysis`` at
``site="dist"``) against ``PADDLE_TPU_DEVICE_HBM_BYTES``, and
:func:`shard_fit_report` answers the recommender-scale predicate
directly — "this table cannot fit on one device; a K-way split fits".

Entry points: :func:`validate_distributed` (the ``Program.validate``
analog for a whole job; raises :class:`ProgramVerifyError` on errors)
and the pserver loop's ``PADDLE_TPU_VALIDATE=1`` guard
(:func:`pserver_spec_findings`, distributed/ps.py).
``paddle_analysis_dist_*`` observe families count jobs, findings by
rule, and verify time. The port's copy of
paddle_tpu/analysis/distributed.py, over the port's pinned copies of
the dataflow, inference and memory engines.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.program import Program, grad_var_name
from .dataflow import Dataflow, Unfingerprintable, attrs_fingerprint
from .infer import (DIST_RULES, Finding, ProgramVerifyError, finding_for_op,
                    infer_program_shapes, normalize_shape, shapes_compatible)
from .memory import MemoryAnalysis, device_budget, dtype_bytes, format_bytes

__all__ = [
    "BARRIER_OPS",
    "DIST_RULES",
    "WIRE_OPS",
    "pserver_memory_findings",
    "pserver_spec_findings",
    "shard_fit_report",
    "validate_distributed",
    "validate_transpile",
]

# the trainer-side op vocabulary the verifier matches against pserver
# declarations. repo_lint rule 12 proves every type here exists in the
# op registry (listen_and_serv is deliberately absent from both: the
# Executor special-cases it as the PS-loop entry, it never lowers)
WIRE_OPS = ("send", "send_sparse", "recv", "prefetch")
BARRIER_OPS = ("send_barrier", "fetch_barrier")

# update-op vocabulary shared with the transpiler (import would be
# upward across the package seam; the transpiler's tuple is pinned
# against this one in tests/test_dist_verifier.py)
_UPDATE_OP_TYPES = {
    "sgd", "momentum", "lars_momentum", "adagrad", "adam", "adamax",
    "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "lamb",
}


def _compress_mode() -> Optional[str]:
    """The active gradient wire codec (distributed/rpc.py
    compress_mode): 'bf16' or None. Only ``@GRAD`` wire names opt in —
    the identical gate ops/distributed_ops.py applies at send time."""
    from ..distributed.rpc import compress_mode

    return compress_mode()


# ----------------------------------------------------------- endpoint side
class _EndpointTable:
    """One pserver program's declared surface: the listen_and_serv op,
    its block specs indexed by param-block and grad-block wire name,
    and the nested optimize program."""

    def __init__(self, endpoint: str, program: Program):
        self.endpoint = endpoint
        self.program = program
        ops0 = program.global_block().ops
        self.listen_op = (ops0[0] if ops0 and
                          ops0[0].type == "listen_and_serv" else None)
        attrs = self.listen_op.attrs if self.listen_op is not None else {}
        self.sync_mode = bool(attrs.get("sync_mode", False))
        self.fanin = int(attrs.get("Fanin", 0) or 0)
        self.opt_program: Optional[Program] = attrs.get("optimize_program")
        self.specs: List[dict] = list(attrs.get("block_specs") or ())
        self.params: Dict[str, dict] = {}
        self.grads: Dict[str, dict] = {}
        for spec in self.specs:
            self.params[spec["param_block"]] = spec
            self.grads[spec["grad_block"]] = spec

    def side(self) -> str:
        """Pserver-side provenance rendered into wire findings — the
        OTHER side of the wire the trainer-side op provenance anchors."""
        site = getattr(self.listen_op, "def_site", None)
        return "pserver %s (listen_and_serv%s)" % (
            self.endpoint, " declared at %s" % site if site else "")


def _endpoint_tables(transpiler, pserver_programs=None
                     ) -> Dict[str, _EndpointTable]:
    progs = pserver_programs or {
        ep: transpiler.get_pserver_program(ep)
        for ep in transpiler.pserver_endpoints}
    tables: Dict[str, _EndpointTable] = {}
    for ep, prog in progs.items():
        tables[ep] = _EndpointTable(ep, prog)
    return tables


def pserver_spec_findings(endpoint: str, program: Program) -> List[Finding]:
    """Internal consistency of ONE pserver program: a listen_and_serv
    head, every declared block spec backed by vars of the declared
    shape/dtype in the nested optimize program. distributed/ps.py runs
    this at PS-loop entry under PADDLE_TPU_VALIDATE=1, so a hand-built
    (or knocked-out) server program fails before it starts serving."""
    findings: List[Finding] = []
    et = _EndpointTable(endpoint, program)
    blk = program.global_block()
    if et.listen_op is None:
        findings.append(Finding(
            "dist-wire-unresolved", "error",
            "pserver program for %s has no listen_and_serv op at "
            "position 0 — the Executor cannot enter the PS loop"
            % endpoint))
        return findings
    if et.opt_program is None:
        findings.append(finding_for_op(
            "dist-opt-pairing", "error",
            "listen_and_serv carries no optimize_program", blk,
            et.listen_op))
        return findings
    oblk = et.opt_program.global_block()
    for spec in et.specs:
        # sparse tables host only the table var — the SelectedRows grad
        # is applied by the PS runner, never materialized as a program var
        keys = (("param_block",) if spec.get("sparse")
                else ("param_block", "grad_block"))
        for key in keys:
            name = spec[key]
            var = oblk.vars.get(name)
            if var is None:
                findings.append(finding_for_op(
                    "dist-opt-pairing", "error",
                    "block spec declares %s %r but the optimize program "
                    "has no such var (%s)" % (key, name, et.side()),
                    blk, et.listen_op, var=name))
                continue
            if not shapes_compatible(var.shape, spec.get("shape")):
                findings.append(finding_for_op(
                    "dist-wire-shape", "error",
                    "block spec %r declares shape %s but the optimize "
                    "program var has %s (%s)"
                    % (name, list(spec.get("shape") or ()),
                       list(var.shape or ()), et.side()),
                    blk, et.listen_op, var=name))
            if var.dtype != spec.get("dtype"):
                findings.append(finding_for_op(
                    "dist-wire-shape", "error",
                    "block spec %r declares dtype %s but the optimize "
                    "program var has %s (%s)"
                    % (name, spec.get("dtype"), var.dtype, et.side()),
                    blk, et.listen_op, var=name))
    return findings


# -------------------------------------------------------- 1. wire typing
def _wire_findings(tag: str, program: Program,
                   endpoints: Dict[str, _EndpointTable],
                   findings: List[Finding]) -> None:
    """Group 1: every wire op in ``program`` resolves endpoint-side with
    matching shape/dtype; compression and SelectedRows modeled."""
    blk = program.global_block()
    compress = _compress_mode()
    compressed_wires = 0
    anchor_op = None
    for op in blk.ops:
        if op.type not in WIRE_OPS:
            continue
        ep = op.attrs.get("endpoint")
        et = endpoints.get(ep)
        if et is None or et.listen_op is None:
            findings.append(finding_for_op(
                "dist-wire-unresolved", "error",
                "%s program: %s targets endpoint %r which no pserver "
                "program serves (declared endpoints: %s)"
                % (tag, op.type, ep, sorted(endpoints)), blk, op))
            continue
        if op.type == "send":
            wire = op.attrs.get("var_name")
            src = op.input("X")[0] if op.input("X") else None
            svar = blk.vars.get(src) if src else None
            spec = et.grads.get(wire) or et.params.get(wire)
            if spec is None:
                hosts = sorted(o.endpoint for o in endpoints.values()
                               if wire in o.grads or wire in o.params)
                findings.append(finding_for_op(
                    "dist-wire-unresolved", "error",
                    "%s program: send of %r resolves to no block spec on "
                    "%s%s" % (tag, wire, et.side(),
                              "; hosted on %s instead" % ", ".join(hosts)
                              if hosts else ""), blk, op, var=wire))
                continue
            if svar is not None:
                if not shapes_compatible(svar.shape, spec["shape"]):
                    findings.append(finding_for_op(
                        "dist-wire-shape", "error",
                        "%s program: send of %r ships shape %s but %s "
                        "declares %s" % (tag, wire, list(svar.shape or ()),
                                         et.side(), list(spec["shape"])),
                        blk, op, var=wire))
                if svar.dtype is not None and svar.dtype != spec["dtype"]:
                    findings.append(finding_for_op(
                        "dist-wire-shape", "error",
                        "%s program: send of %r ships dtype %s but %s "
                        "declares %s" % (tag, wire, svar.dtype, et.side(),
                                         spec["dtype"]), blk, op, var=wire))
            if compress and "@GRAD" in (wire or ""):
                compressed_wires += 1
                anchor_op = anchor_op or op
                wire_dtype = (svar.dtype if svar is not None
                              else spec["dtype"])
                if wire_dtype and not str(wire_dtype).startswith("float") \
                        and str(wire_dtype) != "bfloat16":
                    findings.append(finding_for_op(
                        "dist-wire-compress", "error",
                        "%s program: grad wire %r has dtype %s — the "
                        "bf16 codec (PADDLE_TPU_RPC_COMPRESS=%s) only "
                        "round-trips floating payloads; this send would "
                        "corrupt on %s"
                        % (tag, wire, wire_dtype, compress, et.side()),
                        blk, op, var=wire))
        elif op.type == "send_sparse":
            wire = op.attrs.get("var_name")
            spec = et.grads.get(wire)
            if spec is None or not spec.get("sparse"):
                hosts = sorted(o.endpoint for o in endpoints.values()
                               if (o.grads.get(wire) or {}).get("sparse"))
                findings.append(finding_for_op(
                    "dist-wire-unresolved", "error",
                    "%s program: send_sparse of %r matches no sparse "
                    "table spec on %s%s"
                    % (tag, wire, et.side(),
                       "; hosted on %s instead" % ", ".join(hosts)
                       if hosts else ""), blk, op, var=wire))
                continue
            height = int(op.attrs.get("height", -1))
            if height != int(spec["shape"][0]):
                findings.append(finding_for_op(
                    "dist-sparse-wire", "error",
                    "%s program: send_sparse of %r declares height %d "
                    "but %s hosts %d table rows — scattered row ids "
                    "would land out of range"
                    % (tag, wire, height, et.side(),
                       int(spec["shape"][0])), blk, op, var=wire))
            vals = op.input("Values")
            vvar = blk.vars.get(vals[0]) if vals else None
            if vvar is not None and vvar.shape is not None \
                    and len(vvar.shape) == 2 and int(vvar.shape[1]) >= 0 \
                    and int(vvar.shape[1]) != int(spec["shape"][1]):
                findings.append(finding_for_op(
                    "dist-sparse-wire", "error",
                    "%s program: send_sparse of %r ships %d-wide rows "
                    "but %s hosts width %d"
                    % (tag, wire, int(vvar.shape[1]), et.side(),
                       int(spec["shape"][1])), blk, op, var=wire))
        elif op.type == "recv":
            wire = op.attrs.get("var_name")
            spec = et.params.get(wire)
            if spec is None:
                hosts = sorted(o.endpoint for o in endpoints.values()
                               if wire in o.params)
                findings.append(finding_for_op(
                    "dist-wire-unresolved", "error",
                    "%s program: recv of %r resolves to no param block "
                    "on %s%s" % (tag, wire, et.side(),
                                 "; hosted on %s instead" % ", ".join(hosts)
                                 if hosts else ""), blk, op, var=wire))
                continue
            want = normalize_shape(op.attrs.get("shape"))
            if want is not None and tuple(want) != tuple(spec["shape"]):
                findings.append(finding_for_op(
                    "dist-wire-shape", "error",
                    "%s program: recv of %r expects shape %s but %s "
                    "publishes %s" % (tag, wire, list(want), et.side(),
                                      list(spec["shape"])), blk, op,
                    var=wire))
            want_dt = op.attrs.get("dtype")
            if want_dt and want_dt != spec["dtype"]:
                findings.append(finding_for_op(
                    "dist-wire-shape", "error",
                    "%s program: recv of %r expects dtype %s but %s "
                    "publishes %s" % (tag, wire, want_dt, et.side(),
                                      spec["dtype"]), blk, op, var=wire))
            out = op.output("Out")[0] if op.output("Out") else None
            ovar = blk.vars.get(out) if out else None
            if ovar is not None and not shapes_compatible(
                    ovar.shape, spec["shape"]):
                findings.append(finding_for_op(
                    "dist-wire-shape", "error",
                    "%s program: recv lands %r into shape %s but %s "
                    "publishes %s" % (tag, wire, list(ovar.shape or ()),
                                      et.side(), list(spec["shape"])),
                    blk, op, var=out))
        elif op.type == "prefetch":
            wname = op.attrs.get("table_name")
            spec = et.params.get(wname)
            if spec is None or not spec.get("sparse"):
                hosts = sorted(o.endpoint for o in endpoints.values()
                               if (o.params.get(wname) or {}).get("sparse"))
                findings.append(finding_for_op(
                    "dist-wire-unresolved", "error",
                    "%s program: prefetch of table %r matches no sparse "
                    "table spec on %s%s"
                    % (tag, wname, et.side(),
                       "; hosted on %s instead" % ", ".join(hosts)
                       if hosts else ""), blk, op, var=wname))
                continue
            width = int(op.attrs.get("width", -1))
            if width != int(spec["shape"][1]):
                findings.append(finding_for_op(
                    "dist-sparse-wire", "error",
                    "%s program: prefetch of %r expects %d-wide rows "
                    "but %s hosts width %d"
                    % (tag, wname, width, et.side(),
                       int(spec["shape"][1])), blk, op, var=wname))
            want_dt = op.attrs.get("dtype")
            if want_dt and want_dt != spec["dtype"]:
                findings.append(finding_for_op(
                    "dist-sparse-wire", "error",
                    "%s program: prefetch of %r expects dtype %s but %s "
                    "hosts %s" % (tag, wname, want_dt, et.side(),
                                  spec["dtype"]), blk, op, var=wname))
    if compressed_wires and anchor_op is not None:
        findings.append(finding_for_op(
            "dist-wire-compress", "info",
            "%s program: %d grad wire(s) travel bf16-compressed "
            "(PADDLE_TPU_RPC_COMPRESS=%s); params and barriers verbatim"
            % (tag, compressed_wires, compress), blk, anchor_op))


# ------------------------------------------------ 2. partition coverage
def _coverage_findings(rewrite_log: dict,
                       endpoints: Dict[str, _EndpointTable],
                       findings: List[Finding]) -> None:
    """Group 2: the HOSTED shards (ground truth: the pserver programs)
    tile each declared split exactly, land on their declared endpoints,
    and pair one-to-one with pserver optimizer ops; hosted tables cover
    the vocab."""
    # hosted dense/sparse specs by wire name -> (endpoint table, spec)
    hosted: Dict[str, List[Tuple[_EndpointTable, dict]]] = {}
    for et in endpoints.values():
        for name, spec in et.params.items():
            hosted.setdefault(name, []).append((et, spec))

    for split in rewrite_log.get("splits", ()):
        pname, dim0 = split["param"], int(split["shape"][0])
        declared = {b["name"]: b for b in split["blocks"]}
        covered = 0
        for bname, decl in sorted(declared.items(),
                                  key=lambda kv: declared[kv[0]]["idx"]):
            hits = hosted.get(bname, [])
            if not hits:
                findings.append(Finding(
                    "dist-shard-gap", "error",
                    "shard %r of %r (rows [%d, %d)) is hosted by NO "
                    "pserver program — the parameter cannot be "
                    "reassembled" % (bname, pname, decl["offset"],
                                     decl["offset"] + decl["rows"]),
                    var=bname))
                continue
            if len(hits) > 1:
                findings.append(Finding(
                    "dist-shard-overlap", "error",
                    "shard %r of %r is hosted by %d pservers (%s) — "
                    "each barrier cycle would apply the update %d times"
                    % (bname, pname, len(hits),
                       ", ".join(sorted(h[0].endpoint for h in hits)),
                       len(hits)), var=bname))
            et, spec = hits[0]
            rows = int(spec["shape"][0])
            covered += rows
            if rows != int(decl["rows"]):
                kind = ("dist-shard-overlap" if rows > int(decl["rows"])
                        else "dist-shard-gap")
                findings.append(Finding(
                    kind, "error",
                    "shard %r of %r hosts %d rows on %s but the rewrite "
                    "log declares %d (offset %d)"
                    % (bname, pname, rows, et.endpoint, decl["rows"],
                       decl["offset"]), var=bname))
            if et.endpoint != decl["endpoint"]:
                findings.append(Finding(
                    "dist-shard-assignment", "error",
                    "shard %r of %r is hosted on %s but the rewrite log "
                    "assigns it to %s" % (bname, pname, et.endpoint,
                                          decl["endpoint"]), var=bname))
        if covered < dim0:
            findings.append(Finding(
                "dist-shard-gap", "error",
                "shards of %r cover %d of %d rows — %d row(s) of the "
                "parameter have no hosting shard"
                % (pname, covered, dim0, dim0 - covered), var=pname))
        elif covered > dim0:
            findings.append(Finding(
                "dist-shard-overlap", "error",
                "shards of %r cover %d rows but the parameter has only "
                "%d — overlapping slices would double-apply updates"
                % (pname, covered, dim0), var=pname))
        # declared offsets must themselves tile [0, dim0) in idx order
        off = 0
        for decl in sorted(declared.values(), key=lambda d: d["idx"]):
            if int(decl["offset"]) != off:
                kind = ("dist-shard-overlap" if int(decl["offset"]) < off
                        else "dist-shard-gap")
                findings.append(Finding(
                    kind, "error",
                    "declared shard %r of %r starts at offset %d; the "
                    "previous shard ends at %d"
                    % (decl["name"], pname, decl["offset"], off),
                    var=decl["name"]))
            off = int(decl["offset"]) + int(decl["rows"])

    # round-robin dispatch: replay the dispatcher over the DECLARED
    # dispatch order and pin the endpoint map against it
    if rewrite_log.get("split_method") == "RoundRobin" \
            and rewrite_log.get("endpoints"):
        eps = rewrite_log["endpoints"]
        emap = rewrite_log.get("endpoint_map", {})
        for i, bname in enumerate(rewrite_log.get("dispatch_order", ())):
            expect = eps[i % len(eps)]
            if emap.get(bname, expect) != expect:
                findings.append(Finding(
                    "dist-shard-assignment", "error",
                    "declared RoundRobin dispatch is out of order: "
                    "shard %r (dispatch position %d) maps to %s, "
                    "round-robin over %s puts it on %s"
                    % (bname, i, emap[bname], eps, expect), var=bname))

    # optimizer pairing: in each optimize program, each non-sparse spec
    # pairs with exactly one update op reading its grad block and
    # writing its param block, of the declared type
    for et in endpoints.values():
        if et.opt_program is None:
            continue
        oblk = et.opt_program.global_block()
        opt_ops = [op for op in oblk.ops if op.type in _UPDATE_OP_TYPES]
        claimed = set()
        for spec in et.specs:
            if spec.get("sparse"):
                continue  # SelectedRows applies ride the PS runner
            mates = [op for op in opt_ops
                     if op.input("Param") == [spec["param_block"]]
                     and op.input("Grad") == [spec["grad_block"]]]
            if len(mates) != 1:
                findings.append(finding_for_op(
                    "dist-opt-pairing", "error",
                    "%s: block spec %r pairs with %d optimizer op(s) "
                    "(need exactly 1 reading grad %r)"
                    % (et.side(), spec["param_block"], len(mates),
                       spec["grad_block"]),
                    et.program.global_block(), et.listen_op,
                    var=spec["param_block"]))
                continue
            claimed.add(id(mates[0]))
            if mates[0].type != spec.get("opt_type"):
                findings.append(finding_for_op(
                    "dist-opt-pairing", "error",
                    "%s: block spec %r declares opt_type %r but the "
                    "paired op is %r" % (et.side(), spec["param_block"],
                                         spec.get("opt_type"),
                                         mates[0].type),
                    et.program.global_block(), et.listen_op,
                    var=spec["param_block"]))
        for op in opt_ops:
            if id(op) not in claimed:
                findings.append(finding_for_op(
                    "dist-opt-pairing", "error",
                    "%s: optimizer op updates %r which no block spec "
                    "declares — an unhosted shard would train silently"
                    % (et.side(), (op.input("Param") or ["?"])[0]),
                    oblk, op, var=(op.input("Param") or [""])[0]))

    # table coverage: every declared table hosted once, on its declared
    # endpoint, with the full vocab
    for tab in rewrite_log.get("tables", ()):
        hits = [(et, spec) for et, spec in hosted.get(tab["name"], [])
                if spec.get("sparse")]
        if not hits:
            findings.append(Finding(
                "dist-table-coverage", "error",
                "distributed table %r is hosted by no pserver program "
                "(declared on %s)" % (tab["name"], tab["endpoint"]),
                var=tab["name"]))
            continue
        if len(hits) > 1:
            findings.append(Finding(
                "dist-table-coverage", "error",
                "distributed table %r is hosted by %d pservers — rows "
                "would fork" % (tab["name"], len(hits)), var=tab["name"]))
        et, spec = hits[0]
        if et.endpoint != tab["endpoint"]:
            findings.append(Finding(
                "dist-shard-assignment", "error",
                "table %r is hosted on %s but declared on %s"
                % (tab["name"], et.endpoint, tab["endpoint"]),
                var=tab["name"]))
        if list(spec["shape"]) != list(tab["shape"]):
            findings.append(Finding(
                "dist-table-coverage", "error",
                "table %r hosts shape %s but the origin vocab is %s — "
                "the slice does not cover every row"
                % (tab["name"], list(spec["shape"]), list(tab["shape"])),
                var=tab["name"]))


# ------------------------------------------- 3. deadlock/ordering graph
def _ordering_findings(tag: str, program: Program,
                       rewrite_log: dict,
                       endpoints: Dict[str, _EndpointTable],
                       findings: List[Finding]) -> None:
    """Group 3: the program's wire ops form a static communication
    graph over Dataflow positions; unmatched barriers, recv-before-send
    cycles, and trainer-count-dependent waits are errors."""
    df = Dataflow(program)
    blk = program.global_block()
    sends, recvs = [], []
    send_barriers, fetch_barriers = [], []
    for pos, op in enumerate(df.ops):
        if op.type in ("send", "send_sparse"):
            sends.append((pos, op))
        elif op.type == "recv":
            recvs.append((pos, op))
        elif op.type == "send_barrier":
            send_barriers.append((pos, op))
        elif op.type == "fetch_barrier":
            fetch_barriers.append((pos, op))

    declared_eps = set(rewrite_log.get("endpoints") or endpoints)
    sync_eps = sorted(ep for ep, et in endpoints.items() if et.sync_mode)

    # fanin: a sync pserver waits for exactly Fanin barrier
    # participants; a wrong count is a wait that never resolves (or a
    # cycle that fires early with missing grads)
    trainers = int(rewrite_log.get("trainers", 0) or 0)
    for ep, et in endpoints.items():
        if et.listen_op is None:
            continue
        if trainers and et.fanin != trainers:
            findings.append(finding_for_op(
                "dist-fanin", "error",
                "%s waits for Fanin=%d trainers but the job declares %d "
                "— the barrier cycle %s"
                % (et.side(), et.fanin, trainers,
                   "never completes" if et.fanin > trainers
                   else "fires before every trainer reports"),
                et.program.global_block(), et.listen_op))
        if et.sync_mode != bool(rewrite_log.get("sync_mode", et.sync_mode)):
            findings.append(finding_for_op(
                "dist-barrier", "error",
                "%s runs sync_mode=%s but the job was transpiled with "
                "sync_mode=%s" % (et.side(), et.sync_mode,
                                  rewrite_log.get("sync_mode")),
                et.program.global_block(), et.listen_op))

    if sync_eps and (sends or recvs):
        if not send_barriers:
            findings.append(Finding(
                "dist-barrier", "error",
                "%s program sends to sync pserver(s) %s but contains no "
                "send_barrier — the server's barrier cycle never "
                "completes and every trainer recv deadlocks"
                % (tag, ", ".join(sync_eps))))
        if recvs and not fetch_barriers:
            findings.append(Finding(
                "dist-barrier", "error",
                "%s program recvs from sync pserver(s) %s but contains "
                "no fetch_barrier — the next cycle's sends can overtake "
                "unfinished GETs" % (tag, ", ".join(sync_eps))))
    for pos, op in send_barriers + fetch_barriers:
        eps = set(op.attrs.get("endpoints") or ())
        if eps != declared_eps:
            missing = sorted(declared_eps - eps)
            extra = sorted(eps - declared_eps)
            findings.append(finding_for_op(
                "dist-barrier", "error",
                "%s program: %s covers %s but the job declares %s%s%s"
                % (tag, op.type, sorted(eps), sorted(declared_eps),
                   " — pserver(s) %s wait forever" % ", ".join(missing)
                   if missing else "",
                   " — unknown endpoint(s) %s" % ", ".join(extra)
                   if extra else ""), blk, op))
    if not sync_eps and (send_barriers or fetch_barriers) and endpoints:
        for pos, op in send_barriers + fetch_barriers:
            findings.append(finding_for_op(
                "dist-barrier", "warning",
                "%s program carries a %s but every pserver runs async — "
                "the barrier blocks on an ack no sync cycle produces"
                % (tag, op.type), blk, op))

    # static ordering: sends -> send_barrier -> recvs -> fetch_barrier.
    # A recv ordered before the send cycle completes is the classic
    # recv-before-send deadlock under the barrier-cycled sync server
    if send_barriers:
        sb = min(pos for pos, _ in send_barriers)
        for pos, op in sends:
            if pos > sb:
                findings.append(finding_for_op(
                    "dist-ordering", "error",
                    "%s program: %s at position %d is ordered AFTER the "
                    "send_barrier (position %d) — its payload misses "
                    "the cycle the barrier closes" % (tag, op.type, pos,
                                                      sb), blk, op))
        for pos, op in recvs:
            if pos < sb:
                findings.append(finding_for_op(
                    "dist-ordering", "error",
                    "%s program: recv of %r at position %d is ordered "
                    "BEFORE the send_barrier (position %d) — the sync "
                    "server only serves GETs after the cycle completes: "
                    "recv-before-send deadlock"
                    % (tag, op.attrs.get("var_name"), pos, sb), blk, op))
    if fetch_barriers:
        fb = max(pos for pos, _ in fetch_barriers)
        for pos, op in recvs:
            if pos > fb:
                findings.append(finding_for_op(
                    "dist-ordering", "error",
                    "%s program: recv of %r at position %d is ordered "
                    "after the fetch_barrier (position %d) — it races "
                    "the next cycle's updates"
                    % (tag, op.attrs.get("var_name"), pos, fb), blk, op))


# ------------------------------- 4. cross-program translation validation
def _op_signature(op):
    try:
        fp = attrs_fingerprint({k: v for k, v in op.attrs.items()
                                if k != "__op_role__"})
    except Unfingerprintable:
        fp = None
    return (op.type, tuple(sorted((s, tuple(ns))
                                  for s, ns in op.inputs.items())),
            tuple(sorted((s, tuple(ns))
                         for s, ns in op.outputs.items())), fp)


def validate_transpile(transpiler,
                       trainer_program: Optional[Program] = None
                       ) -> List[Finding]:
    """Group 4: prove the trainer program equivalent to the origin
    program modulo the transpiler's declared rewrite log (tv.py's
    contract lifted across the program split). Checks: declared-only
    removals (update ops, rewritten table lookups), declared-only
    creations (``dist``-role wire ops and the declared prefetch/
    send_sparse images), order preservation, reaching-definition
    preservation for every surviving read, and the pserver round-trip
    image (every split parameter written back by a dist-role
    recv/concat). Returns ``dist-tv`` findings (empty = proven)."""
    findings: List[Finding] = []
    log = transpiler.get_rewrite_log()
    if log.get("mode") != "pserver":
        return findings  # collective mode: the program is untouched
    origin = transpiler.origin_program
    trainer = trainer_program or transpiler.get_trainer_program()
    oblk, tblk = origin.global_block(), trainer.global_block()
    removed = {(r["type"], r["param"]) for r in log["removed_update_ops"]}
    tables = {t["name"] for t in log.get("tables", ())}

    t_ops = tblk.ops
    t_sigs = [_op_signature(op) for op in t_ops]
    mapping: Dict[int, int] = {}  # origin pos -> trainer pos
    j = 0
    for i, op in enumerate(oblk.ops):
        if (op.attrs.get("__op_role__") == "optimize"
                and op.input("Param")
                and (op.type, op.input("Param")[0]) in removed):
            continue  # declared removal: lives on the pservers now
        is_table_fwd = (op.type in ("lookup_table", "lookup_table_v2")
                        and op.input("W")
                        and op.input("W")[0] in tables)
        is_table_bwd = (op.type in ("lookup_table_grad",
                                    "lookup_table_v2_grad")
                        and op.input("W")
                        and op.input("W")[0] in tables)
        found = None
        k = j
        while k < len(t_ops):
            cand = t_ops[k]
            if is_table_fwd:
                if (cand.type == "prefetch"
                        and cand.output("Out") == op.output("Out")):
                    found = k
                    break
            elif is_table_bwd:
                if (cand.type == "send_sparse"
                        and cand.attrs.get("var_name")
                        == grad_var_name(op.input("W")[0])):
                    found = k
                    break
            elif t_sigs[k] == _op_signature(op):
                found = k
                break
            if cand.attrs.get("__op_role__") != "dist":
                # a non-dist op standing where the image should be:
                # stop — crossing it would hide an undeclared reorder
                break
            k += 1
        if found is None:
            what = ("table lookup (declared prefetch image missing)"
                    if is_table_fwd else
                    "table grad (declared send_sparse image missing)"
                    if is_table_bwd else "op")
            findings.append(finding_for_op(
                "dist-tv", "error",
                "%s %s vanished from the trainer program without a "
                "rewrite-log record" % (op.type, what), oblk, op))
            continue
        mapping[i] = found
        j = found + 1
    for k, op in enumerate(t_ops):
        if k in mapping.values():
            continue
        if op.attrs.get("__op_role__") != "dist":
            findings.append(finding_for_op(
                "dist-tv", "error",
                "op appeared in the trainer program without a "
                "rewrite-log record (not dist-role)", tblk, op))

    # reaching-definition preservation over the matched pairs
    df_o = Dataflow(origin)
    df_t = Dataflow(trainer)
    image_of = {i: k for i, k in mapping.items()}
    removed_pos = {p for p, op in enumerate(oblk.ops)
                   if (op.attrs.get("__op_role__") == "optimize"
                       and op.input("Param")
                       and (op.type, op.input("Param")[0]) in removed)}
    for i, k in sorted(mapping.items()):
        op = oblk.ops[i]
        for name in set(n for ns in op.inputs.values() for n in ns if n):
            rd_o = df_o.reaching_def(name, i)
            rd_t = df_t.reaching_def(name, k)
            if rd_o is None:
                # external value before; a dist-role producer (e.g. a
                # prefetch image writing a renamed temp) cannot appear
                # for the SAME name without a declaration
                if rd_t is not None and \
                        rd_t.attrs.get("__op_role__") != "dist":
                    findings.append(finding_for_op(
                        "dist-tv", "error",
                        "read of %r observed the external value before "
                        "the transpile but now sees op %s"
                        % (name, rd_t.type), tblk, t_ops[k], var=name))
                continue
            p_o = df_o.pos_of(rd_o)
            if p_o in removed_pos:
                findings.append(finding_for_op(
                    "dist-tv", "error",
                    "read of %r reached the removed update op %s — the "
                    "transpiled trainer would observe a stale value"
                    % (name, rd_o.type), oblk, op, var=name))
                continue
            expect_k = image_of.get(p_o)
            actual_k = df_t.pos_of(rd_t) if rd_t is not None else None
            if expect_k is None:
                continue  # producer itself was image-rewritten (table)
            if actual_k != expect_k:
                findings.append(finding_for_op(
                    "dist-tv", "error",
                    "read of %r observes a different definition after "
                    "the transpile (expected the image of %s, sees %s)"
                    % (name, rd_o.type,
                       rd_t.type if rd_t is not None else "the external "
                       "value"), tblk, t_ops[k], var=name))

    # the pserver round-trip image: each split param's last write in the
    # trainer program must be a dist-role recv/concat (the optimizer's
    # declared replacement); a dropped pull means the trainer trains on
    # frozen weights silently
    for split in log.get("splits", ()):
        pname = split["param"]
        w = df_t.last_write_before(pname, len(t_ops))
        wop = None if w is None else df_t.ops[w]
        if wop is None or wop.attrs.get("__op_role__") != "dist" \
                or wop.type not in ("recv", "concat"):
            findings.append(Finding(
                "dist-tv", "error",
                "split parameter %r is never written back by its "
                "pserver round-trip image (recv/concat) — the removed "
                "%s update has no surviving equivalent"
                % (pname, split and log["removed_update_ops"] and
                   next((r["type"] for r in log["removed_update_ops"]
                         if r["param"] == pname), "?")), var=pname))
    return findings


# ----------------------------------------------- per-role memory proof
def shard_fit_report(shape: Sequence[int], dtype: str = "float32",
                     budget: Optional[int] = None) -> dict:
    """The recommender-scale predicate: can a tensor of ``shape`` live
    on one device, and if not, what is the minimum K-way row split that
    fits? ``budget`` defaults to ``PADDLE_TPU_DEVICE_HBM_BYTES``
    (analysis.memory.device_budget). Returns ``{"bytes", "budget",
    "fits_single", "min_ways"}`` — the two verdict fields are None
    without a configured budget (the provable-only contract every
    budget rule here shares), and ``min_ways`` is None when even a
    single row exceeds the budget."""
    shape = [int(s) for s in shape]
    total = dtype_bytes(dtype)
    for s in shape:
        total *= max(s, 1)
    budget = device_budget() if budget is None else budget
    report = {"bytes": int(total), "budget": budget,
              "fits_single": None, "min_ways": None}
    if not budget:
        return report
    report["fits_single"] = total <= budget
    if report["fits_single"]:
        report["min_ways"] = 1
        return report
    dim0 = shape[0] if shape else 1
    row_bytes = total // max(dim0, 1)
    rows_per_device = budget // max(row_bytes, 1)
    if rows_per_device >= 1:
        report["min_ways"] = int(math.ceil(dim0 / rows_per_device))
    return report


def pserver_memory_findings(endpoints: Dict[str, _EndpointTable],
                            rewrite_log: dict,
                            findings: List[Finding]) -> None:
    """Price each pserver program's RESIDENT shard set (param blocks +
    grads + optimizer state + hosted tables) with the memory engine and
    hold it against the device budget. Provable-only: silent without
    PADDLE_TPU_DEVICE_HBM_BYTES."""
    budget = device_budget()
    if not budget:
        return
    n_ways = max(len(rewrite_log.get("endpoints") or ()), 1)
    for ep in sorted(endpoints):
        et = endpoints[ep]
        if et.opt_program is None:
            continue
        ma = MemoryAnalysis(et.opt_program, site="dist")
        peak = ma.peak_bytes(1)
        if peak <= budget:
            findings.append(Finding(
                "dist-pserver-memory", "info",
                "pserver %s resident shard set fits: predicted peak %s "
                "within budget %s at %d-way split"
                % (ep, format_bytes(peak), format_bytes(budget), n_ways)))
            continue
        # name the biggest hosted table/block and quote the split that
        # WOULD fit — the "cannot fit single device, K-way fits" proof
        worst, detail = None, ""
        for spec in et.specs:
            rep = shard_fit_report(spec["shape"], spec["dtype"],
                                   budget=budget)
            if worst is None or rep["bytes"] > worst["bytes"]:
                worst, wname = rep, spec["param_block"]
        if worst is not None and not worst["fits_single"]:
            detail = ("; %r alone is %s — does not fit a single device"
                      % (wname, format_bytes(worst["bytes"])))
            if worst["min_ways"]:
                detail += (", fits at %d-way row split"
                           % worst["min_ways"])
        findings.append(finding_for_op(
            "dist-pserver-memory", "error",
            "pserver %s resident shard set: predicted peak %s exceeds "
            "the device budget %s (PADDLE_TPU_DEVICE_HBM_BYTES)%s"
            % (ep, format_bytes(peak), format_bytes(budget), detail),
            et.program.global_block(), et.listen_op))


# ------------------------------------------------------------ entry point
def validate_distributed(transpiler,
                         trainer_programs: Optional[Sequence[
                             Tuple[str, Program]]] = None,
                         pserver_programs: Optional[
                             Dict[str, Program]] = None,
                         raise_on_error: bool = True,
                         site: str = "api") -> List[Finding]:
    """Statically verify one transpiled distributed job before launch.

    ``transpiler`` is a :class:`DistributeTranspiler` after
    ``transpile()``; by default the trainer main + trainer startup
    programs and every endpoint's pserver program are derived from it
    (pass ``trainer_programs`` as ``[(tag, Program), ...]`` or
    ``pserver_programs`` as ``{endpoint: Program}`` to verify explicit
    artifacts instead — the knockout corpus does). Runs all four rule
    groups plus the per-role memory proof and returns the findings;
    with ``raise_on_error`` (default), error findings raise
    :class:`ProgramVerifyError` exactly like ``Program.validate()``."""
    import time

    from ..observe.families import (ANALYSIS_DIST_FINDINGS,
                                    ANALYSIS_DIST_JOBS,
                                    ANALYSIS_DIST_SECONDS)

    t0 = time.perf_counter()
    log = transpiler.get_rewrite_log()
    findings: List[Finding] = []
    if log.get("mode") != "pserver":
        ANALYSIS_DIST_JOBS.labels(site=site).inc()
        return findings  # collective jobs have no wire contract to check
    endpoints = _endpoint_tables(transpiler, pserver_programs)
    if trainer_programs is None:
        trainer_programs = [
            ("trainer", transpiler.get_trainer_program()),
            ("trainer_startup", transpiler.get_trainer_startup_program()),
        ]
    for ep in sorted(endpoints):
        findings += pserver_spec_findings(ep, endpoints[ep].program)
        if endpoints[ep].opt_program is not None:
            infer_program_shapes(endpoints[ep].opt_program, findings)
    for tag, prog in trainer_programs:
        infer_program_shapes(prog, findings)  # the wire checks ride facts
        _wire_findings(tag, prog, endpoints, findings)
        _ordering_findings(tag, prog, log, endpoints, findings)
    _coverage_findings(log, endpoints, findings)
    main_prog = dict(trainer_programs).get("trainer")
    findings += validate_transpile(transpiler, trainer_program=main_prog)
    pserver_memory_findings(endpoints, log, findings)

    ANALYSIS_DIST_JOBS.labels(site=site).inc()
    for f in findings:
        ANALYSIS_DIST_FINDINGS.labels(rule=f.rule).inc()
    ANALYSIS_DIST_SECONDS.observe(time.perf_counter() - t0)
    if raise_on_error and any(f.severity == "error" for f in findings):
        raise ProgramVerifyError(findings)
    return findings
