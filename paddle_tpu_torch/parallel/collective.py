"""Collectives across trainer processes: the data axis over ranks.

When ``init_parallel_env`` has joined N trainer processes into one
``torch.distributed`` process group, a mesh's ``data`` axis spans them
(parallel/mesh.py): each rank holds the rows of the positions it owns.
The ops whose results mix rows are completed by the collectives here
(parallel/partition.py says which): the counterpart of the psums and
all-gathers that XLA's partitioner inserts into the JAX engine's step.

Four collectives over the group, each a ``torch.autograd.Function`` with
``setup_context``, so the generic grads (core/autodiff.py,
``torch.func.vjp``) differentiate through them:

- ``all_reduce(x, op, grad)``: the sum (or max, min) over ranks. Its
  backward is the identity where every rank then computes the same thing
  with the result (a loss: the cotangent is already whole), and an
  all-reduce where each rank uses it for its own rows (batch-norm
  statistics: each rank's cotangent is a partial);
- ``all_gather_rows(x, grad)``: every rank's rows, in rank order. Its
  backward is a reduce-scatter where each rank then picks its own rows
  from the result (the cotangents are partials), a slice where every
  rank computes the same thing with it;
- ``reduce_scatter_rows(x)``: the sum over ranks, each rank keeping its
  rows; backward, an all-gather;
- ``broadcast(x, src)``: rank ``src``'s value on every rank.

The transport is the group's backend. NCCL where every local rank has
a card of its own; gloo where ranks share a card, and on the CPU. Gloo
takes only ``broadcast`` and ``all_reduce`` on CUDA tensors and stages
them through the host: that staging is the transport's own. So here
every collective is one of those two. An all-gather is an all-reduce of
a zero-filled buffer holding the rank's rows in place, and a
reduce-scatter an all-reduce followed by a slice. Both are exact:
adding zeros changes no bit.

The bucketed forms (``all_reduce_flat``, ``all_gather_rows_flat``,
``broadcast_flat``) coalesce many tensors of one dtype into flat
buffers of at most ``BUCKET_BYTES`` (64 MiB): the
grads of a step, the params after a ZeRO-1 update, the params rank 0
hands out after startup. Every call is counted in
``paddle_engine_collectives_total{kind}`` (kinds ``xproc_all_reduce``,
``xproc_all_gather``, ``xproc_reduce_scatter``, ``xproc_broadcast``),
with its bytes and host seconds in
``paddle_engine_collective_bytes_total{kind}`` and
``paddle_engine_collective_seconds_total{kind}``; inside an engine's
recording (``ParallelEngine.lowered_collectives``) each is also listed.
A failed collective raises: nothing falls back to a local value.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional, Sequence, Tuple

import torch

from ..observe.families import ENGINE_COLLECTIVES, REGISTRY
from .mesh import recording_target

__all__ = ["Comm", "all_gather_rows", "all_reduce", "broadcast",
           "choose_backend", "rank_device", "reduce_scatter_rows",
           "COLLECTIVE_BYTES", "COLLECTIVE_SECONDS"]

COLLECTIVE_BYTES = REGISTRY.counter(
    "paddle_engine_collective_bytes_total",
    "Bytes each rank hands to cross-process collectives, by kind",
    labels=("kind",))
COLLECTIVE_SECONDS = REGISTRY.counter(
    "paddle_engine_collective_seconds_total",
    "Host seconds spent in cross-process collectives, by kind",
    labels=("kind",))

_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}
# a bucket's most bytes: BERT-base's 532 MB of grads in 9 calls
BUCKET_BYTES = 64 << 20


def choose_backend(endpoints: Sequence[str], on_card: bool,
                   device_count: int) -> str:
    """The process group's backend: NCCL where the ranks run on cards and
    every host's ranks (endpoints sharing a host) fit on distinct cards,
    gloo where ranks share a card (NCCL refuses two ranks on one
    device) and on the CPU. A function of what every rank sees alike:
    the endpoint list and the card count."""
    if not on_card:
        return "gloo"
    per_host = {}
    for ep in endpoints:
        host = ep.rsplit(":", 1)[0]
        per_host[host] = per_host.get(host, 0) + 1
    return "nccl" if max(per_host.values()) <= device_count else "gloo"


_LOGGED = []


def rank_device(penv, place=None) -> Tuple[torch.device, str]:
    """(the rank's device, the group's backend) for ``penv``'s rank: on
    the card (``place`` None or a ``CUDAPlace``) ``cuda:(trainer_id %
    device_count)``, made the current device; on the CPU for a
    ``CPUPlace``. A card rank with no card raises here, before it joins
    the rendezvous. The choice is logged once per process."""
    on_card = place is None or place.torch_device().type == "cuda"
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
            raise RuntimeError(
                "trainer %d of %d is a card rank, but no CUDA device is "
                "visible; pass place=CPUPlace() to run the rank on the CPU"
                % (penv.trainer_id, penv.nranks))
        n = torch.cuda.device_count()
        device = torch.device("cuda", penv.trainer_id % n)
        torch.cuda.set_device(device)
    else:
        n, device = 0, torch.device("cpu")
    backend = choose_backend(penv.trainer_endpoints, on_card, n)
    if not _LOGGED:
        _LOGGED.append(backend)
        sys.stderr.write(
            "paddle_tpu_torch: trainer %d of %d on %s, process group over "
            "%s (%s)\n" % (penv.trainer_id, penv.nranks, device, backend,
                           "ranks share a card" if on_card and
                           backend == "gloo" else "a card each"
                           if on_card else "the CPU"))
    return device, backend


class Comm:
    """The process group a cross-process mesh runs over (the default
    group ``init_parallel_env`` joined), this process' ``rank`` of
    ``world``. ``axis`` names the mesh axis that spans the ranks
    (``data``) and ``positions`` its size, for the records."""

    def __init__(self, rank: int, world: int, axis: str = "data",
                 positions: int = 0):
        self.rank = int(rank)
        self.world = int(world)
        self.axis = axis
        self.positions = int(positions or world)

    # ------------------------------------------------------ raw calls
    def _note(self, kind: str, nbytes: int, seconds: float) -> None:
        ENGINE_COLLECTIVES.labels(kind=kind).inc()
        COLLECTIVE_BYTES.labels(kind=kind).inc(nbytes)
        COLLECTIVE_SECONDS.labels(kind=kind).inc(seconds)
        into = recording_target()
        if into is not None:
            into.append(dict(kind=kind, axis=self.axis,
                             positions=self.positions, ranks=self.world,
                             bytes=int(nbytes)))

    def all_reduce_(self, t: torch.Tensor, op: str = "sum",
                    kind: str = "xproc_all_reduce") -> torch.Tensor:
        """``t`` summed (or max / min) over the ranks, in place."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]))
        self._note(kind, t.numel() * t.element_size(),
                   time.perf_counter() - t0)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        import torch.distributed as dist

        t0 = time.perf_counter()
        dist.broadcast(t, src=src)
        self._note("xproc_broadcast", t.numel() * t.element_size(),
                   time.perf_counter() - t0)
        return t

    # ------------------------------------------------------------ rows
    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global value's rows (a view)."""
        n = x.shape[0]
        if n % self.world:
            raise ValueError("%d rows do not split over %d ranks"
                             % (n, self.world))
        b = n // self.world
        return x.narrow(0, self.rank * b, b)

    def gather_rows(self, x: torch.Tensor,
                    kind: str = "xproc_all_gather") -> torch.Tensor:
        """Every rank's rows of ``x`` in rank order: an all-reduce of a
        zero-filled buffer that holds this rank's rows in place."""
        full = x.new_zeros((x.shape[0] * self.world,) + tuple(x.shape[1:]))
        full.narrow(0, self.rank * x.shape[0], x.shape[0]).copy_(x)
        return self.all_reduce_(full, kind=kind)

    def scatter_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``x``, this rank's rows of it: an
        all-reduce and a slice."""
        return self.rows(self.all_reduce_(
            x.clone(), kind="xproc_reduce_scatter"))

    # -------------------------------------------------------- buckets
    def _buckets(self, tensors: Sequence[torch.Tensor]):
        """Indices of ``tensors`` grouped by dtype and device, each group
        cut into runs of at most the bucket size."""
        cap = BUCKET_BYTES
        groups = {}
        for i, t in enumerate(tensors):
            groups.setdefault((t.dtype, t.device), []).append(i)
        for idx in groups.values():
            run, size = [], 0
            for i in idx:
                nb = tensors[i].numel() * tensors[i].element_size()
                if run and size + nb > cap:
                    yield run
                    run, size = [], 0
                run.append(i)
                size += nb
            if run:
                yield run

    def all_reduce_flat(self, tensors: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
        """Each tensor summed over the ranks, through flat buckets: new
        tensors (views of the buckets), the inputs untouched."""
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        for run in self._buckets(tensors):
            buf = torch.cat([tensors[i].reshape(-1) for i in run])
            self.all_reduce_(buf)
            at = 0
            for i in run:
                n = tensors[i].numel()
                out[i] = buf.narrow(0, at, n).view(tensors[i].shape)
                at += n
        return out

    def all_gather_rows_flat(self, blocks: Sequence[torch.Tensor]
                             ) -> List[torch.Tensor]:
        """For each tensor of this rank's rows, every rank's rows in rank
        order, through flat buckets of zeros with the rank's rows in
        place."""
        out: List[Optional[torch.Tensor]] = [None] * len(blocks)
        for run in self._buckets(blocks):
            total = sum(blocks[i].numel() for i in run) * self.world
            buf = blocks[run[0]].new_zeros(total)
            at = 0
            for i in run:
                n = blocks[i].numel()
                buf.narrow(0, at + self.rank * n, n).copy_(
                    blocks[i].reshape(-1))
                at += n * self.world
            self.all_reduce_(buf, kind="xproc_all_gather")
            at = 0
            for i in run:
                n = blocks[i].numel()
                out[i] = buf.narrow(0, at, n * self.world).view(
                    (blocks[i].shape[0] * self.world,)
                    + tuple(blocks[i].shape[1:]))
                at += n * self.world
        return out

    def broadcast_flat(self, tensors: Sequence[torch.Tensor],
                       src: int = 0) -> List[torch.Tensor]:
        """Rank ``src``'s values of ``tensors`` on every rank, through
        flat buckets: new tensors."""
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        for run in self._buckets(tensors):
            buf = torch.cat([tensors[i].reshape(-1) for i in run])
            self.broadcast_(buf, src)
            at = 0
            for i in run:
                n = tensors[i].numel()
                out[i] = buf.narrow(0, at, n).view(tensors[i].shape).clone()
                at += n
        return out


# ------------------------------------------------- differentiable forms
class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(x, comm, op, grad):
        return comm.all_reduce_(x.detach().clone(), op)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, comm, op, grad = inputs
        ctx.comm, ctx.op, ctx.grad = comm, op, grad
        if op != "sum":
            ctx.save_for_backward(x, output)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        if ctx.grad == "sum":
            g = comm.all_reduce_(g.detach().clone())
        if ctx.op != "sum":
            # the cotangent goes to the rank(s) holding the extremum,
            # shared among ties as the single-process amax shares it
            x, out = ctx.saved_tensors
            hit = (x == out).to(g.dtype)
            g = g * hit / comm.all_reduce_(hit.clone()).clamp_min(1)
        return g, None, None, None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(x, comm, grad):
        return comm.gather_rows(x.detach())

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, comm, grad = inputs
        ctx.comm, ctx.grad = comm, grad

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "reduce_scatter":
            return ctx.comm.scatter_rows(g.detach()), None, None
        return ctx.comm.rows(g).clone(), None, None


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(x, comm):
        return comm.scatter_rows(x.detach())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.comm = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.gather_rows(g.detach()), None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(x, comm, src):
        return comm.broadcast_(x.detach().clone(), src)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.comm, ctx.src = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        # every rank's cotangent flows back to the source's value
        total = ctx.comm.all_reduce_(g.detach().clone())
        keep = ctx.comm.rank == ctx.src
        return (total if keep else torch.zeros_like(total)), None, None


def all_reduce(x: torch.Tensor, comm: Comm, op: str = "sum",
               grad: str = "identity") -> torch.Tensor:
    """``x`` reduced over the ranks (``op``: sum, max or min); its
    backward the identity (``grad="identity"``: every rank then computes
    the same thing with the result) or an all-reduce of the cotangents
    (``grad="sum"``: each rank uses it for its own rows)."""
    if op not in _OPS or grad not in ("identity", "sum"):
        raise ValueError("all_reduce takes op in %s and grad identity|sum; "
                         "got %r, %r" % (sorted(_OPS), op, grad))
    return _AllReduce.apply(x, comm, op, grad)


def all_gather_rows(x: torch.Tensor, comm: Comm,
                    grad: str = "reduce_scatter") -> torch.Tensor:
    """Every rank's rows of ``x`` in rank order; backward a reduce-scatter
    (each rank then uses its own rows of the result) or a slice
    (``grad="slice"``: every rank computes the same thing with it)."""
    if grad not in ("reduce_scatter", "slice"):
        raise ValueError("all_gather_rows takes grad reduce_scatter|slice; "
                         "got %r" % (grad,))
    return _AllGatherRows.apply(x, comm, grad)


def reduce_scatter_rows(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The sum over ranks of ``x``, this rank's rows of it."""
    return _ReduceScatterRows.apply(x, comm)


def broadcast(x: torch.Tensor, comm: Comm, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank."""
    return _Broadcast.apply(x, comm, src)
