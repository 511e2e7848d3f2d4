"""The mesh: a grid of positions, and collectives over their values.

The port's counterpart of ``jax.sharding.Mesh``, ``PartitionSpec`` and
``NamedSharding``, and of the ``lax`` collectives (``axis_index``,
``psum``, ``all_gather``, ``ppermute``, ``all_to_all``) that the JAX
package's ``shard_map`` bodies call.

A ``Mesh`` names its axes and holds the place of each position, and the
rank of the trainer process that holds it. Several positions may share
one device: the tests run 8 positions on ``CPUPlace()``, the card 4 or 8
on ``cuda:0``. After ``init_parallel_env`` has joined N trainer
processes (parallel/env.py), ``default_places`` and ``make_mesh`` build
the global mesh: N times the local positions, rank r's r-th along the
outermost ``data`` axis. Only the ``data`` axis may cross ranks; its
rows are completed across them by the collectives of
parallel/collective.py, as parallel/partition.py plans them. A mesh
whose other axis crosses ranks, or whose positions of one rank sit on
different devices, raises.

The engine (parallel/engine.py) runs one controller over the mesh. Every
op computes with the global semantics of the single-device program, as
the JAX package's SPMD-partitioned step does; only the ops whose JAX
lowering holds per-device code (ring attention, the expert path of
``moe_ffn``, the pipeline schedule) run per position, in rounds: each
position's compute, then one collective over the list of per-position
values. Positions that share a device hand each other their tensors
(a ``ppermute`` moves no data) and may be batched into one launch.

A ``P`` spec gives, per leading dim, the mesh axes it is split over.
``shard(x, spec, mesh, position)`` is one position's block of a global
value: a view, never a copy.
"""

from __future__ import annotations

import contextlib
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.place import CPUPlace, CUDAPlace, Place, default_place

__all__ = ["Mesh", "NamedSharding", "P", "all_gather", "all_to_all",
           "axis_index", "default_places", "make_mesh", "note_collective",
           "ppermute", "psum", "recording", "shard"]


class P(tuple):
    """A partition spec: per leading dim, None (replicated), an axis name
    or a tuple of axis names (split over their product). ``P()`` is
    replicated; trailing dims not named are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P(%s)" % ", ".join(repr(p) for p in self)


class Mesh:
    """Axis names and an array of places, one per position.

    ``shape`` maps each axis to its size (in axis order), ``size`` is the
    number of positions and ``device`` the one torch device this
    process' positions share. ``ranks`` (same shape as ``places``, default
    all 0) holds the trainer rank that holds each position; ``rank`` is
    this process' and ``world`` the number of ranks.
    """

    def __init__(self, places, axis_names: Sequence[str], ranks=None,
                 rank: int = 0):
        arr = np.array(places, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError("a mesh of shape %s needs %d axis names, got %s"
                             % (arr.shape, arr.ndim, axis_names))
        if len(set(axis_names)) != len(axis_names):
            raise ValueError("mesh axis names repeat: %s" % (axis_names,))
        bad = [p for p in arr.flat if not isinstance(p, Place)]
        if bad or arr.size == 0:
            raise TypeError("a mesh's positions are Places (CPUPlace(), "
                            "CUDAPlace(i)); got %r" % (bad[:1] or "none",))
        rk = np.zeros(arr.shape, dtype=np.int64) if ranks is None \
            else np.asarray(ranks, dtype=np.int64).reshape(arr.shape)
        self.places = arr
        self.ranks = rk
        self.rank = int(rank)
        self.world = int(rk.max()) + 1
        self.axis_names = axis_names
        self.shape: "OrderedDict[str, int]" = OrderedDict(
            zip(axis_names, arr.shape))
        mine = [p for p, r in zip(arr.flat, rk.flat) if r == self.rank]
        if not mine:
            raise ValueError("rank %d holds no position of the mesh"
                             % self.rank)
        devices = sorted({str(p.torch_device()) for p in mine})
        if len(devices) > 1:
            raise NotImplementedError(
                "rank %d's positions sit on several devices (%s): a rank "
                "runs its positions on one device; a device of its own "
                "takes a process of its own (ROADMAP A11, part 2c: launch "
                "one rank per device with distributed.launch)"
                % (self.rank, ", ".join(devices)))
        if self.world > 1:
            _check_cross_rank(rk, axis_names)
        self.device = mine[0].torch_device()

    @property
    def size(self) -> int:
        return int(self.places.size)

    @property
    def place(self) -> Place:
        """This process' place (the first position it holds)."""
        return next(p for p, r in zip(self.places.flat, self.ranks.flat)
                    if r == self.rank)

    def rank_of(self, position: Sequence[int]) -> int:
        """The rank that holds ``position`` (one index per axis)."""
        return int(self.ranks[tuple(position)])

    def is_local(self, position: Sequence[int]) -> bool:
        """Whether this process holds ``position``."""
        return self.rank_of(position) == self.rank

    def __repr__(self):
        return "Mesh(%s on %s%s)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()),
            self.device, "" if self.world == 1 else
            ", rank %d of %d" % (self.rank, self.world))


def _check_cross_rank(ranks: np.ndarray, axis_names) -> None:
    """Only the ``data`` axis may cross ranks, each rank's positions a
    block of it in rank order: moving along any other axis keeps the
    rank."""
    if "data" not in axis_names:
        raise NotImplementedError(
            "a mesh of axes %s spans %d ranks but has no 'data' axis: only "
            "the data axis crosses processes (ROADMAP A11: other axes "
            "across ranks)" % (tuple(axis_names), int(ranks.max()) + 1))
    for i, a in enumerate(axis_names):
        if a == "data":
            continue
        moved = np.moveaxis(ranks, i, 0)
        if (moved != moved[:1]).any():
            raise NotImplementedError(
                "mesh axis %r crosses ranks: only the 'data' axis spans "
                "processes; every other axis stays inside one (ROADMAP "
                "A11: other axes across ranks)" % a)
    d = list(axis_names).index("data")
    along = np.moveaxis(ranks, d, 0).reshape(ranks.shape[d], -1)[:, 0]
    if (np.diff(along) < 0).any() or (np.diff(along) > 1).any() or \
            along[0] != 0:
        raise NotImplementedError(
            "the data axis must hold rank r's positions r-th, in blocks "
            "(got ranks %s along it)" % along.tolist())


def process_group():
    """(rank, world size) of the process group ``init_parallel_env``
    joined, or (0, 1) where there is none."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def default_places(place: Optional[Place] = None) -> List[Place]:
    """This process' positions: one per visible device of ``place``'s
    kind (the card's by default), as the reference's ``CompiledProgram``
    takes every visible GPU: ``torch.cuda.device_count()`` cards, or
    ``CPU_NUM`` (default 1) positions on the CPU. Touches no device for
    the CPU. A trainer rank of a process group takes its own card,
    ``cuda:(rank % device_count)`` (parallel/env.py): one position."""
    place = default_place() if place is None else place
    if place.torch_device().type == "cpu":
        return [CPUPlace()] * max(int(os.environ.get("CPU_NUM", "1")), 1)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    rank, world = process_group()
    if world > 1:
        return [CUDAPlace(rank % max(n, 1))]
    return [CUDAPlace(i) for i in range(max(n, 1))]


def make_mesh(places=None, axis_names: Tuple[str, ...] = ("data",),
              shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """A mesh over ``places`` (default: ``default_places()``), reshaped to
    ``shape`` (default: every position on the first axis). The
    counterpart of the JAX package's ``make_mesh`` (engine.py:38); a
    place may repeat, so ``[CPUPlace()] * 8`` is an 8-position mesh.
    Under a process group of N ranks, ``places`` are this rank's and the
    mesh is global: N times as many positions, rank r's r-th in order
    (``shape`` counts them all)."""
    places = list(places) if places is not None else default_places()
    rank, world = process_group()
    ranks = [r for r in range(world) for _ in places]
    places = places * world
    if shape is None:
        shape = (len(places),) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != len(places):
        raise ValueError("mesh shape %s does not hold %d places%s" % (
            tuple(shape), len(places), "" if world == 1 else
            " (%d ranks x %d)" % (world, len(places) // world)))
    arr = np.empty(len(places), dtype=object)
    arr[:] = places
    return Mesh(arr.reshape(shape), axis_names,
                np.asarray(ranks).reshape(shape), rank)


def _axes(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def shard(x: torch.Tensor, spec: P, mesh: Mesh,
          position: Union[Dict[str, int], Sequence[int]]) -> torch.Tensor:
    """The block of the global value ``x`` that ``position`` holds under
    ``spec``: a view of ``x`` (``narrow`` per split dim). ``position``
    is a dict of axis indices (absent axes 0) or one index per mesh
    axis, in axis order."""
    if not isinstance(position, dict):
        position = dict(zip(mesh.axis_names, position))
    for dim, part in enumerate(spec):
        axes = _axes(part)
        if not axes:
            continue
        k, idx = 1, 0
        for a in axes:  # the first named axis is the major one
            idx = idx * mesh.shape[a] + int(position.get(a, 0))
            k *= mesh.shape[a]
        if x.shape[dim] % k:
            raise ValueError("dim %d of %s does not split %d ways (%s)"
                             % (dim, tuple(x.shape), k, spec))
        size = x.shape[dim] // k
        x = x.narrow(dim, idx * size, size)
    return x


class NamedSharding:
    """A spec on a mesh: the placement of one value."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


# ------------------------------------------------------------ collectives
# Each takes the list of per-position values along one mesh axis (entry
# i is position i's) and returns the list each position holds after it.
def axis_index(n: int) -> List[int]:
    """Each position's index along an axis of ``n`` positions."""
    return list(range(n))


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over the axis, held by every position (one tensor)."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return [total] * len(xs)


def all_gather(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The values stacked on a new leading dim, held by every position."""
    g = torch.stack(list(xs))
    return [g] * len(xs)


def ppermute(xs: Sequence[Any], perm: Sequence[Tuple[int, int]]
             ) -> List[Any]:
    """Position ``dst`` receives position ``src``'s value for each
    (src, dst) of ``perm``; a position that receives nothing holds None
    (``lax.ppermute`` gives it zeros). On a shared device the hop moves
    no data: the receiver holds the sender's tensor."""
    out: List[Any] = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src]
    return out


def all_to_all(xs: Sequence[torch.Tensor], split_axis: int,
               concat_axis: int) -> List[torch.Tensor]:
    """Position i splits its value into n blocks along ``split_axis``
    and sends block j to position j, which concatenates the blocks it
    receives along ``concat_axis`` in source order (``tiled=True``)."""
    n = len(xs)
    blocks = [x.chunk(n, dim=split_axis) for x in xs]
    return [torch.cat([blocks[i][j] for i in range(n)], dim=concat_axis)
            for j in range(n)]


# --------------------------------------------------------------- records
# Where the per-position algorithms note their collectives: the engine's
# plan description (``ParallelEngine.lowered_collectives``) and the
# ``paddle_engine_collectives_total{kind}`` counter, which counts once
# per plan (the JAX package counts once per trace) or, outside an
# engine's recording, once per call.
_LOCAL = threading.local()
_MUTED = object()


@contextlib.contextmanager
def recording(into: Optional[List[Dict[str, Any]]]):
    """Within the block, ``note_collective`` appends to ``into`` and
    counts; with ``into=None`` it does neither (a plan's later runs)."""
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    stack.append(_MUTED if into is None else into)
    try:
        yield
    finally:
        stack.pop()


def recording_target() -> Optional[List[Dict[str, Any]]]:
    """The list an engine's recording appends to, or None (no recording,
    or a plan's later runs)."""
    stack = getattr(_LOCAL, "stack", None)
    target = stack[-1] if stack else None
    return None if target is _MUTED else target


def note_collective(kind: str, axis: str, positions: int,
                    **detail) -> None:
    """Record one collective of a per-position algorithm: its
    ``kind`` label (the JAX package's: ``ring_ppermute``, ``ppermute``,
    ``all_to_all``, ...), its mesh axis and that axis' positions."""
    from ..observe.families import ENGINE_COLLECTIVES

    stack = getattr(_LOCAL, "stack", None)
    target = stack[-1] if stack else None
    if target is _MUTED:
        return
    if target is not None:
        target.append(dict(kind=kind, axis=axis, positions=int(positions),
                           **detail))
    ENGINE_COLLECTIVES.labels(kind=kind).inc()
