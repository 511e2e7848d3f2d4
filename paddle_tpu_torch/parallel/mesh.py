"""The mesh: a grid of positions, and collectives over their values.

The port's counterpart of ``jax.sharding.Mesh``, ``PartitionSpec`` and
``NamedSharding``, and of the ``lax`` collectives (``axis_index``,
``psum``, ``all_gather``, ``ppermute``, ``all_to_all``) that the JAX
package's ``shard_map`` bodies call.

A ``Mesh`` names its axes and holds the place of each position. Several
positions may share one device: the tests run 8 positions on
``CPUPlace()``, the card 4 or 8 on ``cuda:0``. A mesh whose positions
sit on different devices raises: that is the cross-process tier
(ROADMAP A11, part 2), which is not ported.

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
    number of positions and ``device`` the one torch device they share.
    """

    def __init__(self, places, axis_names: Sequence[str]):
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
        devices = sorted({str(p.torch_device()) for p in arr.flat})
        if len(devices) > 1:
            raise NotImplementedError(
                "a mesh over several devices (%s) needs one process per "
                "device and collectives between them: the cross-process "
                "tier (ROADMAP A11, part 2), which is not ported; put "
                "every position on one device" % ", ".join(devices))
        self.places = arr
        self.axis_names = axis_names
        self.shape: "OrderedDict[str, int]" = OrderedDict(
            zip(axis_names, arr.shape))
        self.device = arr.flat[0].torch_device()

    @property
    def size(self) -> int:
        return int(self.places.size)

    @property
    def place(self) -> Place:
        return self.places.flat[0]

    def __repr__(self):
        return "Mesh(%s on %s)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()),
            self.device)


def default_places(place: Optional[Place] = None) -> List[Place]:
    """One position per visible device of ``place``'s kind (the card's
    by default), as the reference's ``CompiledProgram`` takes every
    visible GPU: ``torch.cuda.device_count()`` cards, or ``CPU_NUM``
    (default 1) positions on the CPU. Touches no device for the CPU."""
    place = default_place() if place is None else place
    if place.torch_device().type == "cpu":
        return [CPUPlace()] * max(int(os.environ.get("CPU_NUM", "1")), 1)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return [CUDAPlace(i) for i in range(max(n, 1))]


def make_mesh(places=None, axis_names: Tuple[str, ...] = ("data",),
              shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """A mesh over ``places`` (default: ``default_places()``), reshaped to
    ``shape`` (default: every position on the first axis). The
    counterpart of the JAX package's ``make_mesh`` (engine.py:38); a
    place may repeat, so ``[CPUPlace()] * 8`` is an 8-position mesh."""
    places = list(places) if places is not None else default_places()
    if shape is None:
        shape = (len(places),) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != len(places):
        raise ValueError("mesh shape %s does not hold %d places"
                         % (tuple(shape), len(places)))
    arr = np.empty(len(places), dtype=object)
    arr[:] = places
    return Mesh(arr.reshape(shape), axis_names)


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
