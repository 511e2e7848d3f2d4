"""Pipeline parallelism: the GPipe schedule over a 'pipe' mesh axis.

The port of paddle_tpu/parallel/pipeline.py. Stage s runs at position s
of the axis. The schedule is M + n - 1 ticks (M microbatches, n
stages), each a round: every position whose stage has a microbatch at
that tick (stage s works on microbatch t - s at tick t) runs it, then
the activations shift one position toward the last stage
(``ppermute``). Outside that window a position idles (the bubble); the
JAX package computes a clamped microbatch there and discards it, the
port skips it, since each position's tick is known on the host. The
last stage's outputs are what every position holds at the end (the JAX
package's ``psum`` broadcast).

Gradients are autograd's through the rounds, so the backward is the
reverse-order pipeline (ops/pipeline_ops.py re-runs the forward with
autograd on, replaying its random streams).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from .mesh import note_collective, ppermute

__all__ = ["pipeline_apply"]


def pipeline_apply(stage_fn: Callable, stage_params: Sequence,
                   x_mb: torch.Tensor, axis_name: str = "pipe",
                   mb_arg: bool = False, **detail) -> torch.Tensor:
    """Run microbatches through the stage pipeline.

    stage_fn: (params, x) -> y, one stage's computation; activations keep
        one shape across stages (the GPipe contract). With ``mb_arg=True``
        it is (params, x, mb), ``mb`` the index of the microbatch the
        stage works on: the hook a stochastic body draws its
        per-(stage, microbatch) streams from (ops/pipeline_ops.py).
    stage_params: one entry per stage (position) of the axis: what
        ``stage_fn`` takes as that stage's params.
    x_mb: [M, mb, ...] microbatched input.

    Returns the [M, mb, ...] outputs of the last stage. Notes one
    ``ppermute`` collective (parallel/mesh.py), with ``detail``."""
    n = len(stage_params)
    M = x_mb.shape[0]
    note_collective("ppermute", axis_name, n, microbatches=M, **detail)
    fwd = [(j, j + 1) for j in range(n - 1)]  # shift toward the last stage
    state = [None] * n
    outputs = [None] * M
    for t in range(M + n - 1):
        outs = [None] * n
        for idx in range(n):
            mb = t - idx
            if not 0 <= mb < M:
                continue  # a bubble: this position idles
            inp = x_mb[mb] if idx == 0 else state[idx]
            outs[idx] = (stage_fn(stage_params[idx], inp, mb) if mb_arg
                         else stage_fn(stage_params[idx], inp))
        done = t - (n - 1)  # the microbatch the last stage just finished
        if 0 <= done < M:
            outputs[done] = outs[n - 1]
        state = ppermute(outs, fwd)
    return torch.stack(outputs)
