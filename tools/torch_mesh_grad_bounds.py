#!/usr/bin/env python
"""The first-step grad gaps that chip_smoke.py's phases 21b and 21d hold.

Phase 21b holds the ring's first-step grads against the run without a
mesh, and 21d the pipeline's against the sequential fallback's, each as
a param's largest error over its grad's largest magnitude, within
``GRAD_FACTOR`` times a control gap between two sound f32 computations
of the same grads (21b: flash kernels and composed attention without a
mesh; 21d: plain torch autograd in f32 and in f64). This runs both
phases on the card over several seeds as they are, and again with a
planted fault each bound must refuse:

- ``drop_lse`` (21b): the flash backward loses the lse cotangent (its
  delta without the -g_lse shift), which only the ring hands it;
- ``drop_microbatch`` (21d): the pipeline's last microbatch takes no
  grad (its last-stage output detached).

A planted run takes the bounds off, so it reads the gap instead of
stopping at the bound. One JSON line a run (beside the phases' own
log lines): the phase, seed and plant, each compared run's loss,
first-grad and param gaps, and the control gaps (21b's ``held``, 21d's
``control``).

    python3 tools/torch_mesh_grad_bounds.py                # 3 seeds
    python3 tools/torch_mesh_grad_bounds.py --seeds 7 8 --phases 21d

It needs a CUDA card. Exit code: 0 ok, 2 bad usage or no card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


@contextlib.contextmanager
def _drop_lse():
    from paddle_tpu_torch.ops import attention as attn

    orig = attn._delta
    attn._delta = lambda g, o, g_lse: orig(g, o, None)
    try:
        yield
    finally:
        attn._delta = orig


@contextlib.contextmanager
def _drop_microbatch():
    from paddle_tpu_torch.parallel import pipeline

    orig = pipeline.pipeline_apply

    def planted(stage_fn, stage_params, x_mb, *a, **kw):
        n, M = len(stage_params), x_mb.shape[0]
        calls = {"n": 0}

        def stage(*args):
            y = stage_fn(*args)
            calls["n"] += 1
            # the last stage's last call is the last microbatch's
            return y.detach() if calls["n"] == n * M else y

        return orig(stage, stage_params, x_mb, *a, **kw)

    pipeline.pipeline_apply = planted
    try:
        yield
    finally:
        pipeline.pipeline_apply = orig


@contextlib.contextmanager
def _recorded(c):
    """Every loss and first-grad comparison the phases make, in order:
    (what, gaps) pairs."""
    got = []
    held, grads_held = c._held, c._grads_held

    def rec_held(what, *a):
        out = held(what, *a)
        got.append((what, dict(loss_rel_err=out["loss_rel_err"],
                               param_max_abs=out["param_max_abs"])))
        return out

    def rec_grads(what, *a):
        out = grads_held(what, *a)
        got.append((what, dict(grad_rel_err=out["grad_rel_err"],
                               grad_worst=out["grad_worst"],
                               grad_bound=out["grad_bound"])))
        return out

    c._held, c._grads_held = rec_held, rec_grads
    try:
        yield got
    finally:
        c._held, c._grads_held = held, grads_held


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[1234, 1235, 1236])
    ap.add_argument("--phases", default="21b,21d",
                    help="a comma list of 21b and 21d")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if set(phases) - {"21b", "21d"}:
        ap.error("--phases takes 21b and 21d")
    if not torch.cuda.is_available():
        print("torch_mesh_grad_bounds: no CUDA device is visible",
              file=sys.stderr)
        return 2
    import chip_smoke as c

    os.environ["PADDLE_TPU_KERNEL_CACHE_DIR"] = "0"
    c.phase_card()
    c.phase_build()
    bounds = dict(GRAD_FACTOR=c.GRAD_FACTOR, SP_RTOL=c.SP_RTOL,
                  SP_ATOL=c.SP_ATOL, PIPE_ATOL=c.PIPE_ATOL)
    run = dict(zip(("21b", "21d"), (c.phase_mesh_sp, c.phase_mesh_pipeline)))
    plants = {"21b": _drop_lse, "21d": _drop_microbatch}
    for phase in phases:
        for plant in (None, plants[phase]):
            for seed in args.seeds:
                refused = out = None
                with _recorded(c) as got:
                    if plant is None:
                        out = run[phase](seed)
                    else:
                        for k in bounds:
                            setattr(c, k, float("inf"))
                        try:
                            with plant():
                                out = run[phase](seed)
                        except AssertionError as e:
                            # a check beside the bounds refused the plant
                            # (21d's dropout runs must be bitwise)
                            refused = str(e)
                        finally:
                            for k, v in bounds.items():
                                setattr(c, k, v)
                # the results also carry the control gaps: 21b's in each
                # run's ``held``, 21d's once
                print(json.dumps(dict(
                    phase=phase, seed=seed,
                    plant=plant and plant.__name__.lstrip("_"),
                    gaps=got, refused_by_other_check=refused,
                    held=out and out.get("held"),
                    control=out and out.get("grad_control"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
