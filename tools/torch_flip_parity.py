"""Level 2 against level 0 training on one CUDA card, and what sets the
params of the two apart: the f32 programs of chip_smoke.py's phases 8
and 9 (GPT-2 small at S = 1024, batch 8; the transformer at S = 256,
batch 8), PARITY_STEPS Adam steps from one snapshot on each path, each
path on an executor of its own.

The runs, each logged and kept in OUT/flip_parity.json:

- ``sound``: level 2 against level 0 on each seed of ``--seeds`` (the
  weights and the batches made from the seed), GPT-2 small and the
  transformer.
- ``ulp``: level 0 against level 0, the second from the snapshot with
  every param moved by one ulp: a rounding-sized difference planted
  with no kernel in between (GPT-2 small, the first seed).
- ``gelu``: GPT-2 small with gelu FFNs, level 2 against level 0 (the
  first seed).
- ``fault:*``: level 2 with a fault planted in K6's wrapper (the
  function is wrapped while the run lasts; no file changes) against
  level 0 (GPT-2 small, the first seed): the smallest param's update
  lost, every param's rate 1.25 times, the smallest param's rate 1.5
  times.

Each run's readings: the grad gate's (the worst param's l2 difference of
the first step's grads), the losses', the params' max |diff|, the share
of all param elements past PARITY_PARAM_ATOL, the worst param's share
and the worst param's update l2 difference; for each 2-D param with
elements past the atol, how many rows and columns they fall in (an FFN's
first weight is [d_model, d_ff]: a relu unit is a column).

Run from the repo root on a machine with one CUDA card::

    python3 tools/torch_flip_parity.py --out OUT
"""
import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def _values(step, snap, batches, params, grads, fault=None):
    """PARITY_STEPS steps from ``snap`` on a scope of its own, which
    ``fault`` is given: the losses, the first step's grads by param and
    the final params."""
    sc = cs._restored(snap)
    if fault is not None:
        fault.scope = sc
    first, gvals = step(sc, batches[0], list(grads))
    ls = [first] + [step(sc, batches[i % len(batches)])
                    for i in range(1, cs.PARITY_STEPS)]
    ps = {n: sc.find_var(n).clone() for n in params}
    if not (np.isfinite(ls).all() and all(
            bool(torch.isfinite(v).all()) for v in ps.values())):
        raise AssertionError("a path gave a value that is not finite")
    return ls, dict(zip(grads.values(), gvals)), ps


def _path(main, loss, snap, batches, params, grads, level, fault=None):
    """One path on a new executor, so that its plan captures with the
    ``_K6Fault`` ``fault`` (or none) in place."""
    import paddle_tpu_torch as fluid

    os.environ["PADDLE_TPU_OPTIMIZE"] = str(level)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    try:
        step = cs._amp_step_fn(exe, main, loss)
        if fault is None:
            return _values(step, snap, batches, params, grads)
        with fault:
            return _values(step, snap, batches, params, grads, fault)
    finally:
        os.environ.pop("PADDLE_TPU_OPTIMIZE", None)
        exe.close()
        gc.collect()
        torch.cuda.empty_cache()


def _clusters(a, b, params):
    """Per 2-D param with elements past the atol: (name, elements, of
    numel, distinct rows, distinct columns), most elements first."""
    out = []
    for n in params:
        d = (a[n] - b[n]).abs() > cs.PARITY_PARAM_ATOL
        k = int(d.sum())
        if k and d.dim() == 2:
            idx = d.nonzero()
            out.append((n, k, d.numel(), int(idx[:, 0].unique().numel()),
                        int(idx[:, 1].unique().numel())))
        elif k:
            out.append((n, k, d.numel(), None, None))
    return sorted(out, key=lambda t: -t[1])


def _reading(what, a, b, params, snap):
    p = cs._parity(a, b, params, before=snap)
    clusters = _clusters(a[2], b[2], params)
    p["clusters"] = clusters[:12]
    p["elements_past_atol"] = sum(c[1] for c in clusters)
    cs.log("%s: grad l2 %.3e (%s); loss rel %.3e; param max |diff| %.3e; "
           "%d elements past %.0e, a share of %.3e; worst param %s at a "
           "share of %.3e; worst update l2 %s at %.3e; clusters %s" % (
               what, p["grad_l2_rel"][1], p["grad_l2_rel"][0], p["loss_rel"],
               p["param_max_abs"], p["elements_past_atol"],
               cs.PARITY_PARAM_ATOL, p["param_share_over_atol"],
               p["param_worst_share"][0], p["param_worst_share"][1],
               p["update_l2_rel"][0], p["update_l2_rel"][1],
               p["clusters"][:6]))
    return p


class _K6Fault:
    """Wraps K6's wrapper while the run lasts: ``lost`` (the param's
    update dropped), or the rate times ``scale`` for the param ``name``
    (every param with ``name`` None), the param found in ``scope``."""

    def __init__(self, name=None, lost=False, scale=1.0):
        self.name, self.lost, self.scale = name, lost, scale
        self.scope = None

    def _index(self, ins):
        target = self.scope.find_var(self.name)
        for j, t in enumerate(ins["Param"]):
            if t.data_ptr() == target.data_ptr():
                return j
        raise AssertionError("%s is not in K6's group" % self.name)

    def __enter__(self):
        from paddle_tpu_torch.kernels import optimizer_update as ou

        self.orig = orig = ou.adam_group

        def faulty(ins, hyper, **kw):
            js = (range(len(ins["Param"])) if self.name is None
                  else [self._index(ins)])
            lr = list(ins["LearningRate"])
            for j in js:
                lr[j] = lr[j] * self.scale
            kept = {j: ins["Param"][j].clone() for j in js} \
                if self.lost else {}
            out = orig(dict(ins, LearningRate=lr), hyper, **kw)
            for j, t in kept.items():
                out["ParamOut"][j].copy_(t)
            return out

        for k in ("launches", "vector_entries", "bf16_grad_entries"):
            setattr(faulty, k, getattr(orig, k))
        ou.adam_group = faulty
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.kernels import optimizer_update as ou

        ou.adam_group = self.orig
        return False


def _study(model, seed, extra):
    """The runs of one model and seed; ``extra`` adds the first seed's
    witnesses and faults (GPT-2 small only)."""
    t0 = time.perf_counter()
    setup = cs._gpt_setup if model == "gpt" else cs._transformer_setup
    exe, scope, main, loss, params, grads, batches, cfg = setup(seed)
    snap = cs._snapshot(scope)
    exe.close()
    del exe, scope
    args = (main, loss, snap, batches, params, grads)
    out = {}
    l2 = _path(*args, level=2)
    l0 = _path(*args, level=0)
    out["sound"] = _reading("%s seed %d: level 2 vs level 0" % (
        model, seed), l2, l0, params, snap)
    if extra:
        nudged = dict(snap)
        for n in params:
            nudged[n] = torch.nextafter(snap[n], torch.full_like(
                snap[n], float("inf")))
        ulp = _path(main, loss, nudged, batches, params, grads, level=0)
        out["ulp"] = _reading("%s seed %d: level 0 from params one ulp up "
                              "vs level 0" % (model, seed), ulp, l0, params,
                              snap)
        smallest = min(grads.values(),
                       key=lambda n: (snap[n].numel(), n))
        for name, fault in (
                ("fault: %s's update lost" % smallest,
                 _K6Fault(smallest, lost=True)),
                ("fault: every rate 1.25x", _K6Fault(scale=1.25)),
                ("fault: %s's rate 1.5x" % smallest,
                 _K6Fault(smallest, scale=1.5))):
            bad = _path(*args, level=2, fault=fault)
            out[name] = _reading("%s seed %d: %s vs level 0" % (
                model, seed, name), bad, l0, params, snap)
        del nudged
    del l2, l0, snap
    gc.collect()
    torch.cuda.empty_cache()
    if extra and model == "gpt":
        exe, scope, main, loss, params, grads, batches, cfg = \
            cs._gpt_setup(seed, ffn_act="gelu")
        snap = cs._snapshot(scope)
        exe.close()
        del exe, scope
        args = (main, loss, snap, batches, params, grads)
        out["gelu"] = _reading("gpt gelu seed %d: level 2 vs level 0"
                               % seed, _path(*args, level=2),
                               _path(*args, level=0), params, snap)
        del snap
        gc.collect()
        torch.cuda.empty_cache()
    cs.log("%s seed %d: %.1f s" % (model, seed, time.perf_counter() - t0))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[cs.SEED, 1, 2, 3])
    ap.add_argument("--out", help="write the readings to "
                    "OUT/flip_parity.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flip_parity: no CUDA device is visible",
              file=sys.stderr)
        return 1
    os.environ["PADDLE_TPU_KERNEL_CACHE_DIR"] = "0"
    cs.phase_card()
    cs.phase_build()
    res = {}
    for model in ("gpt", "transformer"):
        for i, seed in enumerate(args.seeds):
            res["%s %d" % (model, seed)] = _study(model, seed, i == 0
                                                  and model == "gpt")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "flip_parity.json"), "w") as f:
            json.dump(res, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
