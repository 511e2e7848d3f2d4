"""ResNet-50, VGG-16 and SE-ResNeXt-50 (the zoo's batch-norm nets) in the
port against the JAX package on the CPU, over 5 Adam steps (lr 1e-3)
after a scope transplant (``convert.params_from_jax``: the running mean
and variance too). Both packages build the same Program (``to_dict``);
VGG's and SE-ResNeXt's dropout ops are set to ``is_test`` in both, as
the Predictor does, so no random mask enters the comparison.

Their training is chaotic at these sizes in the JAX package itself, so
they cannot be held as tests/test_torch_vision.py holds the MNIST CNN,
DeepFM and ViT (5 free-running steps, losses rtol 1e-5, params atol
1e-4). From params one ulp up, the JAX package's own ResNet-50 loss
moves by 13% at the lint example's batch of 2 at 32 x 32 (a batch norm
over the last stage's 2 values per channel is the sign of their
difference), and at any batch and size its first step's param grads
move by 1-3% in l2: rounding flips the relus whose input lies near 0
(tens of units of the last stage), and Adam's first steps move every
element whose grad is smaller than that by lr either way, so losses part
by percents within 5 steps
(``test_batch_norm_nets_are_chaotic_in_the_jax_package``, and the
self-reading in ``test_bn_net_trains_like_the_jax_package``).

So each of the 5 steps starts both packages from the JAX package's
state before it (params, moments, beta powers, running stats), on the
same feeds, at a batch and image size where the forward is well
conditioned: ResNet-50 at 64 x 64, batch 8 (its last stage's batch
norms then see 32 values a channel), SE-ResNeXt-50 at 32 x 32, batch 16,
VGG at 32 x 32, batch 8. Each step's loss agrees to a relative 1e-4
(read: at most 1.8e-5, ResNet-50's second and third steps; the JAX
package against itself one ulp up 3.5e-6 on the first) and its accuracy
exactly; the running stats it writes within 2e-4 in l2 of their size
(read: at most 3.9e-5; one ulp up 2.6e-5; a biased variance for an
unbiased one is off by about 3e-3); each param's grad within GRAD_L2 =
0.25 in l2 of its size, or of 1e-4 of all the grads' l2 norm where its
own is smaller (a grad that is rounding noise, as a bias ahead of a
batch norm has; read: at most 3.6e-2, ResNet-50's second step; one ulp
up 1.7e-2; a wrong grad is off by its whole size).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import params_from_jax

CPU = torch.device("cpu")
LR, STEPS = 1e-3, 5
# the step by step bounds (the module docstring has their readings):
# each param's grad in l2 of its size (floored at GRAD_FLOOR of all the
# grads' l2 norm), the loss, the running stats in l2 of their size
GRAD_L2, GRAD_FLOOR, BN_LOSS_RTOL, BN_STATS_L2 = 0.25, 1e-4, 1e-4, 2e-4


@pytest.fixture(scope="module", autouse=True)
def _no_global_gradient_clip():
    """tests/test_grad_accum.py sets the JAX package's process-global
    gradient clip (``clip.set_gradient_clip``) and leaves it set, so a
    later ``minimize`` in the same process appends clip ops to the JAX
    program alone. This module's fixtures and tests run with neither
    package's global clip set."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jf.clip, "_global_clip", None)
        mp.setattr(pt.clip, "_global_clip", None)
        yield


def _image_feeds(rs, batch, shape, classes=10):
    return {"img": rs.randn(batch, *shape).astype("float32"),
            "label": rs.randint(0, classes, (batch, 1)).astype("int64")}


# name -> (build(models module of a package) -> (loss, acc), feeds(rs))
MODELS = {
    "resnet": (lambda m: m.resnet.build(class_dim=10, depth=50,
                                        image_shape=(3, 64, 64))[:2],
               lambda rs: _image_feeds(rs, 8, (3, 64, 64))),
    "vgg": (lambda m: m.vgg.build(class_dim=10, image_shape=(3, 32, 32))[:2],
            lambda rs: _image_feeds(rs, 8, (3, 32, 32))),
    "se_resnext": (lambda m: m.se_resnext.build(
        class_dim=10, image_shape=(3, 32, 32))[:2],
        lambda rs: _image_feeds(rs, 16, (3, 32, 32))),
}


def _build(pkg, name):
    from importlib import import_module

    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, acc = MODELS[name][0](import_module(pkg.__name__ + ".models"))
        pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
    # dropout in test mode in both programs (the Predictor's rewrite)
    for op in main.global_block().ops:
        if op.type == "dropout":
            op.attrs["is_test"] = True
    main._bump()
    return main, startup, loss, acc


def _bn_stats(program):
    """The batch norms' running mean and variance var names."""
    return sorted(n for op in program.global_block().ops
                  if op.type == "batch_norm"
                  for n in op.input("Mean") + op.input("Variance"))


def _jax_steps(name, jmain, jstart, jloss, jacc):
    """The JAX package's side of a model test: the feeds, the param
    grads' names, and per step its state before the step (every
    persistable), loss, accuracy and param grads; its state after the
    last step; and the first step's outputs from params one ulp up
    (the same program, so the same compiled step)."""
    rs = np.random.RandomState(3)
    feeds = [MODELS[name][1](rs) for _ in range(STEPS)]
    grads = [p.name + "@GRAD" for p in jmain.global_block().all_parameters()]
    fetch = [jloss, jacc] + grads
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    persist = [v.name for v in jmain.list_vars() if v.persistable]
    steps = []
    for f in feeds:
        before = {n: np.array(jscope.find_var(n)) for n in persist}
        out = [np.asarray(v) for v in jexe.run(
            jmain, feed=f, fetch_list=fetch, scope=jscope)]
        steps.append((before, out))
    after = {n: np.array(jscope.find_var(n)) for n in persist}
    params = {p.name for p in jmain.global_block().all_parameters()}
    up = jf.Scope()
    for n, v in steps[0][0].items():
        up.set_var(n, np.nextafter(v, np.float32(np.inf)) if n in params
                   else v)
    ulp = [np.asarray(v) for v in jexe.run(jmain, feed=feeds[0],
                                            fetch_list=fetch, scope=up)]
    return feeds, grads, steps, after, ulp


def _grad_l2(got, want, floor=0.0):
    return float(np.linalg.norm(got.astype("float64") - want) /
                 max(np.linalg.norm(want.astype("float64")), floor, 1e-30))


def _l2(vals):
    return float(np.sqrt(sum(np.sum(np.asarray(v, "float64") ** 2)
                             for v in vals)))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bn_net_trains_like_the_jax_package(name):
    jmain, jstart, jloss, jacc = _build(jf, name)
    tmain, tstart, tloss, tacc = _build(pt, name)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    feeds, grads, steps, after, ulp = _jax_steps(name, jmain, jstart, jloss,
                                                 jacc)
    stats = _bn_stats(tmain)
    assert stats
    params = [p.name for p in tmain.global_block().all_parameters()]
    exe = pt.Executor(pt.CPUPlace())

    def scope_of(state):
        scope = pt.Scope()
        for n, v in params_from_jax(state, tmain, CPU).items():
            scope.set_var(n, v)
        return scope

    # each step from the JAX package's state before it. The grad bound sits well above the JAX package's own reading
    # from params one ulp up
    want = steps[0][1]
    floor = GRAD_FLOOR * _l2(want[2:])
    self_reading = max(_grad_l2(u, w, floor)
                       for u, w in zip(ulp[2:], want[2:]))
    assert 1e-4 < self_reading < GRAD_L2 / 4, self_reading
    for i, (f, (before, want)) in enumerate(zip(feeds, steps)):
        scope = scope_of(before)
        got = exe.run(tmain, feed=f, fetch_list=[tloss, tacc] + grads,
                      scope=scope)
        np.testing.assert_allclose(float(got[0].reshape(())),
                                   float(want[0].reshape(())),
                                   rtol=BN_LOSS_RTOL, atol=0,
                                   err_msg="step %d loss" % i)
        np.testing.assert_array_equal(got[1], want[1])
        floor = GRAD_FLOOR * _l2(want[2:])
        worst = max((_grad_l2(g, w, floor), n) for g, w, n in
                    zip(got[2:], want[2:], params))
        assert worst[0] <= GRAD_L2, (i, worst)
        nxt = steps[i + 1][0] if i + 1 < STEPS else after
        for n in stats:
            s_got = scope.find_var(n).numpy()
            assert _grad_l2(s_got, nxt[n]) <= BN_STATS_L2, (i, n)
            assert not np.array_equal(s_got, before[n]), (i, n)
        # every param moved: the step's update ran
        assert all(not np.array_equal(scope.find_var(n).numpy(), before[n])
                   for n in params), i


def test_batch_norm_nets_are_chaotic_in_the_jax_package():
    """Why the batch-norm nets are held step by step and at larger
    sizes: at the lint example's size (32 x 32, here batch 2) the JAX
    package's own ResNet-50 loss moves by more than 1% from params one
    ulp up (the last stage's batch norms see 2 values a channel). At the
    test's sizes its first grads move by 1e-4 to GRAD_L2 / 4 (read in
    ``test_bn_net_trains_like_the_jax_package``)."""
    from paddle_tpu.models import resnet as jresnet

    main, startup = jf.Program(), jf.Program()
    main.random_seed = startup.random_seed = 11
    with jf.program_guard(main, startup), jf.unique_name.guard():
        loss = jresnet.build(class_dim=10, depth=50,
                             image_shape=(3, 32, 32))[0]
    small = _image_feeds(np.random.RandomState(3), 2, (3, 32, 32), 10)
    exe = jf.Executor(jf.CPUPlace())
    losses = []
    for up in (False, True):
        scope = jf.Scope()
        exe.run(startup, scope=scope)
        if up:
            for p in main.global_block().all_parameters():
                v = np.asarray(scope.find_var(p.name))
                scope.set_var(p.name, np.nextafter(v, np.float32(np.inf)))
        losses.append(float(np.asarray(exe.run(
            main, feed=small, fetch_list=[loss], scope=scope)[0])))
    assert abs(losses[1] - losses[0]) > 1e-2 * abs(losses[0]), losses
