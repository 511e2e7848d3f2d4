"""The nine optimizer lowerings the port adds (ops/optimizer_ops.py:
``lars_momentum``, ``adamax``, ``adagrad``, ``decayed_adagrad``,
``adadelta``, ``rmsprop``, ``ftrl``, ``lamb`` and
``average_accumulates``), held against the JAX package's on the CPU.

- Each lowering on seeded numpy inputs, with the attr variants that
  change its code path: ``lamb`` with a zero param (the trust ratio's
  fallback to 1) and with a zero grad, ``ftrl`` at ``lr_power`` -0.5
  and -0.6 with l1 = 0 and l1 > 0, ``rmsprop`` centered, not centered
  and not centered with a MeanGrad passed through, and
  ``average_accumulates`` chained over 6 updates across the 16384-update
  roll and the window trigger. Elementwise outputs at rtol 2e-6 plus
  atol 1e-7: XLA's CPU fusions may contract a product and a sum into
  one FMA where torch rounds both, and the two libraries' ``pow``
  differ in the last bit (readings: bitwise but for ftrl at lr_power
  -0.6, 5.2e-7 relative). ``lars_momentum`` and ``lamb`` reduce two
  norms over the param: f32 sums in another order, so their params at
  rtol 1e-5 (readings: bitwise at these sizes).
  ``average_accumulates`` bitwise: its sums are one f32 add each and
  its counters integers.
- Each optimizer class (``LarsMomentum``, ``Adamax``, ``Adagrad``,
  ``DecayedAdagrad``, ``Adadelta``, ``RMSProp`` centered and not,
  ``Ftrl`` at both powers, ``Lamb``) on the lint examples' MNIST MLP:
  both packages build the same programs, the JAX startup scope moves
  into the port (``convert.params_from_jax``) and both take 5 steps on
  the same feeds. Losses at rtol 1e-5 (readings: at most 2.1e-6) and
  params at atol 1e-4, the earlier slices' bounds (readings: at most
  8.3e-6), but for Ftrl at 2e-4 (readings 8.8e-5 with l1 = 1e-3 and
  1.7e-5 at lr_power -0.6): where a grad is rounding noise, Ftrl's step
  ``(clip(z, -l1, l1) - z) / (sqrt(n) / lr)`` divides by that noise, so
  the two packages' noise moves such a param by up to about lr / 10.
  Accumulators (moments, squared and linear sums) at 1e-3 of their
  largest value (readings: Ftrl's linear sum 1.8e-4, every other at
  most 3.1e-5).
- ``ModelAverage`` over Adam with a window of 2-3 updates: 5 steps,
  then ``apply()`` swaps in the averages (each the mean of the f32
  sums, taken in float64, exactly; the JAX package's at the params'
  atol 1e-4, since the packages' trained params differ by that much)
  and ``restore()`` brings the trained params back bitwise.
- Under AMP the nine op types take the JAX package's policy (f32, grads
  upcast), and a Lamb step on an MLP keeps f32 params and moments.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu.core import amp as jamp
from paddle_tpu.core.lowering import LowerContext as JaxContext
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.analysis import shape_rules
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.core import amp as tamp
from paddle_tpu_torch.core.lowering import LowerContext
from paddle_tpu_torch.core.registry import OPS, get_op

CPU = torch.device("cpu")
NEW_OPS = ("lars_momentum", "adamax", "adagrad", "decayed_adagrad",
           "adadelta", "rmsprop", "ftrl", "lamb", "average_accumulates")
SHAPE = (7, 5)
RTOL, ATOL = 2e-6, 1e-7
NORM_RTOL = 1e-5
STEPS = 5
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _no_global_gradient_clip():
    """tests/test_grad_accum.py leaves the JAX package's process-global
    gradient clip set; this module runs with neither package's set."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jf.clip, "_global_clip", None)
        mp.setattr(pt.clip, "_global_clip", None)
        yield


def _lower_both(op_type, ins, attrs):
    """The op's lowering in both packages on the same numpy ``ins``:
    ({slot: [numpy]} of the JAX package, of the port)."""
    j = jax_op(op_type).lowering(
        JaxContext(None, None),
        {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        dict(attrs))
    t = get_op(op_type).lowering(
        LowerContext(None, None, CPU),
        {k: [torch.from_numpy(np.array(v)) for v in vs]
         for k, vs in ins.items()}, dict(attrs))
    to_np = lambda outs, f: {k: [f(v) for v in vs]  # noqa: E731
                             for k, vs in outs.items()}
    return (to_np(j, np.asarray),
            to_np(t, lambda v: v.detach().numpy()))


def _state(rs, *slots, positive=()):
    out = {}
    for s in slots:
        a = rs.randn(*SHAPE).astype("float32")
        out[s] = [np.abs(a) + 0.1 if s in positive else a]
    return out


def _scalar(v):
    return [np.array([v], "float32")]


def _case(op_type, seed=0, zero=(), **attrs):
    """Seeded inputs of one update, with the slots in ``zero`` zeroed."""
    rs = np.random.RandomState(seed)
    lr = _scalar(0.05)
    if op_type == "lars_momentum":
        ins = _state(rs, "Param", "Grad", "Velocity")
    elif op_type == "adamax":
        ins = _state(rs, "Param", "Grad", "Moment", "InfNorm",
                     positive=("InfNorm",))
        ins["Beta1Pow"] = _scalar(0.9 ** 3)
    elif op_type in ("adagrad", "decayed_adagrad"):
        ins = _state(rs, "Param", "Grad", "Moment", positive=("Moment",))
    elif op_type == "adadelta":
        ins = _state(rs, "Param", "Grad", "AvgSquaredGrad",
                     "AvgSquaredUpdate",
                     positive=("AvgSquaredGrad", "AvgSquaredUpdate"))
    elif op_type == "rmsprop":
        ins = _state(rs, "Param", "Grad", "MeanSquare", "Moment",
                     "MeanGrad", positive=("MeanSquare",))
        # centered needs ms - mg^2 + eps > 0
        ins["MeanGrad"] = [ins["MeanGrad"][0] * 0.01]
        if attrs.pop("no_mean_grad", False):
            del ins["MeanGrad"]
    elif op_type == "ftrl":
        ins = _state(rs, "Param", "Grad", "SquaredAccumulator",
                     "LinearAccumulator", positive=("SquaredAccumulator",))
    elif op_type == "lamb":
        ins = _state(rs, "Param", "Grad", "Moment1", "Moment2",
                     positive=("Moment2",))
        ins["Beta1Pow"] = _scalar(0.9 ** 2)
        ins["Beta2Pow"] = _scalar(0.999 ** 2)
    else:
        raise ValueError(op_type)
    if op_type != "adadelta":
        ins["LearningRate"] = lr
    for s in zero:
        ins[s] = [np.zeros_like(ins[s][0])]
    return ins, attrs


CASES = {
    "lars_momentum": ("lars_momentum", {}, dict(mu=0.9, lars_coeff=1e-3,
                                                lars_weight_decay=5e-4)),
    "adamax": ("adamax", {}, dict(beta1=0.9, beta2=0.999, epsilon=1e-8)),
    "adagrad": ("adagrad", {}, dict(epsilon=1e-6)),
    "decayed_adagrad": ("decayed_adagrad", {}, dict(decay=0.95,
                                                    epsilon=1e-6)),
    "adadelta": ("adadelta", {}, dict(rho=0.95, epsilon=1e-6)),
    "rmsprop_centered": ("rmsprop", {}, dict(decay=0.9, epsilon=1e-6,
                                             momentum=0.5, centered=True)),
    "rmsprop_plain": ("rmsprop", {}, dict(decay=0.9, epsilon=1e-6,
                                          momentum=0.5, centered=False)),
    "rmsprop_no_mean_grad": ("rmsprop", {}, dict(
        decay=0.9, epsilon=1e-6, momentum=0.0, no_mean_grad=True)),
    "ftrl_sqrt_l1_0": ("ftrl", {}, dict(l1=0.0, l2=0.1, lr_power=-0.5)),
    "ftrl_sqrt_l1": ("ftrl", {}, dict(l1=0.5, l2=0.1, lr_power=-0.5)),
    "ftrl_power_l1_0": ("ftrl", {}, dict(l1=0.0, l2=0.0, lr_power=-0.6)),
    "ftrl_power_l1": ("ftrl", {}, dict(l1=0.5, l2=0.1, lr_power=-0.6)),
    "lamb": ("lamb", {}, dict(beta1=0.9, beta2=0.999, epsilon=1e-6,
                              weight_decay=0.01)),
    "lamb_zero_param": ("lamb", dict(zero=("Param",)), dict(
        beta1=0.9, beta2=0.999, epsilon=1e-6, weight_decay=0.01)),
    "lamb_zero_update": ("lamb", dict(zero=("Param", "Grad", "Moment1")),
                         dict(beta1=0.9, beta2=0.999, epsilon=1e-6,
                              weight_decay=0.0)),
}


def test_the_nine_ops_are_registered_with_their_shape_rules():
    for t in NEW_OPS:
        assert t in OPS, t
    assert not set(NEW_OPS) & set(shape_rules.SKIPPED)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lowering_matches_the_jax_package(case):
    op_type, kw, attrs = CASES[case]
    ins, attrs = _case(op_type, **kw, **attrs)
    want, got = _lower_both(op_type, ins, attrs)
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    norms = op_type in ("lars_momentum", "lamb")
    for slot in want:
        for w, g in zip(want[slot], got[slot]):
            assert g.shape == w.shape and g.dtype == w.dtype, slot
            rtol = NORM_RTOL if norms and slot == "ParamOut" else RTOL
            np.testing.assert_allclose(g, w, rtol=rtol, atol=ATOL,
                                       err_msg="%s %s" % (case, slot))
            assert np.isfinite(g).all(), slot


def test_lamb_falls_back_to_a_unit_ratio_where_a_norm_is_zero():
    """A zero param: |p| = 0, so the update is lr * r itself."""
    ins, attrs = _case("lamb", zero=("Param",), beta1=0.9, beta2=0.999,
                       epsilon=1e-6, weight_decay=0.01)
    _, got = _lower_both("lamb", ins, attrs)
    g, m, v = ins["Grad"][0], ins["Moment1"][0], ins["Moment2"][0]
    m1 = 0.9 * m + 0.1 * g
    v1 = 0.999 * v + 0.001 * g * g
    r = (m1 / (1 - 0.9 ** 3)) / (np.sqrt(v1 / (1 - 0.999 ** 3)) + 1e-6)
    np.testing.assert_allclose(got["ParamOut"][0], -0.05 * r, rtol=1e-5)
    np.testing.assert_allclose(got["Beta1PowOut"][0], [0.9 ** 3], rtol=1e-6)


def test_ftrl_zero_branch_is_a_select():
    """l1 above every |LinearAccum|: every param is exactly 0, not a
    0 / denominator (which would be nan where the accumulator is 0)."""
    ins, attrs = _case("ftrl", zero=("SquaredAccumulator",), l1=1e6,
                       l2=0.0, lr_power=-0.6)
    ins["Grad"] = [np.zeros(SHAPE, "float32")]
    want, got = _lower_both("ftrl", ins, attrs)
    np.testing.assert_array_equal(got["ParamOut"][0], np.zeros(SHAPE))
    np.testing.assert_array_equal(got["ParamOut"][0], want["ParamOut"][0])


def test_average_accumulates_across_both_rolls():
    """6 chained updates from 16380 updates, a window of 2-3
    accumulates: the 16384-update roll of sum_1 into sum_2 and the
    window trigger into sum_3 both fire, bitwise as in the JAX
    package."""
    rs = np.random.RandomState(5)
    attrs = dict(average_window=0.5, min_average_window=2,
                 max_average_window=3)
    zeros = np.zeros(SHAPE, "float32")
    state = {"in_sum_1": [zeros], "in_sum_2": [zeros], "in_sum_3": [zeros],
             "in_num_accumulates": [np.array([1], "int32")],
             "in_old_num_accumulates": [np.array([0], "int32")],
             "in_num_updates": [np.array([16380], "int32")]}
    fired = set()
    for step in range(6):
        ins = dict(state, param=[rs.randn(*SHAPE).astype("float32")])
        want, got = _lower_both("average_accumulates", ins, attrs)
        for slot in want:
            np.testing.assert_array_equal(got[slot][0], want[slot][0],
                                          err_msg="%d %s" % (step, slot))
            assert got[slot][0].dtype == want[slot][0].dtype
        if int(got["out_num_updates"][0][0]) % 16384 == 0:
            fired.add("roll")
        if int(got["out_num_accumulates"][0][0]) == 0:
            fired.add("window")
        state = {"in" + k[3:]: v for k, v in got.items()}
    assert fired == {"roll", "window"}


# ------------------------------------------------------------ the classes
def _optimizers(pkg):
    o = pkg.optimizer
    return {
        "lars_momentum": lambda: o.LarsMomentum(0.1, momentum=0.9),
        "adamax": lambda: o.Adamax(LR),
        "adagrad": lambda: o.Adagrad(LR),
        "decayed_adagrad": lambda: o.DecayedAdagrad(LR),
        "adadelta": lambda: o.Adadelta(LR),
        "rmsprop": lambda: o.RMSProp(LR, momentum=0.5),
        "rmsprop_centered": lambda: o.RMSProp(LR, momentum=0.5,
                                              centered=True),
        "ftrl": lambda: o.Ftrl(LR, l1=1e-3, l2=1e-3),
        "ftrl_power": lambda: o.Ftrl(LR, l1=1e-3, lr_power=-0.6),
        "lamb": lambda: o.Lamb(LR),
    }


def _build(pkg, opt_name=None, average=False, amp=False):
    from importlib import import_module

    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        models = import_module(pkg.__name__ + ".models")
        loss, _, _ = models.mnist.build("mlp")
        opt = (_optimizers(pkg)[opt_name]() if opt_name
               else pkg.optimizer.Adam(LR))
        if amp:
            opt = pkg.contrib.mixed_precision.decorate(opt)
        opt.minimize(loss)
        ma = pkg.optimizer.ModelAverage(
            0.5, min_average_window=2, max_average_window=3) \
            if average else None
    return main, startup, loss, ma


def _feeds(n, seed=3):
    rs = np.random.RandomState(seed)
    return [{"img": rs.rand(8, 784).astype("float32"),
             "label": rs.randint(0, 10, (8, 1)).astype("int64")}
            for _ in range(n)]


def _run_both(opt_name=None, average=False, amp=False):
    jmain, jstart, jloss, jma = _build(jf, opt_name, average, amp)
    tmain, tstart, tloss, tma = _build(pt, opt_name, average, amp)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    feeds = _feeds(STEPS)
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jmain.list_vars() if v.persistable}
    want = [float(np.asarray(jexe.run(jmain, feed=f, fetch_list=[jloss],
                                      scope=jscope)[0]).reshape(()))
            for f in feeds]
    scope = pt.Scope()
    for n, v in params_from_jax(state, tmain, CPU).items():
        scope.set_var(n, v)
    exe = pt.Executor(pt.CPUPlace())
    got = [float(exe.run(tmain, feed=f, fetch_list=[tloss],
                         scope=scope)[0].reshape(())) for f in feeds]
    return dict(jmain=jmain, jscope=jscope, jexe=jexe, jma=jma, want=want,
                tmain=tmain, scope=scope, exe=exe, tma=tma, got=got)


PARAM_ATOL = dict(ftrl=2e-4, ftrl_power=2e-4)
ACCUM_SHARE = 1e-3


@pytest.mark.parametrize("opt_name", sorted(_optimizers(pt)))
def test_optimizer_trains_like_the_jax_package(opt_name):
    r = _run_both(opt_name)
    np.testing.assert_allclose(r["got"], r["want"], rtol=1e-5, atol=0)
    assert r["got"][-1] != r["got"][0]
    params = {p.name for p in r["tmain"].global_block().all_parameters()}
    for v in r["tmain"].list_vars():
        if not v.persistable:
            continue
        got = r["scope"].find_var(v.name).numpy()
        want = np.asarray(r["jscope"].find_var(v.name))
        atol = PARAM_ATOL.get(opt_name, 1e-4) if v.name in params else \
            ACCUM_SHARE * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                   err_msg=v.name)


def test_model_average_apply_and_restore():
    r = _run_both(average=True)
    np.testing.assert_allclose(r["got"], r["want"], rtol=1e-5, atol=0)
    params = [p.name for p in r["tmain"].global_block().all_parameters()]
    trained = {n: r["scope"].find_var(n).clone() for n in params}
    sums = {}
    for p, s, na, ona in r["tma"]._params:
        cnt = int(r["scope"].find_var(na.name)[0]) + \
            int(r["scope"].find_var(ona.name)[0])
        sums[p.name] = (sum(r["scope"].find_var(v.name).double()
                            for v in s) / max(cnt, 1)).float()
        assert cnt in (2, 3, 4), cnt
    with r["jma"].apply(r["jexe"], r["jscope"]):
        javg = {n: np.asarray(r["jscope"].find_var(n)) for n in params}
    with r["tma"].apply(r["exe"], r["scope"]):
        for n in params:
            got = r["scope"].find_var(n)
            assert got.dtype == torch.float32
            torch.testing.assert_close(got, sums[n], rtol=0, atol=0)
            np.testing.assert_allclose(got.numpy(), javg[n], atol=1e-4,
                                       rtol=0, err_msg=n)
        # the averaged params run (an eval step on the same scope)
        r["exe"].run(r["tmain"], feed=_feeds(1, seed=9)[0],
                     fetch_list=[], scope=r["scope"])
    for n in params:
        assert not torch.equal(r["scope"].find_var(n), sums[n])
    # the eval step above trained; a second apply/restore pair restores
    # exactly what it found
    before = {n: r["scope"].find_var(n).clone() for n in params}
    with r["tma"].apply(r["exe"], r["scope"]):
        pass
    for n in params:
        torch.testing.assert_close(r["scope"].find_var(n), before[n],
                                   rtol=0, atol=0)
    assert trained  # the first restore put back trained tensors' values


def test_amp_policy_of_the_new_ops():
    for t in NEW_OPS:
        assert tamp.policy_for(t) == jamp.policy_for(t), t
    ins, attrs = _case("lamb", beta1=0.9, beta2=0.999, epsilon=1e-6,
                       weight_decay=0.01)
    t_ins = {k: [torch.from_numpy(np.array(v)) for v in vs]
             for k, vs in ins.items()}
    t_ins["Grad"] = [t_ins["Grad"][0].to(torch.bfloat16)]
    cast = tamp.amp_cast("lamb", {}, t_ins)
    assert cast["Grad"][0].dtype == torch.float32
    assert cast["Param"][0] is t_ins["Param"][0]


def test_lamb_under_amp_keeps_f32_state():
    r = _run_both("lamb", amp=True)
    np.testing.assert_allclose(r["got"], r["want"], rtol=1e-2)
    for v in r["tmain"].list_vars():
        if v.persistable and v.dtype == "float32":
            assert r["scope"].find_var(v.name).dtype == torch.float32, \
                v.name
