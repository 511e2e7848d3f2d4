"""The learning-rate schedules (layers/learning_rate_scheduler.py, a copy,
and its alias learning_rate_decay.py) in the port against the JAX
package, on the CPU.

Each schedule is built by both packages' layers into the same Program;
its rate is fetched over 12 steps, at a relative 1e-5 plus 1e-9 absolute
(the same f32 ops; XLA fuses the chain and rounds a few intermediates
differently, so a rate that decays to 0 reads -1.5e-12 there and 0.0 in
the port). ``append_LARS`` fails in both packages alike. A schedule
drives Adam in an MLP trained by both packages' ``train_loop``
from one transplanted scope (losses to a relative 1e-5, params to atol
1e-4, tests/test_torch_training.py's tolerances), and the port's step
counter is a persistable the scope keeps.

The ops the schedules need (``increment``, the comparisons,
``where_op``) have their parity cases in tests/test_torch_ops.py and
where_op's grad in tests/test_torch_training.py, whose coverage tests
hold every registered op to a case there.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import params_from_jax

CPU = torch.device("cpu")
STEPS = 12

SCHEDULES = {
    "exponential": lambda L: L.exponential_decay(0.1, 5, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(0.1, 5, 0.5,
                                                           staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 5, 0.5),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(0.1, 5, 0.5,
                                                           staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 5, 0.5),
    "inverse_time_staircase": lambda L: L.inverse_time_decay(
        0.1, 5, 0.5, staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 10, 1e-3, power=2.0),
    "piecewise": lambda L: L.piecewise_decay([3, 7], [0.1, 0.05, 0.01]),
    "noam": lambda L: L.noam_decay(64, 4),
    "cosine": lambda L: L.cosine_decay(0.1, 3, 4),
    "linear_warmup": lambda L: L.linear_lr_warmup(0.1, 5, 0.0, 0.1),
    # BERT's: a linear warm-up around a polynomial decay to 0
    "warmup_polynomial": lambda L: L.linear_lr_warmup(
        L.polynomial_decay(1e-4, 10, 0.0, power=1.0), 3, 0.0, 1e-4),
}


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


def _rates(pkg, place, make, steps=STEPS):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        lr = make(pkg.layers)
    exe = pkg.Executor(place)
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    return main, scope, [
        float(np.asarray(exe.run(main, fetch_list=[lr], scope=scope)[0])
              .reshape(-1)[0]) for _ in range(steps)]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    jmain, _, want = _rates(jf, jf.CPUPlace(), SCHEDULES[name])
    tmain, _, got = _rates(pt, pt.CPUPlace(), SCHEDULES[name])
    assert tmain.to_dict() == jmain.to_dict()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    assert len(set(got)) > 1 or name == "piecewise"


def test_learning_rate_decay_is_the_schedules_alias():
    assert pt.learning_rate_decay.noam_decay is pt.layers.noam_decay
    assert set(pt.learning_rate_decay.__all__) == \
        set(pt.layers.learning_rate_scheduler.__all__)
    _, _, a = _rates(pt, pt.CPUPlace(),
                     lambda L: pt.learning_rate_decay.cosine_decay(0.1, 3, 4))
    _, _, b = _rates(pt, pt.CPUPlace(), SCHEDULES["cosine"])
    assert a == b


def test_step_counter_is_a_persistable_in_the_scope():
    main, scope, _ = _rates(pt, pt.CPUPlace(), SCHEDULES["exponential"], 3)
    counter = scope.find_var("@LR_DECAY_COUNTER@")
    assert main.global_block().var("@LR_DECAY_COUNTER@").persistable
    assert counter.dtype == torch.float32
    assert float(counter.reshape(())) == 3.0
    ops = [op.type for op in main.global_block().ops]
    assert ops[0] == "increment"
    assert all(op.attrs.get("__op_role__") == "optimize"
               for op in main.global_block().ops)


def test_append_lars_fails_as_the_jax_packages_does():
    """The JAX package's ``append_LARS`` calls ``layers.nn.sqrt`` and
    ``square``, which its layers/nn.py does not define, so it raises
    AttributeError at build time (ROADMAP §C, a fault of the reference);
    the port's copy keeps its code and fails the same way."""
    def lars(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            w = pkg.layers.data("w", [4, 5], append_batch_size=False)
            g = pkg.layers.data("g", [4, 5], append_batch_size=False)
            lr = pkg.layers.fill_constant([1], "float32", 0.5)
            with pytest.raises(AttributeError) as e:
                pkg.layers.append_LARS([(w, g)], lr, 1e-4)
        return str(e.value).replace("paddle_tpu_torch", "paddle_tpu")

    assert lars(pt) == lars(jf)


def _mlp(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [8])
        y = pkg.layers.data("y", [1])
        h = pkg.layers.fc(x, 16, act="relu")
        loss = pkg.layers.mean(pkg.layers.square(pkg.layers.fc(h, 1) - y))
        lr = SCHEDULES["warmup_polynomial"](pkg.layers)
        pkg.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss, lr


@pytest.mark.parametrize("k", [1, 4])
def test_schedule_drives_adam_like_jax(k):
    rs = np.random.RandomState(0)
    batches = [{"x": rs.randn(16, 8).astype("float32"),
                "y": rs.randn(16, 1).astype("float32")} for _ in range(8)]
    jmain, jstart, jloss, jlr = _mlp(jf)
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    state = {v.name: np.array(jscope.find_var(v.name))
             for v in jmain.list_vars() if v.persistable}
    jseen = []
    jexe.train_loop(jmain, iter(batches), fetch_list=[jloss, jlr],
                    scope=jscope, steps_per_call=k,
                    on_step=lambda i, v: jseen.append(
                        [float(np.asarray(a).reshape(-1)[0]) for a in v]))
    tmain, _, tloss, tlr = _mlp(pt)
    scope = pt.Scope()
    for n, v in params_from_jax(state, tmain, CPU).items():
        scope.set_var(n, v)
    seen = []
    pt.Executor(pt.CPUPlace()).train_loop(
        tmain, iter(batches), fetch_list=[tloss, tlr], scope=scope,
        steps_per_call=k,
        on_step=lambda i, v: seen.append(
            [float(np.asarray(a).reshape(-1)[0]) for a in v]))
    assert len(seen) == len(jseen) == 8 // k
    np.testing.assert_allclose(seen, jseen, rtol=1e-5, atol=1e-9)
    for p in tmain.global_block().all_parameters():
        np.testing.assert_allclose(scope.find_var(p.name).numpy(),
                                   np.asarray(jscope.find_var(p.name)),
                                   atol=1e-4, rtol=0, err_msg=p.name)
    assert float(scope.find_var("@LR_DECAY_COUNTER@").reshape(())) == 16.0
