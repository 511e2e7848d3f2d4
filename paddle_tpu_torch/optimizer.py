"""Optimizer family (reference: python/paddle/fluid/optimizer.py:44 —
SGD:411, Momentum:458, LarsMomentum:543, Adagrad:629, Adam:718, Adamax:878,
DecayedAdagrad:1011, Adadelta:1096, RMSProp:1193, Ftrl:1343).

A copy of paddle_tpu/optimizer.py. minimize = append_backward +
clip/regularize + per-param optimizer ops, all in the same Program; the
port's executor runs forward, backward and updates eagerly in one
``Executor.run``, and the updates write new tensors (no in-place update
of scope state). The port lowers ``adam``, ``sgd`` and ``momentum``;
any other optimizer builds its Program and raises "no registered
lowering" when it runs."""

from __future__ import annotations

from typing import List, Optional, Tuple

from .core.backward import append_backward
from .clip import append_gradient_clip_ops
from .core.program import (
    Parameter,
    Variable,
    default_main_program,
    default_startup_program,
    program_guard,
    unique_name,
)
from .initializer import Constant
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = [
    "Optimizer",
    "SGD",
    "SGDOptimizer",
    "Momentum",
    "MomentumOptimizer",
    "LarsMomentum",
    "LarsMomentumOptimizer",
    "Adagrad",
    "AdagradOptimizer",
    "Adam",
    "AdamOptimizer",
    "AdamW",
    "Adamax",
    "AdamaxOptimizer",
    "DecayedAdagrad",
    "DecayedAdagradOptimizer",
    "Adadelta",
    "AdadeltaOptimizer",
    "RMSProp",
    "RMSPropOptimizer",
    "Ftrl",
    "FtrlOptimizer",
    "Lamb",
    "LambOptimizer",
    "ModelAverage",
    "RecomputeOptimizer",
]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._lr = learning_rate
        self.regularization = regularization
        self._name = name
        self._lr_var: Optional[Variable] = None
        self._accumulators = {}  # (acc_name, param_name) -> Variable

    # ------------------------------------------------------------ lr var
    def _create_lr_var(self):
        if isinstance(self._lr, Variable):
            self._lr_var = self._lr
            return
        if self._lr_var is None:
            helper = LayerHelper(self._name or "optimizer")
            self._lr_var = helper.create_global_variable(
                name=unique_name.generate("learning_rate"),
                shape=[1],
                dtype="float32",
                initializer=Constant(float(self._lr)),
            )

    @property
    def learning_rate(self):
        return self._lr_var

    # ------------------------------------------------------ accumulators
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None, dtype=None):
        key = (name, param.name)
        if key in self._accumulators:
            return self._accumulators[key]
        helper = LayerHelper(self._name or "optimizer")
        v = helper.create_global_variable(
            name=unique_name.generate("%s_%s" % (param.name, name)),
            shape=shape if shape is not None else param.shape,
            dtype=dtype or param.dtype,
            initializer=Constant(fill_value),
        )
        # record the slot ON the program: ZeRO-1 (ShardingRules zero1)
        # shards exactly these names — never a name-heuristic that
        # could collide with a user parameter called '*_moment_0'
        prog = helper.main_program
        slots = getattr(prog, "_optimizer_slots", None)
        if slots is None:
            slots = prog._optimizer_slots = set()
        slots.add(v.name)
        self._accumulators[key] = v
        return v

    def _get_accumulator(self, name, param):
        return self._accumulators[(name, param.name)]

    # ----------------------------------------------------------- backward
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads) -> List:
        # everything appended here (clip chains, regularizers, lr plumbing,
        # update ops) is update logic: tag it so the gradient-accumulation
        # partition (core/executor._accum_step) runs it once per applied
        # step, after the microbatch scan
        prog = default_main_program()
        with prog.op_role_guard("optimize"):
            params_grads = append_gradient_clip_ops(params_grads)
            params_grads = append_regularization_ops(
                params_grads, self.regularization)
            self._create_lr_var()
            self._create_accumulators(params_grads)
            ops = []
            for p, g in params_grads:
                if g is None:
                    continue
                ops.append(self._append_optimize_op(p, g))
        return ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None) -> Tuple[List, List]:
        main = loss.block.program
        startup = startup_program or default_startup_program()
        with program_guard(main, startup):
            params_grads = self.backward(loss, startup, parameter_list, no_grad_set)
            opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads

    # --------------------------------------------------------- per-flavor
    def _create_accumulators(self, params_grads):
        pass

    def _append_optimize_op(self, param: Parameter, grad: Variable):
        raise NotImplementedError

    def _block(self):
        return default_main_program().global_block()

    def _lr_for(self, param: Parameter):
        # per-param lr multiplier (ParamAttr.learning_rate)
        mult = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0)
        if mult == 1.0:
            return self._lr_var
        helper = LayerHelper("lr_scaled")
        out = helper.create_variable_for_type_inference("float32", stop_gradient=True)
        self._block().append_op("scale", {"X": [self._lr_var]}, {"Out": [out]},
                                {"scale": float(mult), "__op_role__": "optimize"})
        return out


class SGD(Optimizer):
    def __init__(self, learning_rate, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name or "sgd")

    def _append_optimize_op(self, param, grad):
        return self._block().append_op(
            "sgd",
            {"Param": [param], "Grad": [grad], "LearningRate": [self._lr_for(param)]},
            {"ParamOut": [param]},
            {"__op_role__": "optimize"},
        )


class Momentum(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name or "momentum")
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, params_grads):
        for p, _ in params_grads:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, param, grad):
        v = self._get_accumulator("velocity", param)
        return self._block().append_op(
            "momentum",
            {"Param": [param], "Grad": [grad], "Velocity": [v],
             "LearningRate": [self._lr_for(param)]},
            {"ParamOut": [param], "VelocityOut": [v]},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov,
             "__op_role__": "optimize"},
        )


class LarsMomentum(Optimizer):
    def __init__(self, learning_rate, momentum, lars_coeff=1e-3,
                 lars_weight_decay=5e-4, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name or "lars")
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, params_grads):
        for p, _ in params_grads:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, param, grad):
        v = self._get_accumulator("velocity", param)
        return self._block().append_op(
            "lars_momentum",
            {"Param": [param], "Grad": [grad], "Velocity": [v],
             "LearningRate": [self._lr_for(param)]},
            {"ParamOut": [param], "VelocityOut": [v]},
            {"mu": self._momentum, "lars_coeff": self._lars_coeff,
             "lars_weight_decay": self._lars_weight_decay,
             "__op_role__": "optimize"},
        )


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, regularization=None,
                 name=None, initial_accumulator_value=0.0):
        super().__init__(learning_rate, regularization, name or "adagrad")
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _create_accumulators(self, params_grads):
        for p, _ in params_grads:
            self._add_accumulator("moment", p, fill_value=self._init_acc)

    def _append_optimize_op(self, param, grad):
        m = self._get_accumulator("moment", param)
        return self._block().append_op(
            "adagrad",
            {"Param": [param], "Grad": [grad], "Moment": [m],
             "LearningRate": [self._lr_for(param)]},
            {"ParamOut": [param], "MomentOut": [m]},
            {"epsilon": self._epsilon, "__op_role__": "optimize"},
        )


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 regularization=None, name=None, lazy_mode=False):
        super().__init__(learning_rate, regularization, name or "adam")
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, params_grads):
        for p, _ in params_grads:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, fill_value=1.0, shape=[1])
            self._add_accumulator("beta2_pow", p, fill_value=1.0, shape=[1])

    def _append_optimize_op(self, param, grad):
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow", param)
        b2p = self._get_accumulator("beta2_pow", param)
        return self._block().append_op(
            "adam",
            {"Param": [param], "Grad": [grad], "Moment1": [m1], "Moment2": [m2],
             "Beta1Pow": [b1p], "Beta2Pow": [b2p],
             "LearningRate": [self._lr_for(param)]},
            {"ParamOut": [param], "Moment1Out": [m1], "Moment2Out": [m2],
             "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]},
            {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon,
             **self._extra_adam_attrs(param),
             "__op_role__": "optimize"},
        )

    def _extra_adam_attrs(self, param):
        return {}


class AdamW(Adam):
    """Adam with DECOUPLED weight decay (Loshchilov & Hutter) — the
    decay term `lr * weight_decay * param` applies outside the moment
    math, never through the gradients (L2 regularization via
    `regularization=` flows through the moments; that is a different
    optimizer). Beyond reference: Fluid v1.3 predates AdamW; the
    signature follows modern Paddle's `paddle.optimizer.AdamW`
    (`apply_decay_param_fun(name) -> bool` selects decayed params —
    return False for biases / layer norms)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01,
                 apply_decay_param_fun=None, regularization=None,
                 name=None, lazy_mode=False):
        super().__init__(learning_rate, beta1, beta2, epsilon,
                         regularization, name or "adamw", lazy_mode)
        self._weight_decay = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _extra_adam_attrs(self, param):
        decay = self._weight_decay
        if self._apply_decay_param_fun is not None \
                and not self._apply_decay_param_fun(param.name):
            decay = 0.0
        return {"weight_decay": decay}


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name or "adamax")
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, params_grads):
        for p, _ in params_grads:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow", p, fill_value=self._beta1, shape=[1])

    def _append_optimize_op(self, param, grad):
        m = self._get_accumulator("moment", param)
        inf = self._get_accumulator("inf_norm", param)
        b1p = self._get_accumulator("beta1_pow", param)
        op = self._block().append_op(
            "adamax",
            {"Param": [param], "Grad": [grad], "Moment": [m], "InfNorm": [inf],
             "Beta1Pow": [b1p], "LearningRate": [self._lr_for(param)]},
            {"ParamOut": [param], "MomentOut": [m], "InfNormOut": [inf]},
            {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon,
             "__op_role__": "optimize"},
        )
        # beta1_pow *= beta1 each step (reference appends a scale op)
        self._block().append_op("scale", {"X": [b1p]}, {"Out": [b1p]},
                                {"scale": self._beta1, "__op_role__": "optimize"})
        return op


class DecayedAdagrad(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name or "decayed_adagrad")
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, params_grads):
        for p, _ in params_grads:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, param, grad):
        m = self._get_accumulator("moment", param)
        return self._block().append_op(
            "decayed_adagrad",
            {"Param": [param], "Grad": [grad], "Moment": [m],
             "LearningRate": [self._lr_for(param)]},
            {"ParamOut": [param], "MomentOut": [m]},
            {"decay": self._decay, "epsilon": self._epsilon,
             "__op_role__": "optimize"},
        )


class Adadelta(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name or "adadelta")
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, params_grads):
        for p, _ in params_grads:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, param, grad):
        g2 = self._get_accumulator("avg_squared_grad", param)
        u2 = self._get_accumulator("avg_squared_update", param)
        return self._block().append_op(
            "adadelta",
            {"Param": [param], "Grad": [grad], "AvgSquaredGrad": [g2],
             "AvgSquaredUpdate": [u2]},
            {"ParamOut": [param], "AvgSquaredGradOut": [g2],
             "AvgSquaredUpdateOut": [u2]},
            {"epsilon": self._epsilon, "rho": self._rho, "__op_role__": "optimize"},
        )


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name or "rmsprop")
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, params_grads):
        for p, _ in params_grads:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("moment", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, param, grad):
        ms = self._get_accumulator("mean_square", param)
        mom = self._get_accumulator("moment", param)
        mg = self._get_accumulator("mean_grad", param)
        return self._block().append_op(
            "rmsprop",
            {"Param": [param], "Grad": [grad], "MeanSquare": [ms], "Moment": [mom],
             "MeanGrad": [mg], "LearningRate": [self._lr_for(param)]},
            {"ParamOut": [param], "MeanSquareOut": [ms], "MomentOut": [mom],
             "MeanGradOut": [mg]},
            {"decay": self._rho, "epsilon": self._epsilon,
             "momentum": self._momentum, "centered": self._centered,
             "__op_role__": "optimize"},
        )


class Ftrl(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name or "ftrl")
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, params_grads):
        for p, _ in params_grads:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, param, grad):
        sq = self._get_accumulator("squared", param)
        lin = self._get_accumulator("linear", param)
        return self._block().append_op(
            "ftrl",
            {"Param": [param], "Grad": [grad], "SquaredAccumulator": [sq],
             "LinearAccumulator": [lin], "LearningRate": [self._lr_for(param)]},
            {"ParamOut": [param], "SquaredAccumOut": [sq], "LinearAccumOut": [lin]},
            {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power,
             "__op_role__": "optimize"},
        )


class Lamb(Optimizer):
    """LAMB (TPU-scale extension; not in the reference — backs the BERT
    large-batch baseline)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name or "lamb")
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, params_grads):
        for p, _ in params_grads:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, fill_value=1.0, shape=[1])
            self._add_accumulator("beta2_pow", p, fill_value=1.0, shape=[1])

    def _append_optimize_op(self, param, grad):
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow", param)
        b2p = self._get_accumulator("beta2_pow", param)
        return self._block().append_op(
            "lamb",
            {"Param": [param], "Grad": [grad], "Moment1": [m1], "Moment2": [m2],
             "Beta1Pow": [b1p], "Beta2Pow": [b2p],
             "LearningRate": [self._lr_for(param)]},
            {"ParamOut": [param], "Moment1Out": [m1], "Moment2Out": [m2],
             "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]},
            {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon,
             "weight_decay": self._wd, "__op_role__": "optimize"},
        )


SGDOptimizer = SGD
MomentumOptimizer = Momentum
LarsMomentumOptimizer = LarsMomentum
AdagradOptimizer = Adagrad
AdamOptimizer = Adam
AdamaxOptimizer = Adamax
DecayedAdagradOptimizer = DecayedAdagrad
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
FtrlOptimizer = Ftrl
LambOptimizer = Lamb


class ModelAverage:
    """Windowed running average of parameters, swapped in for evaluation
    (reference optimizer.py ModelAverage:1485 + average_accumulates_op.h:
    per param sum_1/sum_2/sum_3 and num/old_num/num_updates accumulators;
    when the accumulate count passes min(max_average_window,
    num_updates*average_window_rate) the sums roll into sum_3 and the
    count restarts, so apply() replaces each param with
    (sum_1+sum_2+sum_3)/(num_accumulates+old_num_accumulates) — the mean
    over roughly the trailing window, not the whole history).

    Usage (reference contract):
        opt.minimize(loss)
        model_average = ModelAverage(0.15)      # after minimize
        ... train ...
        with model_average.apply(exe, scope):   # eval with averaged params
            ... run test program ...
    """

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        from .core.program import default_main_program
        from .layer_helper import LayerHelper

        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self._params = []
        helper = LayerHelper(name or "model_average")
        block = default_main_program().global_block()
        for p in block.all_parameters():
            if not p.trainable or getattr(p, "do_model_average", True) is False:
                continue
            sums = [helper.create_global_variable(
                name=unique_name.generate("%s_sum_%d" % (p.name, i)),
                shape=p.shape, dtype="float32", initializer=Constant(0.0))
                for i in (1, 2, 3)]
            counters = [helper.create_global_variable(
                name=unique_name.generate(p.name + "_" + nm), shape=[1],
                dtype="int64", initializer=Constant(0.0))
                for nm in ("numacc", "old_numacc", "num_updates")]
            na, ona, nu = counters
            block.append_op(
                "average_accumulates",
                {"param": [p], "in_sum_1": [sums[0]], "in_sum_2": [sums[1]],
                 "in_sum_3": [sums[2]], "in_num_accumulates": [na],
                 "in_old_num_accumulates": [ona], "in_num_updates": [nu]},
                {"out_sum_1": [sums[0]], "out_sum_2": [sums[1]],
                 "out_sum_3": [sums[2]], "out_num_accumulates": [na],
                 "out_old_num_accumulates": [ona], "out_num_updates": [nu]},
                {"average_window": float(average_window_rate),
                 "min_average_window": int(min_average_window),
                 "max_average_window": int(max_average_window),
                 "__op_role__": "optimize"})
            self._params.append((p, sums, na, ona))
        default_main_program()._bump()

    def _swap(self, scope):
        import torch

        self._saved = {}
        for p, sums, na, ona in self._params:
            value = scope.find_var(p.name)
            # a replayed step updates the scope's tensor in place, and a
            # replaced one is copied into it: keep the values, not the
            # tensor
            self._saved[p.name] = value.clone()
            cnt = (scope.find_var(na.name).to(torch.float64)
                   + scope.find_var(ona.name).to(torch.float64))[0]
            total = sum(scope.find_var(s.name).to(torch.float64)
                        for s in sums)
            avg = total / torch.clamp(cnt, min=1.0)
            scope.set_var(p.name, avg.to(value.dtype))

    def restore(self, executor=None, scope=None):
        from .core.scope import global_scope

        scope = scope or global_scope()
        for p, *_ in self._params:
            scope.set_var(p.name, self._saved[p.name])
        self._saved = {}

    def apply(self, executor=None, scope=None, need_restore=True):
        """Context manager: params hold their averaged values inside."""
        import contextlib

        from .core.scope import global_scope

        scope = scope or global_scope()

        @contextlib.contextmanager
        def _ctx():
            self._swap(scope)
            try:
                yield
            finally:
                if need_restore:
                    self.restore(executor, scope)

        return _ctx()


class RecomputeOptimizer(Optimizer):
    """Gradient checkpointing wrapper (the later-era fluid
    RecomputeOptimizer API shape: wrap an inner optimizer, name the
    checkpoint vars, minimize). The reference implementation clones
    forward op descs into the backward section; here minimize() runs
    core/recompute.apply_recompute first — forward segments between
    checkpoints move into recompute_block sub-blocks whose grad op
    rematerializes them behind an optimization barrier (see
    ops/recompute_ops.py) — then delegates to the inner optimizer.

        opt = fluid.optimizer.RecomputeOptimizer(
            fluid.optimizer.Adam(1e-3))
        opt._set_checkpoints([h1, h2])
        opt.minimize(loss)
    """

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None
        self._applied_programs = set()  # program serials already rewritten

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = list(checkpoints)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if not self._checkpoints:
            raise RuntimeError(
                "RecomputeOptimizer: call _set_checkpoints([...]) before "
                "minimize/backward")
        program = loss.block.program
        if program._serial not in self._applied_programs:
            from .core.recompute import apply_recompute

            apply_recompute(program, self._checkpoints)
            self._applied_programs.add(program._serial)
        return self._optimizer.backward(loss, startup_program,
                                        parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        main = loss.block.program
        startup = startup_program or default_startup_program()
        with program_guard(main, startup):
            params_grads = self.backward(loss, startup, parameter_list,
                                         no_grad_set)
            opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads
