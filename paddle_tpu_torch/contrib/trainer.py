"""High-level Trainer API (reference: python/paddle/fluid/contrib/
trainer.py:169 — the book-test training loop wrapper, moved to contrib
in v1.3).

Compact version: train_func builds the loss program,
optimizer_func supplies the optimizer; train() drives epochs over a
reader with Begin/End Epoch/Step events, test() evaluates on a reader,
save_params/save_inference_model export. The executor runs on the card
unless ``place`` is ``CPUPlace()``; ``parallel=True`` trains through
``CompiledProgram(...).with_data_parallel``, the mesh engine over the
place's positions (parallel/engine.py).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

__all__ = ["BeginEpochEvent", "EndEpochEvent", "BeginStepEvent",
           "EndStepEvent", "Trainer"]


class BeginEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id, step_id, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class Trainer:
    """reference contrib/trainer.py:169.

        def train_func():            # build forward + loss, return [loss]
        def optimizer_func():        # return fluid.optimizer.*
        t = Trainer(train_func, optimizer_func, place=...)
        t.train(num_epochs, event_handler, reader, feed_order)
    """

    def __init__(self, train_func: Callable, optimizer_func: Callable,
                 param_path: Optional[str] = None, place=None,
                 parallel: bool = False, checkpoint_config=None):
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.core.scope import Scope

        self.place = place
        self.parallel = parallel
        self.scope = Scope()
        self.train_program = fluid.Program()
        self.startup_program = fluid.Program()
        from paddle_tpu_torch.core.program import unique_name

        with fluid.program_guard(self.train_program, self.startup_program), \
                unique_name.guard():
            outs = train_func()
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            self.train_outputs = list(outs)
            self.loss = self.train_outputs[0]
            optimizer = optimizer_func()
            optimizer.minimize(self.loss)
        self.test_program = self.train_program.clone(for_test=True)
        self.exe = fluid.Executor(place)
        self.exe.run(self.startup_program, scope=self.scope)
        if param_path:
            fluid.io.load_params(self.exe, param_path,
                                 main_program=self.train_program,
                                 scope=self.scope)
        self._compiled = None
        if parallel:
            self._compiled = fluid.CompiledProgram(
                self.train_program).with_data_parallel(
                    loss_name=self.loss.name)

    # ---------------------------------------------------------------- train
    def _feed_dict(self, data, feed_order):
        feed = {}
        for i, name in enumerate(feed_order):
            col = [np.asarray(row[i]) for row in data]
            feed[name] = np.stack(col).astype(
                self.train_program.global_block().var(name).dtype)
        return feed

    def train(self, num_epochs: int, event_handler: Callable,
              reader: Callable, feed_order: List[str]):
        program = self._compiled or self.train_program
        for epoch in range(num_epochs):
            event_handler(BeginEpochEvent(epoch))
            for step, data in enumerate(reader()):
                begin = BeginStepEvent(epoch, step)
                event_handler(begin)
                fetch = ([v.name for v in self.train_outputs]
                         if begin.fetch_metrics else [])
                metrics = self.exe.run(
                    program, feed=self._feed_dict(data, feed_order),
                    fetch_list=fetch, scope=self.scope)
                event_handler(EndStepEvent(epoch, step, metrics))
                if getattr(self, "_stopped", False):
                    return
            event_handler(EndEpochEvent(epoch))

    def test(self, reader: Callable, feed_order: List[str]):
        """Mean metrics of the test-mode program over the reader."""
        totals = None
        count = 0
        for data in reader():
            vals = self.exe.run(
                self.test_program, feed=self._feed_dict(data, feed_order),
                fetch_list=[v.name for v in self.train_outputs],
                scope=self.scope)
            vals = [float(np.asarray(v).reshape(-1)[0]) for v in vals]
            totals = vals if totals is None else [
                a + b for a, b in zip(totals, vals)]
            count += 1
        return [t / max(count, 1) for t in (totals or [])]

    def stop(self):
        self._stopped = True

    # ----------------------------------------------------------------- save
    def save_params(self, param_path: str):
        import paddle_tpu_torch as fluid

        fluid.io.save_params(self.exe, param_path,
                             main_program=self.train_program,
                             scope=self.scope)

    def save_inference_model(self, param_path: str, feeded_var_names,
                             target_var_indexes):
        import paddle_tpu_torch as fluid

        targets = [self.train_outputs[i] for i in target_var_indexes]
        fluid.io.save_inference_model(param_path, feeded_var_names,
                                      targets, self.exe,
                                      main_program=self.train_program)
