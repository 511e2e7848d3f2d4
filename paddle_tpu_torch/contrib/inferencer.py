"""High-level Inferencer (reference: python/paddle/fluid/contrib/
inferencer.py:31): rebuild the inference program from infer_func, load
params from a Trainer.save_params directory, and run feeds."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["Inferencer"]


class Inferencer:
    def __init__(self, infer_func: Callable, param_path: str, place=None,
                 parallel: bool = False):
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.core.scope import Scope

        self.scope = Scope()
        self.program = fluid.Program()
        startup = fluid.Program()
        from paddle_tpu_torch.core.program import unique_name

        with fluid.program_guard(self.program, startup), unique_name.guard():
            out = infer_func()
            self.fetch = list(out) if isinstance(out, (list, tuple)) else [out]
        self.exe = fluid.Executor(place)
        self.exe.run(startup, scope=self.scope)
        fluid.io.load_params(self.exe, param_path,
                             main_program=self.program, scope=self.scope)
        self.program = self.program.clone(for_test=True)

    def infer(self, inputs: dict, return_numpy: bool = True):
        results = self.exe.run(self.program,
                               feed={k: np.asarray(v)
                                     for k, v in inputs.items()},
                               fetch_list=[v.name for v in self.fetch],
                               scope=self.scope,
                               return_numpy=return_numpy)
        return results
