"""fluid.transpiler namespace (reference python/paddle/fluid/transpiler/).

DistributeTranspiler lives in paddle_tpu_torch.distributed.transpiler;
the memory-optimization transpiler of the reference
(memory_optimization_transpiler.py) is subsumed by the executor's release
schedule (a temporary leaves the step after its last reader) and state
updated in place. The port's copy of paddle_tpu/transpiler/__init__.py.
"""

from ..distributed.transpiler import (  # noqa: F401
    DistributeTranspiler,
    DistributeTranspilerConfig,
    HashName,
    RoundRobin,
)


def memory_optimize(input_program=None, skip_opt_set=None, print_log=False,
                    level=0):
    """No-op: liveness-based var reuse (reference
    memory_optimization_transpiler.py) is handled by the executor's
    release schedule; the grouped optimizer updates write state in
    place."""
    return input_program


def release_memory(input_program=None, skip_opt_set=None):
    return input_program


class InferenceTranspiler:
    """Inference program rewrite (reference transpiler/
    inference_transpiler.py): the reference folds conv+bn / conv+eltwise
    and relu-fuses for cuDNN/MKL-DNN; here the surviving job is the
    train->test rewrite — flip every train-mode op (dropout, batch_norm,
    quant ops) to is_test via the ir is_test_pass."""

    def transpile(self, program, place=None, scope=None):
        from ..core.ir import Graph, get_pass

        graph = Graph(program)
        get_pass("is_test_pass").apply(graph)
        graph.materialize()
        program._bump()
        return program
