"""copy_ms: device ms a batch of PyTorch's copy and permute kernels (the
operand reorders around the steps and the dot fallback), from the
profiled window (``trace.COPIES``)."""

from tnbench.devtrace import COPIES, per_batch_ms


def read(run):
    return per_batch_ms(run.trace, COPIES)
