"""dot_ms: device ms a batch of the dot fallback's matrix products
(cuBLAS and CUTLASS kernels), from the profiled window (``trace.DOT``)."""

from tnbench.devtrace import DOT, per_batch_ms


def read(run):
    return per_batch_ms(run.trace, DOT)
