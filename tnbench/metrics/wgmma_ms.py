"""wgmma_ms: device ms a batch of the kernels on the tensor-core core
(``csrc/wgmma_core.cuh``: Pair, GK's and GGK's mma form, the complex
matmul), from the profiled window (``trace.WGMMA``)."""

from tnbench.devtrace import WGMMA, per_batch_ms


def read(run):
    return per_batch_ms(run.trace, WGMMA)
