"""dot_copy_ms: device ms a batch of PyTorch's copy and permute kernels
(``devtrace.COPIES``) inside dot-fallback steps (the operand permutes
around the matrix products), each replayed kernel put down to its step by
the eager step map (``progtrace.py``)."""

from tnbench.progtrace import read as progtrace


def read(run):
    return progtrace(run, "dot_copy_ms")
