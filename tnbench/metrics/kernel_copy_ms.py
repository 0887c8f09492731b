"""kernel_copy_ms: device ms a batch of PyTorch's copy and permute
kernels (``devtrace.COPIES``) inside kernel steps (GK's reorders, Pair's
input reorders and row gathers), each replayed kernel put down to its
step by the eager step map (``progtrace.py``)."""

from tnbench.progtrace import read as progtrace


def read(run):
    return progtrace(run, "kernel_copy_ms")
