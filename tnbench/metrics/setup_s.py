"""setup_s: seconds from the harness's start to the window's: imports,
the kernels' build or load, simplify, plan load and scheme compile,
staging, the graph capture and two batches (``session.Run.setup``)."""


def read(run):
    return run.setup_s
