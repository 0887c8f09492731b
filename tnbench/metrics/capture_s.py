"""capture_s: the graph runner's own ``stats["capture_s"]``: the eager
warm-up group and the CUDA-graph capture of the cell's width."""


def read(run):
    if run.device != "cuda":
        return None
    return run.capture_s
