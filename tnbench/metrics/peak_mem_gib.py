"""peak_mem_gib: ``torch.cuda.max_memory_allocated`` from the process's
start to the window's end: the staged tensors, the eager warm-up group
and the graphs' pool as captured, the outputs a batch holds.  (Under
graph replay the window itself allocates almost nothing: the pool's
blocks were taken at capture.)"""


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 2 ** 30
