"""amps_per_s: every amplitude the window's batches delivered (a state
batch is all 2^n of them), over the window's seconds, host clock."""


def read(run):
    if not run.times:
        return None
    return len(run.times) * run.amps_per_batch / run.window_s
