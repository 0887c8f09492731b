"""runner_idle_ms: device-idle ms a batch in the gaps whose middle lies
inside the program's ``runner.call`` span (the graph runner's call: its
key, ids, reset, replay, clone and synchronize), over graph calls
profiled after the window with the program's tracing on
(``progtrace.py``)."""

from tnbench.progtrace import read as progtrace


def read(run):
    return progtrace(run, "runner_idle_ms")
