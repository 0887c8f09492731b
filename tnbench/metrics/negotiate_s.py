"""negotiate_s: host seconds of the program's ``scheme.negotiate`` span
(producer-order negotiation, its trial compiles included) under its first
``load_plan`` span, the harness's plan load; read on a card
(``progtrace.setup_seconds``)."""

from tnbench.progtrace import setup_seconds


def read(run):
    return setup_seconds(run, "load_plan", {"scheme.negotiate"})
