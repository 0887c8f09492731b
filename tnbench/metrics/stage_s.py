"""stage_s: host seconds of the program's ``prepare.fold`` (static steps
folded on the host) and ``prepare.stage`` (tensors staged on the card)
spans under its first ``prepare`` span, the harness's; read on a card
(``progtrace.setup_seconds``)."""

from tnbench.progtrace import setup_seconds


def read(run):
    return setup_seconds(run, "prepare", {"prepare.fold", "prepare.stage"})
