"""scheme_s: host seconds of ``TensorNetworkSimulation.load_plan`` (plan
load, scheme compile, fusion and negotiation), a span the harness takes
around the call."""


def read(run):
    return run.scheme_s
