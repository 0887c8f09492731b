"""Plan loading: rebuild (order, slicing bonds, tree) from the JSON plans
that ``artensor_tpu.plan_io.save_plan`` writes (port of ``plan_from_dict`` /
``load_plan``; the format's version 1)."""

import json

from .network import AbstractTensorNetwork
from .planner import ContractionTree

PLAN_VERSION = 1


def plan_from_dict(d):
    """Rebuild (order, slicing_bonds, ContractionTree) from a plan dict."""
    if d["version"] != PLAN_VERSION:
        raise ValueError(f"unsupported plan version {d['version']}")
    tn = AbstractTensorNetwork(
        {int(t): list(bs) for t, bs in d["tensor_bonds"].items()},
        dict(d["bond_dims"]),
        d["final_qubits"],
        d["max_bitstring"],
    )
    for bond in d["slicing_bonds"]:
        tn.slicing(bond)
    order = [tuple(p) for p in d["order"]]
    return order, list(d["slicing_bonds"]), ContractionTree(tn, order)


def load_plan(path):
    with open(path) as f:
        return plan_from_dict(json.load(f))
