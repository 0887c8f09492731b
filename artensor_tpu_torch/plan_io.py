"""Plan serialisation: (order, slicing bonds, network) as JSON, in the
format ``artensor_tpu.plan_io`` writes and reads (version 1).  Port of
``plan_to_dict`` / ``save_plan`` / ``plan_from_dict`` / ``load_plan``: a
plan either package saves, the other loads."""

import json

from .network import AbstractTensorNetwork
from .planner import ContractionTree

PLAN_VERSION = 1


def plan_to_dict(ctree, meta=None):
    """Serialise a planner ContractionTree (with its sliced network).  The
    network is written unsliced, each sliced bond appended to the bond list
    of every tensor it touches, as the JAX package writes it."""
    tn = ctree.tn
    tc, sc, mc = ctree.complexity()
    unsliced_bonds = {t: list(bs) for t, bs in tn.tensor_bonds.items()}
    dims = dict(tn.bond_dims)
    for bond, (dim, touching, _after) in tn.sliced.items():
        dims[bond] = dim
        for tid in touching:
            unsliced_bonds[tid].append(bond)
    return {
        "version": PLAN_VERSION,
        "order": [list(p) for p in ctree.to_order_bfs()],
        "slicing_bonds": list(tn.sliced.keys()),
        "tensor_bonds": {str(t): [str(b) for b in bs]
                         for t, bs in unsliced_bonds.items()},
        "bond_dims": {str(b): d for b, d in dims.items()},
        "final_qubits": list(tn.final_qubits),  # qubit-indexed order
        "max_bitstring": tn.max_bitstring,
        "complexity": {"tc": tc, "sc": sc, "mc": mc},
        "meta": meta or {},
    }


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


def save_plan(path, ctree, meta=None):
    with open(path, "w") as f:
        json.dump(plan_to_dict(ctree, meta), f)


def load_plan(path):
    with open(path) as f:
        return plan_from_dict(json.load(f))
