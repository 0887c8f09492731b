"""Fixtures of the benchmark's tests: a small checkout of the harness (its
code, BENCHMARK.json with three small cells, their plans) that a run can
drive on the CPU, and the card check of the tests marked ``gpu``.  The
third cell, "small-share", runs a circuit on a list of grid sites, one
share of its plan's slices a batch, against the network reference."""

import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

SMALL_CIRCUIT = {"generator": "random_circuit", "rows": 3, "cols": 4,
                 "cycles": 8, "sequence": "ABCDCDAB", "theta": 1.5,
                 "phi": 0.5}
# the 3 x 4 grid less the site (1, 2): 11 qubits
SITE_CIRCUIT = dict(SMALL_CIRCUIT, sites=[
    [r, c] for r in range(3) for c in range(4) if (r, c) != (1, 2)])
# name: (requests, bitstrings, sc_target of the plan, circuit)
SMALL = {"small-sparse": ("amplitudes", 64, 9, SMALL_CIRCUIT),
         "small-dense": ("state", 0, 12, SMALL_CIRCUIT),
         "small-share": ("amplitudes", 16, 6, SITE_CIRCUIT)}
SMALL_LIMITS = {"err_l2": 1e-5, "err_max": 1e-4}


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


@pytest.fixture(scope="session")
def mini(tmp_path_factory):
    """Root of a small checkout: ``tnbench/`` copied, and BENCHMARK.json
    naming the three small cells (every metric reported in each).  The
    share cell's plan has 16 slices, and a batch sums ids 4 to 11 of them,
    compared at all 16 of its bitstrings (fewer than
    ``traffic.REFERENCE_SAMPLES``)."""
    from artensor_tpu_torch import PlannerConfig, TensorNetworkSimulation
    from artensor_tpu_torch.plan_io import save_plan
    from tnbench import traffic

    root = tmp_path_factory.mktemp("mini")
    here = root / "tnbench"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "rcs_n30_*.json"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"], bench["workloads"] = [], []
    for name, (requests, nbits, sc, circuit) in SMALL.items():
        conf = {"name": name, "circuit": circuit, "dtype": "complex64",
                "precision": "highest"}
        traf = {"name": name, "requests": requests, "bitstrings": nbits,
                "bitstring_seed": 0, "plan": f"{name}-plan.json",
                "loop": "closed", "callers": 1, "state_samples": 256}
        n, layers = traffic.circuit(conf, 0)
        sim = TensorNetworkSimulation.from_circuit(
            (n, layers), traffic.bitstrings(traf, n))
        sim.prepare_contraction(PlannerConfig(sc_target=sc, trials=1,
                                              iters=5, parallel=False))
        save_plan(here / "configs" / f"{name}-plan.json", sim.ctree,
                  meta={"sc_target": sc})
        if name == "small-share":
            assert len(sim.slicing_bonds) == 4, sim.slicing_bonds
            conf["reference"] = "network"
            traf.update(share={"first": 4, "slices": 8})
        _dump(conf, here / "configs" / f"{name}.json")
        _dump(traf, here / "traffic" / f"{name}.json")
        _dump({"name": name, "limits": SMALL_LIMITS},
              here / "workloads" / f"{name}.json")
        bench["configs"].append({"name": name,
                                 "file": f"tnbench/configs/{name}.json"})
        bench["workloads"].append({"name": name, "config": name,
                                   "traffic": name, "chips": 1})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    _dump(bench, root / "BENCHMARK.json")
    return root


@pytest.fixture
def card():
    """Skips a test without a CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
