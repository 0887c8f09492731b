"""The benchmark's inputs: the seeded circuits simplify to the network each
frozen plan was made for, the frozen generator equals the program's, and
the traffic generator's draws."""

import json
import os

import numpy as np
import pytest

from tnbench import manifest, traffic
from tnbench.circuits import random_circuit

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CELLS = [w["name"] for w in manifest.load()["workloads"]]


def _network(cell, seed):
    from artensor_tpu_torch import TensorNetworkSimulation

    n, layers = traffic.circuit(cell.config, seed)
    sim = TensorNetworkSimulation.from_circuit(
        (n, layers), traffic.bitstrings(cell.traffic, n))
    return sim


@pytest.mark.parametrize("name", CELLS)
def test_seeds_simplify_to_the_plans_network(name):
    cell = manifest.cell(name)
    with open(cell.plan_path) as f:
        plan = json.load(f)
    want = {int(t): sorted(map(str, b))
            for t, b in plan["tensor_bonds"].items()}
    shapes = None
    for seed in range(13):
        sim = _network(cell, seed)
        got = {int(t): sorted(map(str, b))
               for t, b in sim.tensor_bonds.items()}
        assert got == want, seed
        assert [str(q) for q in sim.final_qubits] == \
            [str(q) for q in plan["final_qubits"]]
        these = {t: np.shape(a) for t, a in sim.tensors.items()}
        shapes = shapes or these
        assert these == shapes, seed


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 + 11])
def test_frozen_generator_matches_the_programs(seed):
    from artensor_tpu_torch import random_circuit as program_circuit

    assert random_circuit(5, 6, 14, seed=seed) == \
        program_circuit(5, 6, 14, seed=seed)


def test_seed_draws_single_qubit_gates_only():
    a = random_circuit(5, 6, 14, seed=1)
    b = random_circuit(5, 6, 14, seed=2)
    assert a[0] == b[0] and len(a[1]) == len(b[1])
    shape = lambda c: [[(len(q), q, p) for _, q, p in layer]   # noqa: E731
                       for layer in c[1]]
    assert shape(a) == shape(b)
    assert a != b


def test_bitstrings_fixed_per_cell_and_distinct():
    cell = manifest.cell("sparse-1k")
    bits = traffic.bitstrings(cell.traffic, 30)
    assert bits == traffic.bitstrings(cell.traffic, 30)
    assert len(bits) == len(set(bits)) == 1000
    ids = np.random.default_rng(0).choice(2 ** 30, 1000, replace=False)
    assert bits[0] == np.binary_repr(int(ids[0]), 30)
    with open(os.path.join(ROOT, "artensor_tpu_torch", "data",
                           "rcs_n30_m14_s0_amps1000.txt")) as f:
        fixture = [ln.split()[0] for ln in f if ln.strip()]
    assert bits == fixture


def test_state_sample_and_axis_index():
    t = {"state_samples": 64}
    a = traffic.state_sample(t, 10, 7)
    assert np.array_equal(a, traffic.state_sample(t, 10, 7))
    assert not np.array_equal(a, traffic.state_sample(t, 10, 8))
    assert len(np.unique(a)) == 64
    # a state whose axes hold the qubits in another order
    rng = np.random.default_rng(0)
    psi = rng.normal(size=2 ** 6)
    axes = [3, 0, 5, 1, 4, 2]
    moved = psi.reshape((2,) * 6).transpose(axes).reshape(-1)
    idx = np.arange(2 ** 6)
    assert np.array_equal(moved[traffic.axis_index(idx, axes, 6)], psi)
