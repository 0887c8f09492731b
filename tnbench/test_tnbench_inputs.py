"""The benchmark's inputs: the seeded circuits simplify to the network each
frozen plan was made for, the frozen generator equals the program's, its
site lists, the traffic generator's draws and shares, and the four cells'
inputs as they were before sites and shares."""

import hashlib
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


def test_sites_of_the_whole_grid_give_the_grid():
    sites = [[r, c] for r in range(3) for c in range(4)]
    for seed in (0, 9):
        assert random_circuit(3, 4, 8, seed=seed, sites=sites) == \
            random_circuit(3, 4, 8, seed=seed)


def _couplers_by_layer(layers, positions):
    """Each fsim layer's couplers as pairs of grid positions."""
    return [{tuple(sorted(positions[q] for q in qs)) for g, qs, _ in layer}
            for layer in layers if layer[0][0] == "fsim"]


@pytest.mark.parametrize("gone", [(0, 0), (1, 2), (2, 3)])
def test_a_site_left_out_drops_its_couplers_alone(gone):
    grid = [(r, c) for r in range(3) for c in range(4)]
    sites = [p for p in grid if p != gone]
    _, full = random_circuit(3, 4, 8)
    n, cut = random_circuit(3, 4, 8, sites=[list(p) for p in sites])
    assert n == 11
    want = [{c for c in layer if gone not in c}
            for layer in _couplers_by_layer(full, grid)]
    assert _couplers_by_layer(cut, sites) == [c for c in want if c]
    assert sum(map(len, want)) < sum(map(len, _couplers_by_layer(full,
                                                                 grid)))


def test_qubits_are_numbered_in_the_order_the_sites_are_listed():
    sites = [[1, 1], [0, 1], [1, 0], [0, 0]]
    n, layers = random_circuit(2, 2, 8, seed=3, sites=sites)
    couplers = {tuple(qs) for layer in layers for g, qs, _ in layer
                if g == "fsim"}
    # A pairs (0,0)-(0,1): qubits 3, 1; C pairs (0,0)-(1,0): qubits 3, 2
    assert {(3, 1), (3, 2), (2, 0), (1, 0)} == couplers
    with pytest.raises(ValueError):
        random_circuit(2, 2, 8, sites=[[0, 0], [0, 0]])
    with pytest.raises(ValueError):
        random_circuit(2, 2, 8, sites=[[0, 0], [2, 0]])


def test_share_ranges_and_widths():
    assert traffic.share({}, 6) is None
    ids = traffic.share({"share": {"first": 16, "slices": 16}}, 6)
    assert ids == range(16, 32)
    for bad in ({"first": 60, "slices": 8}, {"first": -1, "slices": 2},
                {"first": 0, "slices": 0}):
        with pytest.raises(ValueError):
            traffic.share({"share": bad}, 6)
    assert traffic.share_width(64, range(16, 32)) == 16
    assert traffic.share_width(8, range(16, 48)) == 8
    assert traffic.share_width(64, None) == 64
    for width, ids in ((8, range(0, 12)), (64, range(0, 3)),
                       (16, range(4, 28))):
        with pytest.raises(ValueError, match="multiple"):
            traffic.share_width(width, ids)
    assert traffic.slices_run(6, ids) == 24
    assert traffic.amps_per_batch(1000, 6, range(16, 32)) == 250.0


def test_reference_sample_from_the_seed(monkeypatch):
    every = traffic.reference_sample(1000, 7)
    assert np.array_equal(every, np.arange(1000))
    assert np.array_equal(traffic.reference_sample(12, 7), np.arange(12))
    monkeypatch.setattr(traffic, "REFERENCE_SAMPLES", 16)
    a = traffic.reference_sample(1000, 7)
    assert np.array_equal(a, traffic.reference_sample(1000, 7))
    assert not np.array_equal(a, traffic.reference_sample(1000, 8))
    assert len(np.unique(a)) == 16 and np.all(np.diff(a) > 0)
    assert np.array_equal(traffic.reference_sample(16, 7), np.arange(16))


# sha256 (first 16 hex digits) of each cell's circuits at seeds 0 and
# 2**31 + 11 and of its bitstrings, as the harness made them before sites
# and shares
BEFORE = {"sparse-1k": ("3d11a5df698737d0", "fa021cc43046776b"),
          "dense-state": ("3d11a5df698737d0", "4f53cda18c2baa0c"),
          "sparse-10k": ("3d11a5df698737d0", "727c6f6663ec6fb8"),
          "sparse-1k-sc25": ("3d11a5df698737d0", "fa021cc43046776b")}


@pytest.mark.parametrize("name", CELLS)
def test_cells_without_sites_or_share_read_as_before(name):
    cell = manifest.cell(name)
    assert "sites" not in cell.config["circuit"]
    assert "share" not in cell.traffic
    assert cell.config.get("reference", "statevector") == "statevector"
    h = hashlib.sha256()
    for seed in (0, 2 ** 31 + 11):
        h.update(repr(traffic.circuit(cell.config, seed)).encode())
    n = traffic.circuit(cell.config, 0)[0]
    bits = traffic.bitstrings(cell.traffic, n)
    got = (h.hexdigest()[:16],
           hashlib.sha256(repr(bits).encode()).hexdigest()[:16])
    assert got == BEFORE[name]
    with open(cell.plan_path) as f:
        k = len(json.load(f)["slicing_bonds"])
    ids = traffic.share(cell.traffic, k)
    assert ids is None
    assert [traffic.share_width(w, ids) for w in (1, 32, 64, 128)] == \
        [1, 32, 64, 128]
    assert traffic.slices_run(k, ids) == 2 ** k
    n_amps = 2 ** n if cell.traffic["requests"] == "state" else len(bits)
    got = traffic.amps_per_batch(n_amps, k, ids)
    assert got == n_amps and type(got) is int
