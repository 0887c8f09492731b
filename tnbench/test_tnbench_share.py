"""One card's share of the slices and the network reference, on the small
cells' plans: the reference against the state vector, its shares against
the whole and against the program's partial sums, a share run's work, and
the refusals."""

import dataclasses
import json

import numpy as np
import pytest

from tnbench import manifest, traffic
from tnbench.reference import network, statevector

SEEDS = (0, 7, 2 ** 31 + 5)


def small(mini, name):
    return manifest.cell(name, root=str(mini), here=str(mini / "tnbench"))


def inputs(mini, name, seed):
    """``(n, layers, plan, bitstrings)`` of a small cell at ``seed``."""
    cell = small(mini, name)
    n, layers = traffic.circuit(cell.config, seed)
    with open(cell.plan_path) as f:
        plan = json.load(f)
    return n, layers, plan, traffic.bitstrings(cell.traffic, n)


def rel(a, r):
    return float(np.linalg.norm(a - r) / np.linalg.norm(r))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["small-sparse", "small-share"])
def test_network_reference_equals_the_state_vector(mini, name, seed):
    n, layers, plan, bits = inputs(mini, name, seed)
    want = statevector.amplitudes(statevector.state_vector(n, layers), bits)
    got = network.amplitudes(n, layers, plan, bits)
    assert rel(got, want) < 1e-12
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


def test_network_reference_slices_further_to_fit(mini, monkeypatch):
    n, layers, plan, bits = inputs(mini, "small-sparse", 3)
    whole = network.amplitudes(n, layers, plan, bits)
    labels = {int(t): list(map(str, b))
              for t, b in plan["tensor_bonds"].items()}
    dims = {b: 2 for ls in labels.values() for b in ls}
    assert not network.extra_slices(labels, plan["order"], dims)
    monkeypatch.setattr(network, "MAX_ELEMS", 2 ** 6)
    assert network.extra_slices(labels, plan["order"], dims)
    monkeypatch.setattr(network, "MAX_ELEMS", 2 ** 8)
    tight = network.amplitudes(n, layers, plan, bits)
    assert rel(tight, whole) < 1e-12


def test_network_reference_refuses_a_plan_of_another_circuit(mini):
    n, layers, plan, bits = inputs(mini, "small-share", 0)
    other = inputs(mini, "small-sparse", 0)[2]
    with pytest.raises(ValueError):
        network.amplitudes(n, layers, other, bits)


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_shares_add_up_to_the_whole(mini, parts):
    n, layers, plan, bits = inputs(mini, "small-share", 11)
    total = 2 ** len(plan["slicing_bonds"])
    whole = network.amplitudes(n, layers, plan, bits)
    step = total // parts
    shares = [network.amplitudes(n, layers, plan, bits,
                                 range(i, i + step))
              for i in range(0, total, step)]
    assert rel(sum(shares), whole) < 1e-12
    assert all(rel(s, whole) > 1e-3 for s in shares)


@pytest.mark.parametrize("ids", [range(4, 12), range(3, 4), range(1, 15)])
def test_state_vector_shares_equal_the_network_ones(mini, ids):
    n, layers, plan, bits = inputs(mini, "small-share", 5)
    psi = statevector.share_state(n, layers, plan["slicing_bonds"], ids)
    want = network.amplitudes(n, layers, plan, bits, ids)
    assert rel(statevector.amplitudes(psi, bits), want) < 1e-12


def test_state_vector_refuses_a_segment_the_circuit_lacks():
    from tnbench.circuits import random_circuit

    n, layers = random_circuit(2, 2, 2, seed=0)
    with pytest.raises(ValueError):
        statevector.state_vector(n, layers, fixed={(99, 0): 1})


def _program(mini, seed):
    from artensor_tpu_torch import TensorNetworkSimulation

    cell = small(mini, "small-share")
    n, layers = traffic.circuit(cell.config, seed)
    sim = TensorNetworkSimulation.from_circuit(
        (n, layers), traffic.bitstrings(cell.traffic, n))
    sim.load_plan(cell.plan_path)
    return sim, n, layers


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_each_share_equals_the_programs_partial_sum(mini, parts):
    from tnbench.session import share_call

    sim, n, layers = _program(mini, 13)
    with open(small(mini, "small-share").plan_path) as f:
        plan = json.load(f)
    total = 2 ** len(sim.slicing_bonds)
    bits = list(sim.bitstrings_sorted)
    step = total // parts
    for first in range(0, total, step):
        ids = range(first, first + step)
        call = share_call(sim, ids, slice_batch=min(step, 4), device="cpu",
                          dtype=np.complex64, precision="highest")
        got = sim.field.unwrap(call()).reshape(-1)
        want = network.amplitudes(n, layers, plan, bits, ids)
        assert rel(got, want) < 1e-5, ids


def test_share_run_scales_its_work(mini):
    from tnbench import run as run_mod
    from tnbench.session import Run

    cell = small(mini, "small-share")
    whole = dataclasses.replace(cell, traffic={
        k: v for k, v in cell.traffic.items() if k != "share"})
    runs = {}
    for key, c in (("share", cell), ("whole", whole)):
        r = Run(c, 3, "cpu")
        r.setup()
        r.window(0.2)
        runs[key] = r
    share, full = runs["share"], runs["whole"]
    assert share.slice_ids == range(4, 12) and full.slice_ids is None
    assert share.amps_per_batch == 16 * 8 / 16
    assert full.amps_per_batch == 16
    assert share.slice_floor_s == full.slice_floor_s > 0
    assert share.roofline_s == 8 * share.slice_floor_s
    assert full.roofline_s == 16 * full.slice_floor_s
    amps = run_mod.metrics_of(share, [{"name": "amps_per_s",
                                       "unit": "amps/s"}])
    assert amps["amps_per_s"]["value"] == pytest.approx(
        len(share.times) * 8.0 / share.window_s, rel=1e-12)
    assert len(share.sample) == 16


def test_share_the_width_does_not_divide_is_refused(mini):
    from tnbench.session import Run

    cell = small(mini, "small-share")
    odd = dataclasses.replace(cell, traffic=dict(
        cell.traffic, share={"first": 0, "slices": 3}))
    r = Run(odd, 1, "cpu")
    with pytest.raises(ValueError, match="multiple"):
        r.setup()
    assert not r.times


def test_state_traffic_with_the_network_reference_is_refused(mini):
    from tnbench.session import Run

    cell = small(mini, "small-dense")
    bad = dataclasses.replace(cell, config=dict(cell.config,
                                                reference="network"))
    with pytest.raises(ValueError, match="state vector"):
        Run(bad, 1, "cpu")
    unknown = dataclasses.replace(cell, config=dict(cell.config,
                                                    reference="mps"))
    with pytest.raises(ValueError, match="unknown reference"):
        Run(unknown, 1, "cpu")
