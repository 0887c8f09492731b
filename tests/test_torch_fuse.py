"""The port's gate-block fusion (``runtime/fuse.py``) against the JAX
package's on tests/test_fuse.py's random carrier-chain networks: the same
rewrites under the same rates and arbiter, numeric exactness under the
card's rates."""

import numpy as np
import pytest

from artensor_tpu.runtime import fuse as jfuse
from artensor_tpu.runtime import gatherk as jgk
from artensor_tpu_torch import kernels
from artensor_tpu_torch.runtime import fuse as pfuse

SEEDS = range(10)


def _contract(order, tensor_bonds, tensors, labels):
    """Reference executor with the compiler's merge rule (result at the
    pair's first id; common bonds contracted unless a third live tensor
    still holds them)."""
    work = {t: tensors[t] for t in tensor_bonds}
    bonds = {t: list(bs) for t, bs in tensor_bonds.items()}
    for i, j in order:
        bi, bj = bonds[i], bonds[j]
        common = set(bi) & set(bj)
        still = {b for b in common
                 if any(b in bonds[t2] for t2 in bonds
                        if t2 not in (i, j) and bonds[t2])}
        out = [b for b in bi if b not in common or b in still]
        out += [b for b in bj if (b not in common or b in still)
                and b not in out]
        work[i] = np.einsum(work[i], [labels[b] for b in bi],
                            work[j], [labels[b] for b in bj],
                            [labels[b] for b in out])
        work[j] = None
        bonds[i], bonds[j] = out, []
    ri = order[-1][0]
    return work[ri], bonds[ri]


def _chain_tn(seed, n_carrier_legs=16, n_gates=7):
    """A big carrier plus a chain of small gate-block tensors, each taking
    a few live legs and emitting fresh ones (tests/test_fuse.py)."""
    rng = np.random.default_rng(seed)
    x_legs = [f"x{k}" for k in range(n_carrier_legs)]
    tensor_bonds = {0: list(x_legs)}
    bond_dims = {b: 2.0 for b in x_legs}
    tid = 1
    avail = list(x_legs)
    for g in range(n_gates):
        take = [avail.pop(rng.integers(len(avail)))
                for _ in range(int(rng.integers(1, 4)))]
        fresh = [f"g{g}_{k}" for k in range(int(rng.integers(1, 4)))]
        for b in fresh:
            bond_dims[b] = 2.0
        tensor_bonds[tid] = take + fresh
        avail += fresh
        tid += 1
    tensors = {t: (rng.normal(size=tuple(int(bond_dims[b]) for b in bs))
                   + 1j * rng.normal(size=tuple(int(bond_dims[b])
                                                for b in bs)))
               for t, bs in tensor_bonds.items()}
    order = [(0, t) for t in range(1, tid)]
    return order, tensor_bonds, bond_dims, tensors


@pytest.fixture
def jax_rates(monkeypatch):
    """The port's candidate model on the JAX package's rates and
    contraction width."""
    monkeypatch.setattr(pfuse, "HBM_BYTES_PER_S", jgk.HBM_BYTES_PER_S)
    monkeypatch.setattr(pfuse, "FLOPS_PER_S", jgk.MXU_FLOPS_PER_S)
    monkeypatch.setattr(pfuse, "K_FULL", 128)


@pytest.mark.parametrize("seed", SEEDS)
def test_rewrites_match_jax(seed, jax_rates):
    order, tb, bd, _ = _chain_tn(seed)
    assert pfuse.reassociate_small_chains(order, tb, bd) == \
        jfuse.reassociate_small_chains(order, tb, bd)


@pytest.mark.parametrize("seed", SEEDS)
def test_rewrites_match_jax_under_a_vetoing_arbiter(seed, jax_rates):
    """An arbiter that refuses every second candidate sees the same
    candidates in the same order from both packages, and both keep the
    same order."""
    def arbiter(seen):
        def accept(cand):
            seen.append(list(cand))
            return len(seen) % 2 == 0
        return accept

    order, tb, bd, _ = _chain_tn(seed)
    ps, js = [], []
    got = pfuse.reassociate_small_chains(order, tb, bd, accept=arbiter(ps))
    want = jfuse.reassociate_small_chains(order, tb, bd, accept=arbiter(js))
    assert ps == js and got == want


def test_sweep_cost_reads_the_cards_rates():
    """The candidate model: bytes at the card's memory rate against the
    GK mma form's 3xTF32 rate, with no contraction-width discount."""
    best, traffic, compute = pfuse._sweep_cost(1 << 20, 1 << 20, 64, 4, 16)
    assert traffic == 8.0 * ((1 << 21) + 64) / kernels.H100_HBM_BYTES_PER_S
    assert compute == pytest.approx(
        8.0 * (1 << 20) * 16 * 3 / kernels.H100_TF32_FLOP_PER_S, rel=1e-12)
    assert best == max(traffic, compute)
    # the K 4 step is not discounted as a 128-wide unit would discount it
    assert pfuse._sweep_cost(1 << 20, 1 << 20, 64, 64, 16)[2] == compute


@pytest.mark.parametrize("seed", SEEDS)
def test_reassociation_is_exact(seed):
    order, tb, bd, tensors = _chain_tn(seed)
    labels = {b: k for k, b in enumerate(bd)}
    new_order = pfuse.reassociate_small_chains(order, tb, bd)
    want, wb = _contract(order, tb, tensors, labels)
    got, gb = _contract(new_order, tb, tensors, labels)
    got = np.transpose(got, [gb.index(b) for b in wb]) if wb else got
    assert np.allclose(want, got, rtol=1e-11)
    assert new_order[-1][0] == order[-1][0]


def test_card_rates_still_collapse_chains():
    """Under the card's rates the pass still sweeps the carrier fewer
    times across the seeds, and is deterministic."""
    tot_old = tot_new = 0
    for seed in SEEDS:
        order, tb, bd, _ = _chain_tn(seed)
        new_order = pfuse.reassociate_small_chains(order, tb, bd)
        assert new_order == pfuse.reassociate_small_chains(order, tb, bd)
        tot_old += sum(1 for p in order if 0 in p)
        tot_new += sum(1 for p in new_order if 0 in p)
    assert tot_new < tot_old
