"""The port's planner (``artensor_tpu_torch/planner``, ``native/``,
``plan_io``) against the JAX package's: the cost model and tree surgery,
the greedy orders, the Python and the native annealing searches on the
same inputs, the native search's roofline objective (JAX's TPU constants
passed in give JAX's plan; the H100 ones a valid plan), the four committed
n30 plans reproduced under their hash seeds, and plan files carried
across the packages."""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from artensor_tpu import plan_io as jplan_io
from artensor_tpu.native import sa_find_order_native as jax_native
from artensor_tpu.network import AbstractTensorNetwork as JaxATN
from artensor_tpu.planner import GreedyOrderFinder as JaxGreedy
from artensor_tpu.planner import annealing as jann
from artensor_tpu.planner import cost as jcost
from artensor_tpu.planner import find_order as jax_find_order
from artensor_tpu.planner.tree import ContractionTree as JaxTree
from artensor_tpu_torch import plan_io
from artensor_tpu_torch.circuits import TensorNetworkCircuit, random_circuit
from artensor_tpu_torch.native import (native_available, roofline_params,
                                       sa_find_order_native)
from artensor_tpu_torch.network import (AbstractTensorNetwork,
                                        NumericalTensorNetwork)
from artensor_tpu_torch.planner import (ContractionTree, GreedyOrderFinder,
                                        annealing, clone_network, cost,
                                        find_order, score)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
QSIM = os.path.join(ROOT, "tests", "data", "circuit_n12_rcs.qsim")
DATA = os.path.join(ROOT, "artensor_tpu_torch", "data")
HYPER_EQ = "ab,ac,ad,bc,be,cf,de,df,ef->"
HYPER_ORDER = [(0, 1), (3, 5), (0, 3), (4, 8), (0, 4), (6, 7), (0, 6), (0, 2)]
MULTI_EQ = "ab,ac,ad,bc,be,cf,de,df,ef,a,b,c->"
SA_KW = dict(trials=3, iters=6, betas=list(np.linspace(3, 21, 10)),
             start_seed=0, parallel=False)
# the committed plans: (file, PYTHONHASHSEED, simplify mode, bitstrings,
# sc_target); one find_order call (trials 2, iters 10) each
COMMITTED = {
    "1k": ("rcs_n30_m14_s0_sparse_sc24.json", 6, "sparse", 1000, 24),
    "10k": ("rcs_n30_m14_s0_sparse10k_sc24.json", 2, "sparse", 10000, 24),
    "1k-sc25": ("rcs_n30_m14_s0_sparse_sc25.json", 6, "sparse", 1000, 25),
    "dense": ("rcs_n30_m14_s0_dense_sc30.json", 0, "normal", 1, 30),
}


def _parts(eq):
    parts = eq.strip("->").split(",")
    dims = {b: 2.0 for p in parts for b in p}
    return {i: list(p) for i, p in enumerate(parts)}, dims


def make_tn(eq, final_qubits=(), max_bitstring=1, cls=AbstractTensorNetwork):
    tb, dims = _parts(eq)
    return cls(tb, dims, final_qubits, max_bitstring)


def ring(n):
    """n tensors on a ring with next and next-but-one neighbour bonds."""
    tb = {i: [] for i in range(n)}
    dims = {}
    for bid, (i, j) in enumerate((i, i + d) for i in range(n)
                                 for d in (1, 2)):
        b = f"b{bid}"
        tb[i].append(b)
        tb[j % n].append(b)
        dims[b] = 2.0
    return tb, dims


def _qsim_network(mode, n_bits=1):
    ntn = NumericalTensorNetwork(*TensorNetworkCircuit(QSIM).to_numerical_tn())
    tb, fq = ntn.simplify(mode)
    return tb, ntn.bond_dims, fq, n_bits


BITS_64 = [np.binary_repr(int(p), 12) for p in
           np.random.default_rng(7).choice(4096, 64, replace=False)]


def _check_valid_order(order, n):
    alive = set(range(n))
    for i, j in order:
        assert i in alive and j in alive and i != j
        alive.discard(j)
    assert len(alive) == 1


# -- the cost model and the tree (the JAX planner tests' counterparts) ------

def test_hyper_tn_complexity():
    tree = ContractionTree(make_tn(HYPER_EQ), HYPER_ORDER)
    tc, sc, mc = tree.complexity()
    assert tc == pytest.approx(1.8325089127062364, abs=1e-8)
    assert sc == 3.0
    assert mc == pytest.approx(2.1492191126553797, abs=1e-8)


def test_ordinary_tn_complexity():
    tn = make_tn("abc,ade,cdf,bgh,egi,fhi->")
    tc, sc, mc = ContractionTree(
        tn, [(0, 1), (2, 3), (0, 2), (4, 5), (0, 4)]).complexity()
    assert sc == 6.0
    assert tc == pytest.approx(2.380211241711606, abs=1e-8)
    assert mc == pytest.approx(2.436162647040756, abs=1e-8)


def test_multiconfig_complexity():
    tn = make_tn(MULTI_EQ, final_qubits=[9, 10, 11], max_bitstring=7)
    order = [(0, 1), (3, 4), (0, 3), (2, 6), (0, 2), (5, 7), (0, 5), (0, 8),
             (0, 9), (0, 10), (0, 11)]
    tc, sc, _ = ContractionTree(tn, order).complexity()
    assert sc == 5.0
    assert tc == pytest.approx(2.2600713879850747, abs=1e-8)


@pytest.mark.parametrize("bond", list("abcdef"))
def test_whatif_matches_actual_slicing_and_jax(bond):
    """tc and sc of the what-if estimate are those of slicing (mc is a
    simpler recombination); all three equal JAX's estimate."""
    tree = ContractionTree(make_tn(HYPER_EQ), HYPER_ORDER)
    jtree = JaxTree(make_tn(HYPER_EQ, cls=JaxATN), HYPER_ORDER)
    predicted = tree.whatif_slice(bond)
    assert predicted == jtree.whatif_slice(bond)
    tree.slicing(bond)
    actual = tree.complexity()
    tree.add_bond(bond)
    assert predicted[0] == pytest.approx(actual[0], abs=1e-9)
    assert predicted[1] == pytest.approx(actual[1], abs=1e-9)


def test_slicing_add_roundtrip_restores_complexity_and_bonds():
    tn = make_tn(HYPER_EQ)
    tree = ContractionTree(tn, HYPER_ORDER)
    before, lists = tree.complexity(), {t: list(b) for t, b in
                                        tn.tensor_bonds.items()}
    tree.slicing("a")
    tree.slicing("e")
    mid = tree.complexity()
    assert mid[0] < before[0] and mid[1] <= before[1]
    assert tree.slice_candidates() <= set("bcdf")
    tree.add_bond("a")      # not the reverse order: each goes to its place
    tree.add_bond("e")
    assert tree.complexity() == pytest.approx(before, abs=1e-8)
    assert tn.tensor_bonds == lists


def test_slicing_updates_match_fresh_tree():
    tree = ContractionTree(make_tn(HYPER_EQ), HYPER_ORDER)
    tree.slicing("c")
    rebuilt = ContractionTree(clone_network(tree.tn), HYPER_ORDER)
    assert tree.complexity() == pytest.approx(rebuilt.complexity(), abs=1e-8)
    # the clone keeps the restore record: restoring gives the same lists
    clone = clone_network(tree.tn)
    clone.add_bond("c")
    tree.add_bond("c")
    assert clone.tensor_bonds == tree.tn.tensor_bonds


def test_order_exports_are_valid_equivalent_and_jax():
    tn = make_tn(HYPER_EQ)
    tree = ContractionTree(tn, HYPER_ORDER)
    jtree = JaxTree(make_tn(HYPER_EQ, cls=JaxATN), HYPER_ORDER)
    bfs, dfs = tree.to_order_bfs(), tree.to_order_dfs()
    assert (bfs, dfs) == (jtree.to_order_bfs(), jtree.to_order_dfs())
    for order in (bfs, dfs):
        _check_valid_order(order, 9)
        t = ContractionTree(clone_network(tn), order)
        assert t.complexity() == pytest.approx(tree.complexity(), abs=1e-8)
    snap = tree.snapshot()
    again = ContractionTree.from_snapshot(tn, snap)
    assert again.snapshot() == snap


def test_local_rewrites_match_jax():
    """spanning_subtree / current_order_3 / complexity_with_order /
    apply_local_order, move for move against JAX's on the same tree."""
    tree = ContractionTree(make_tn(HYPER_EQ), HYPER_ORDER)
    jtree = JaxTree(make_tn(HYPER_EQ, cls=JaxATN), HYPER_ORDER)
    pool = annealing._ORDER_POOL
    for step in range(6):
        v, jv = tree.root, jtree.root
        for _ in range(step % 3):       # walk down the larger child
            v, jv = v.left, jv.left
        if v.is_leaf():
            continue
        fr, inner = tree.spanning_subtree(v, 3)
        jfr, jinner = jtree.spanning_subtree(jv, 3)
        assert [n.sc for n in fr] == [n.sc for n in jfr]
        assert len(inner) == len(jinner)
        old = tree.current_order_3(v, fr)
        assert old == jtree.current_order_3(jv, jfr)
        new = [o for o in pool if o != old][step % 2]
        assert tree.complexity_with_order(fr, new) == \
            jtree.complexity_with_order(jfr, new)
        branch = v.left if v.left not in fr else v.right
        jbranch = jv.left if jv.left not in jfr else jv.right
        assert tree.local_complexity((v, branch), fr) == \
            jtree.local_complexity((jv, jbranch), jfr)
        tree.apply_local_order(new, fr, None, v)
        jtree.apply_local_order(new, jfr, None, jv)
        assert tree.complexity() == jtree.complexity()
        assert tree.to_order_bfs() == jtree.to_order_bfs()


def test_score_function():
    assert score(10.0, 20.0, 9.0, sc_target=30.0, alpha=0.0) == \
        pytest.approx(10.0)
    assert score(10.0, 32.0, 9.0, sc_target=30.0, alpha=0.0) == \
        pytest.approx(10.0 + 2 * math.log10(2) * 2.0)
    assert score(10.0, 20.0, 10.0, sc_target=30.0, alpha=32.0) == \
        pytest.approx(math.log10(32.0 * 1e10 + 1e10))
    for args in [(9.6, 25.0, 9.1, 24.0, 32.0), (3.0, 3.0, 2.0, 4.0, 0.0)]:
        assert score(*args) == jcost.score(*args)


# -- greedy ---------------------------------------------------------------------

GREEDY_NETS = {
    "hyper": lambda: (*_parts(HYPER_EQ), (), 1),
    "multi": lambda: (*_parts(MULTI_EQ), [9, 10, 11], 7),
    "n12-sparse": lambda: _qsim_network("sparse", 64),
    "n12-dense": lambda: _qsim_network("normal"),
}


@pytest.mark.parametrize("strategy", ["min_dim", "max_reduce"])
@pytest.mark.parametrize("net", sorted(GREEDY_NETS))
def test_greedy_matches_jax_and_cost_model(net, strategy):
    """Seeds 0-3: the port's greedy order is JAX's, valid, and its (tc,
    sc) is the tree's (sc exactly; tc to rounding)."""
    tb, dims, fq, mb = GREEDY_NETS[net]()
    tn = AbstractTensorNetwork(tb, dims, fq, mb)
    g, jg = GreedyOrderFinder(tn), JaxGreedy(JaxATN(tb, dims, fq, mb))
    for seed in range(4):
        order, tc, sc = g(strategy, seed)
        assert (order, tc, sc) == jg(strategy, seed)
        _check_valid_order(order, len(tb))
        if not fq:      # the big-batch penalty is greedy's alone
            got_tc, got_sc, _ = ContractionTree(tn, order).complexity()
            assert got_sc == sc
            assert got_tc == pytest.approx(tc, abs=1e-9)


def test_greedy_multiconfig_penalty():
    order, _, sc = GreedyOrderFinder(
        make_tn(MULTI_EQ, final_qubits=[9, 10, 11], max_bitstring=7))(
            "min_dim", 0)
    _check_valid_order(order, 12)
    assert sc >= math.log2(7)


# -- the Python search ----------------------------------------------------------

def _count_restores(monkeypatch):
    calls = []
    real = ContractionTree.add_bond

    def spy(self, bond):
        calls.append(bond)
        return real(self, bond)

    monkeypatch.setattr(ContractionTree, "add_bond", spy)
    return calls


# (network, sc_target, slicing_repeat): every case slices, none restores
PY_CASES = [("hyper", 2, 1), ("ring20", 3, 2), ("ring20", 4, 2),
            ("ring20", 5, 2), ("n12-sparse", 4, 1), ("n12-dense", 6, 1)]


def _py_net(name):
    if name == "ring20":
        return (*ring(20), (), 1)
    return GREEDY_NETS[name]()


@pytest.mark.parametrize("net,sc,rep", PY_CASES)
def test_simulate_annealing_matches_jax(net, sc, rep, monkeypatch):
    """The Python search on the same inputs gives JAX's plan exactly where
    its slicing loop restores no bond (the port puts a restored bond back
    at its place in each bond list, JAX appends it: ROADMAP.md)."""
    tb, dims, fq, mb = _py_net(net)
    restores = _count_restores(monkeypatch)
    kw = dict(SA_KW, sc_target=sc, slicing_repeat=rep)
    got = annealing.simulate_annealing(AbstractTensorNetwork(tb, dims, fq,
                                                             mb), **kw)
    assert restores == []
    assert got == jann.simulate_annealing(JaxATN(tb, dims, fq, mb), **kw)
    assert got[1]
    _check_valid_order(got[0], len(tb))


RESTORE = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
from artensor_tpu.network import AbstractTensorNetwork as JaxATN
from artensor_tpu.planner import annealing as jann
from artensor_tpu_torch.network import AbstractTensorNetwork
from artensor_tpu_torch.planner import annealing
from artensor_tpu_torch.planner.tree import ContractionTree
tb, dims = {{}}, {{}}
for bid, (i, j) in enumerate((i, i + d) for i in range(20) for d in (1, 2)):
    tb.setdefault(i, []).append(f"b{{bid}}")
    tb.setdefault(j % 20, []).append(f"b{{bid}}")
    dims[f"b{{bid}}"] = 2.0
calls = []
real = ContractionTree.add_bond
ContractionTree.add_bond = lambda self, b: (calls.append(b), real(self, b))[1]
kw = dict(sc_target=4, trials=2, iters=4, betas=list(np.linspace(3, 21, 10)),
          slicing_repeat=6, start_seed=0, parallel=False)
got = annealing.simulate_annealing(AbstractTensorNetwork(tb, dims), **kw)
want = jann.simulate_annealing(JaxATN(tb, dims), **kw)
print(len(calls), got == want)
"""


def test_simulate_annealing_with_restores_matches_jax():
    """A case whose slicing loop restores bonds (6 of them), under a fixed
    hash seed: JAX's plan all the same (every bond of dimension 2, so the
    cost sums are exact whatever the bond-list order)."""
    env = dict(os.environ, PYTHONHASHSEED="0", JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", RESTORE.format(root=ROOT)],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr
    n, same = r.stdout.split()[-2:]
    assert int(n) > 0 and same == "True"


def test_sa_trial_matches_jax():
    """One trial from a greedy start: the same best (score, tc, sc, mc) and
    snapshot as JAX's."""
    tb, dims = ring(16)
    order = GreedyOrderFinder(AbstractTensorNetwork(tb, dims))("min_dim", 1)[0]
    args = (3.0, 4, list(np.linspace(3, 21, 8)), 1)
    got = annealing.sa_trial(ContractionTree(AbstractTensorNetwork(tb, dims),
                                             order), *args, slicing_repeat=1)
    want = jann.sa_trial(JaxTree(JaxATN(tb, dims), order), *args,
                         slicing_repeat=1)
    assert got == want and got[0][2] <= 3.0


def test_find_order_respects_sc_target():
    tb, dims = ring(20)
    order, sliced, ctree = find_order(
        tb, dims, sc_target=3, trials=2, iters=5,
        betas=np.linspace(3, 21, 10), slicing_repeat=1, parallel=False,
        engine="python")
    _check_valid_order(order, 20)
    assert ctree.complexity()[1] <= 3.0
    assert 0 < len(sliced) == len(set(sliced))


def test_parallel_pool_matches_serial():
    """The trial pool (fork here: no CUDA context) returns the serial
    plan."""
    assert annealing.pool_method() == "fork"
    tn = make_tn(HYPER_EQ)
    kw = dict(SA_KW, sc_target=5.0, slicing_repeat=1)
    kw.pop("parallel")
    par = annealing.simulate_annealing(clone_network(tn), parallel=True, **kw)
    ser = annealing.simulate_annealing(clone_network(tn), parallel=False,
                                       **kw)
    assert par == ser
    _check_valid_order(par[0], 9)


def test_pool_method_never_forks_after_cuda(monkeypatch):
    """After CUDA is initialised the pool spawns (the main module is a
    file) or the trials run serially (it is not)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    main = sys.modules["__main__"]
    monkeypatch.setattr(main, "__file__", "/x/main.py", raising=False)
    assert annealing.pool_method() == "spawn"
    monkeypatch.delattr(main, "__file__")
    assert annealing.pool_method() is None


def test_roofline_ranking():
    """rank='roofline' picks by the predicted H100 wall; the plan's total
    is the per-slice roofline x 2^k."""
    tn = make_tn(HYPER_EQ)
    kw = dict(SA_KW, sc_target=5.0, slicing_repeat=1)
    order, sliced = annealing.simulate_annealing(clone_network(tn),
                                                 rank="roofline", **kw)
    _check_valid_order(order, 9)
    t = clone_network(tn)
    for b in sliced:
        t.slicing(b)
    tree = ContractionTree(t, order)
    assert cost.plan_roofline_seconds(tree) > 0
    assert cost.tree_roofline_seconds(tree) * 2 ** len(sliced) == \
        pytest.approx(cost.plan_roofline_seconds(tree))


def test_roofline_is_jax_formula_on_h100_figures(monkeypatch):
    """The port's roofline is JAX's formula: given JAX's full-rate K and
    the same rates and overhead, the same seconds; its own figures are the
    H100's."""
    tb, dims, fq, mb = _qsim_network("sparse", 64)
    order = GreedyOrderFinder(AbstractTensorNetwork(tb, dims, fq, mb))(
        "min_dim", 0)[0]
    tree = ContractionTree(AbstractTensorNetwork(tb, dims, fq, mb), order)
    jtree = JaxTree(JaxATN(tb, dims, fq, mb), order)
    kw = dict(muladds_per_s=1e12, bytes_per_s=1e11, step_overhead_s=1e-6)
    monkeypatch.setattr(cost, "MMA_K_STEP", jcost.MXU_K_FULL)
    assert cost.tree_roofline_seconds(tree, **kw) == \
        pytest.approx(jcost.tree_roofline_seconds(jtree, **kw), rel=1e-12)
    monkeypatch.undo()
    from artensor_tpu_torch import kernels

    assert cost.H100_COMPLEX_MULADD_PER_S == \
        kernels.H100_TF32_FLOP_PER_S / 24
    assert cost.H100_HBM_BYTES_PER_S == kernels.H100_HBM_BYTES_PER_S
    assert cost.slice_vmap_width(30) == 60e9 / (8 * 2.0 ** 30)
    assert cost.step_overhead_for(30) == pytest.approx(
        cost.step_overhead_w1_s() / (60e9 / 8 / 2 ** 30))
    assert cost.step_overhead_for(0) == cost.step_overhead_w1_s() / 256


# -- the native search ------------------------------------------------------------

needs_native = pytest.mark.skipif(not native_available(),
                                  reason="no C++ toolchain")


def _jax_roofline():
    """JAX's TPU roofline constants, in the port's parameter names."""
    return dict(muladds_per_s=jcost.TPU_COMPLEX_MULADD_PER_S,
                bytes_per_s=jcost.TPU_HBM_BYTES_PER_S,
                step_overhead_w1_s=jcost.STEP_OVERHEAD_W1_S,
                hbm_budget_bytes=jcost.HBM_BUDGET_BYTES,
                k_full=jcost.MXU_K_FULL,
                step_overhead_s=jcost.STEP_OVERHEAD_S)


def _n30_1k():
    ntn = NumericalTensorNetwork(*TensorNetworkCircuit(
        random_circuit(5, 6, 14, seed=0)).to_numerical_tn())
    tb, fq = ntn.simplify("sparse")
    return tb, ntn.bond_dims, fq, 1000


NATIVE_NETS = {"ring16": lambda: (*ring(16), (), 1), "n30-1k": _n30_1k}
NATIVE_ARGS = {"ring16": (4.0, 8, np.linspace(3, 21, 15), 2, 0),
               "n30-1k": (24.0, 10, np.linspace(3, 21, 61), 2, 0)}


@needs_native
@pytest.mark.parametrize("objective", ["score", "roofline"])
@pytest.mark.parametrize("net", sorted(NATIVE_NETS))
def test_native_matches_jax_and_cost_model(net, objective):
    """The port's C++ search equals JAX's on the same inputs (the roofline
    objective with JAX's TPU constants passed in); its reported
    complexity is the Python tree's evaluation of its plan."""
    tb, dims, fq, mb = NATIVE_NETS[net]()
    tn = AbstractTensorNetwork(tb, dims, fq, mb)
    inits = [GreedyOrderFinder(tn)("min_dim", s)[0] for s in range(3)]
    args = NATIVE_ARGS[net]
    rp = _jax_roofline() if objective == "roofline" else None
    got = sa_find_order_native(tn, inits, *args, objective=objective,
                               roofline=rp)
    want = jax_native(JaxATN(tb, dims, fq, mb), inits, *args,
                      objective=objective)
    assert got[:2] == want[:2]
    assert got[2] == pytest.approx(want[2], abs=0)
    _check_valid_order(got[0], len(tb))
    tn2 = clone_network(tn)
    for b in got[1]:
        tn2.slicing(b)
    tc, sc, _ = ContractionTree(tn2, got[0]).complexity()
    assert tc == pytest.approx(got[2][0], abs=1e-6)
    assert sc == pytest.approx(got[2][1], abs=1e-9)
    assert sc <= args[0]


@needs_native
@pytest.mark.parametrize("net", sorted(NATIVE_NETS))
def test_native_roofline_on_h100_figures(net):
    """The roofline objective on the port's H100 figures: a valid plan
    within the budget, and the figures passed are the planner's."""
    tb, dims, fq, mb = NATIVE_NETS[net]()
    rp = roofline_params()
    assert rp["muladds_per_s"] == cost.H100_COMPLEX_MULADD_PER_S
    assert (rp["k_full"], rp["hbm_budget_bytes"]) == (8.0, 60e9)
    order, sliced, ctree = find_order(
        tb, dims, fq, max_bitstrings=mb, sc_target=NATIVE_ARGS[net][0],
        trials=3, iters=NATIVE_ARGS[net][1], engine="native",
        objective="roofline", betas=NATIVE_ARGS[net][2])
    _check_valid_order(order, len(tb))
    assert ctree.complexity()[1] <= NATIVE_ARGS[net][0]
    assert cost.plan_roofline_seconds(ctree) > 0


@needs_native
def test_find_order_native_engine_matches_jax():
    tb = {0: ["a", "b"], 1: ["a", "c"], 2: ["b", "c", "d"], 3: ["d"]}
    dims = {b: 2.0 for b in "abcd"}
    kw = dict(sc_target=30, trials=2, iters=3, betas=np.linspace(3, 21, 5),
              engine="native")
    order, sliced, ctree = find_order(tb, dims, **kw)
    _check_valid_order(order, 4)
    assert (order, sliced) == jax_find_order(tb, dims, **kw)[:2]
    with pytest.raises(ValueError):
        find_order(tb, dims, engine="gpu")


REPRO = """
import json, sys
sys.path.insert(0, {root!r})
from artensor_tpu_torch.circuits import TensorNetworkCircuit, random_circuit
from artensor_tpu_torch.network import NumericalTensorNetwork
from artensor_tpu_torch.plan_io import plan_to_dict
from artensor_tpu_torch.planner import find_order
ntn = NumericalTensorNetwork(*TensorNetworkCircuit(
    random_circuit(5, 6, 14, seed=0)).to_numerical_tn())
tb, fq = ntn.simplify({mode!r})
_, _, ctree = find_order(tb, ntn.bond_dims, fq, max_bitstrings={n},
                         sc_target={sc}, trials=2, iters=10, parallel=False,
                         engine="native")
print(json.dumps(plan_to_dict(ctree)))
"""


@needs_native
@pytest.mark.parametrize("name", sorted(COMMITTED))
def test_find_order_reproduces_committed_plan(name):
    """One ``find_order`` call of the port, in a fresh process under the
    plan's hash seed, gives the committed plan file exactly."""
    fname, seed, mode, n, sc = COMMITTED[name]
    env = dict(os.environ, PYTHONHASHSEED=str(seed))
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "-c", REPRO.format(root=ROOT, mode=mode, n=n,
                                            sc=sc)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    with open(os.path.join(DATA, fname)) as f:
        want = json.load(f)
    for key in ("order", "slicing_bonds", "tensor_bonds", "bond_dims",
                "final_qubits", "max_bitstring"):
        assert got[key] == want[key], key
    for key in ("tc", "sc", "mc"):
        assert got["complexity"][key] == pytest.approx(
            want["complexity"][key], abs=1e-9)


# -- plan files across the packages ---------------------------------------------

def test_plan_files_cross_packages(tmp_path):
    """A plan the port saves loads in JAX and one JAX saves loads in the
    port: the same order, sliced bonds, network and complexity, and the
    same scheme compiled from either file."""
    from artensor_tpu_torch.runtime.sparse import (contraction_scheme_sparse,
                                                   scheme_digest)

    tb, dims, fq, mb = _qsim_network("sparse", 64)
    kw = dict(sc_target=4, trials=2, iters=4, betas=np.linspace(3, 21, 8),
              slicing_repeat=1, parallel=False, max_bitstrings=mb)
    _, sliced, ctree = find_order(tb, dims, fq, **kw)
    _, jsliced, jctree = jax_find_order(tb, dims, fq, **kw)
    assert sliced and sliced == jsliced
    p_path, j_path = tmp_path / "port.json", tmp_path / "jax.json"
    plan_io.save_plan(p_path, ctree, meta={"sc_target": 4})
    jplan_io.save_plan(j_path, jctree, meta={"sc_target": 4})
    assert json.loads(p_path.read_text()) == json.loads(j_path.read_text())
    schemes = []
    for path in (p_path, j_path):
        order, sl, pt = plan_io.load_plan(path)
        jorder, jsl, jt = jplan_io.load_plan(path)
        assert (order, sl) == (jorder, jsl)
        assert pt.tn.tensor_bonds == jt.tn.tensor_bonds
        assert pt.complexity() == jt.complexity() == ctree.complexity()
        assert pt.to_order_dfs() == jt.to_order_dfs()
        schemes.append(contraction_scheme_sparse(
            pt, BITS_64, sc_target=4, fuse=False, negotiate=False))
    (p_steps, p_out, p_bits), (j_steps, j_out, j_bits) = schemes
    assert (p_out, p_bits) == (j_out, j_bits)
    assert scheme_digest(p_steps) == scheme_digest(j_steps)


def test_loaded_network_equals_planned_one():
    """The unsliced network a plan file carries, re-sliced on load, is the
    planned network bond list for bond list."""
    tb, dims, fq, mb = _qsim_network("normal")
    _, _, ctree = find_order(tb, dims, fq, sc_target=6, trials=2, iters=4,
                             betas=np.linspace(3, 21, 8), slicing_repeat=1,
                             parallel=False)
    _, _, loaded = plan_io.plan_from_dict(plan_io.plan_to_dict(ctree))
    assert loaded.tn.tensor_bonds == ctree.tn.tensor_bonds
    assert loaded.tn.bond_tensors == ctree.tn.bond_tensors
