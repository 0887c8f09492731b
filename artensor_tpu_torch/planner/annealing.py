"""Simulated-annealing order search with a dynamic-slicing loop.

Port of ``artensor_tpu/planner/annealing.py``:
  1. ``trials`` greedy-seeded contraction trees.
  2. Each tree anneals on its own (in a process pool): sweeps of local
     3-leaf rewrites accepted by Metropolis on the score function.
  3. A slicing loop removes bonds until the sc budget holds, now and then
     restoring a random sliced bond, re-annealing after each change.
  4. The best trial wins: by total log-flops (score + #slices * log10(2)),
     or by the H100 roofline (``rank="roofline"``).
``find_order`` runs this Python search or the native one
(``native/sa_kernel.cpp``, all trials on C++ threads).  Workers exchange
(order, sliced bonds) snapshots, never pickled trees.
"""

import multiprocessing as mp
import os
import random
import sys
from math import exp, log10

import numpy as np

from ..network import AbstractTensorNetwork
from .cost import score
from .greedy import GreedyOrderFinder
from .tree import ContractionTree, clone_network

LOG10_2 = log10(2.0)
_ORDER_POOL = ([(0, 2), (0, 1)], [(0, 1), (0, 2)], [(1, 2), (0, 1)])


def _anneal_sweep(tree, beta, rng, sc_target, alpha):
    """One pre-order pass of local 3-leaf rewrites over the whole tree."""
    stack = [tree.root]
    while stack:
        v = stack.pop()
        if v.is_leaf():
            continue
        frontier, _ = tree.spanning_subtree(v, 3)
        if len(frontier) > 2:
            branch = v.left if v.left not in frontier else v.right
            ref = score(*tree.local_complexity((v, branch), frontier),
                        sc_target, alpha)
            old = tree.current_order_3(v, frontier)
            pool = [o for o in _ORDER_POOL if o != old]
            new = pool[rng.randrange(2)]
            cand = score(*tree.complexity_with_order(frontier, new),
                         sc_target, alpha)
            delta = cand - ref
            if delta <= 0 or rng.random() < exp(-beta * delta):
                tree.apply_local_order(new, frontier, None, v)
        stack.append(v.left)
        stack.append(v.right)


def _scored(tree, sc_target, alpha):
    tc, sc, mc = tree.complexity()
    return (score(tc, sc, mc, sc_target, alpha), tc, sc, mc)


def sa_trial(tree, sc_target, iters, betas, seed,
             slicing_repeat=4, alpha=32.0):
    """Anneal one tree, then run its slicing loop.

    Returns ((score, tc, sc, mc), snapshot) of the best configuration seen.
    """
    rng = random.Random(seed)
    best = (_scored(tree, sc_target, alpha), tree.snapshot())
    for beta in betas:
        for _ in range(iters):
            _anneal_sweep(tree, beta, rng, sc_target, alpha)
            result = _scored(tree, sc_target, alpha)
            if result[0] < best[0][0]:
                best = (result, tree.snapshot())

    pristine = clone_network(tree.tn)
    for bond in list(pristine.sliced):
        pristine.add_bond(bond)
    tree = ContractionTree.from_snapshot(pristine, best[1])
    optimized_sc = tree.complexity()[1]
    loop = 0
    while loop < slicing_repeat * (optimized_sc - sc_target) or best[0][2] > sc_target:
        current_sc = tree.complexity()[1]
        if current_sc > sc_target:
            candidates = tree.slice_candidates()
            if not candidates:
                break  # budget unreachable (open legs dominate): keep best
            ranked = min(
                candidates,
                key=lambda b: score(*tree.whatif_slice(b), sc_target, alpha),
            )
            tree.slicing(ranked)
        elif tree.tn.sliced:
            tree.add_bond(rng.choice(sorted(tree.tn.sliced.keys(), key=str)))
        best = (_scored(tree, sc_target, alpha), tree.snapshot())
        for beta in betas[-10:]:
            for _ in range(iters):
                _anneal_sweep(tree, beta, rng, sc_target, alpha)
                result = _scored(tree, sc_target, alpha)
                if result[0] < best[0][0]:
                    best = (result, tree.snapshot())
        loop += 1
        if best[1] != tree.snapshot():
            tree = ContractionTree.from_snapshot(pristine, best[1])
    return best


def pool_method():
    """The start method of the trial pool, or None to run the trials
    serially: fork, unless this process has initialised CUDA (a forked
    child of a CUDA context must not exist); then spawn, unless the main
    module is no file (stdin, a notebook) that spawn could re-import."""
    if os.name != "posix":
        return None
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return "fork"
    main_mod = sys.modules.get("__main__")
    return "spawn" if getattr(main_mod, "__file__", None) else None


def _sa_worker(payload):
    (tensor_bonds, bond_dims, final_qubits, max_bitstring, order,
     sc_target, iters, betas, seed, slicing_repeat, alpha) = payload
    tn = AbstractTensorNetwork(tensor_bonds, bond_dims, final_qubits, max_bitstring)
    tree = ContractionTree(tn, order)
    return sa_trial(tree, sc_target, iters, betas, seed, slicing_repeat, alpha)


def simulate_annealing(tn, sc_target=-1, trials=10, iters=50,
                       betas=np.linspace(0.1, 10, 100), slicing_repeat=4,
                       start_seed=0, alpha=32.0, parallel=True,
                       rank="flops"):
    """Run ``trials`` independent SA chains; return (order, slicing_bonds).

    ``parallel``: the trials run in a process pool (``pool_method``).
    ``rank``: how the winning trial is chosen: 'flops' (total log-flops) or
    'roofline' (the predicted H100 wall, ``cost.plan_roofline_seconds``,
    which charges memory-bound steps by their bytes).
    """
    greedy = GreedyOrderFinder(tn)
    betas = list(betas)
    payloads = []
    for i in range(trials):
        order, _, _ = greedy("min_dim", start_seed + i)
        payloads.append((
            {t: list(b) for t, b in tn.tensor_bonds.items()},
            dict(tn.bond_dims), list(tn.final_qubits), tn.max_bitstring,
            order, sc_target, iters, betas, start_seed + i, slicing_repeat,
            alpha,
        ))
    results = None
    method = pool_method() if parallel and trials > 1 else None
    if method is not None:
        ctx = mp.get_context(method)
        with ctx.Pool(min(trials, os.cpu_count() or 1)) as pool:
            results = pool.map(_sa_worker, payloads)
    if results is None:
        results = [_sa_worker(p) for p in payloads]
    if rank == "roofline":
        from .cost import plan_roofline_seconds

        def key(r):
            order, sliced = r[1]
            t = clone_network(tn)
            for b in sliced:
                t.slicing(b)
            return plan_roofline_seconds(ContractionTree(t, order))
        best = min(results, key=key)
    else:
        # log10(total flops over all 2^k slices) = per-slice tc + k*log10(2)
        best = min(results, key=lambda r: r[0][1] + len(r[1][1]) * LOG10_2)
    order, sliced = best[1]
    return order, list(sliced)


def _native_annealing(tn, sc_target, trials, iters, betas, slicing_repeat,
                      start_seed, alpha, objective="score", k_full=None):
    """Run the native SA search (all trials on C++ threads).

    ``k_full``: the contraction width at the full tensor-core rate in the
    roofline objective (default ``cost.MMA_K_STEP``); a larger value biases
    the search toward wide-K trees."""
    from ..native import sa_find_order_native

    greedy = GreedyOrderFinder(tn)
    init_orders = [greedy("min_dim", start_seed + i)[0] for i in range(trials)]
    order, sliced, stats = sa_find_order_native(
        tn, init_orders, sc_target, iters, list(betas), slicing_repeat,
        start_seed, alpha=alpha, objective=objective, k_full=k_full)
    return order, sliced


def find_order(tensor_bonds, bond_dims, final_qubits=(), seed=0,
               max_bitstrings=1, parallel=True, engine="auto", **sa_kwargs):
    """Plan a contraction: returns (order, slicing_bonds, ContractionTree).

    The returned tree owns a network with the chosen bonds already sliced;
    the scheme compilers consume it directly.  ``engine``: 'native' (the
    C++ search, trials on threads; raises if it cannot be built), 'python',
    or 'auto' (native when it builds).  The other keyword arguments
    (sc_target, trials, iters, betas, slicing_repeat, start_seed, alpha;
    native: objective, k_full; python: rank) go to the search.
    """
    tn = AbstractTensorNetwork(
        {t: list(b) for t, b in (
            tensor_bonds.items() if isinstance(tensor_bonds, dict)
            else enumerate(tensor_bonds))},
        dict(bond_dims), final_qubits, max_bitstrings,
    )
    if engine not in ("auto", "native", "python"):
        raise ValueError(f"unknown planner engine {engine!r}")
    use_native = False
    if engine != "python":
        from ..native import build_error, native_available

        use_native = native_available()
        if engine == "native" and not use_native:
            raise RuntimeError(
                f"native planner search unavailable: {build_error()}")
    if use_native and len(tn.tensor_bonds) >= 2:
        na_kwargs = dict(sc_target=-1, trials=10, iters=50,
                         betas=np.linspace(0.1, 10, 100), slicing_repeat=4,
                         start_seed=0, alpha=32.0, objective="score",
                         k_full=None)
        na_kwargs.update(sa_kwargs)
        na_kwargs.pop("rank", None)  # the native search ranks by objective
        order, slicing_bonds = _native_annealing(
            clone_network(tn), na_kwargs["sc_target"], na_kwargs["trials"],
            na_kwargs["iters"], na_kwargs["betas"],
            na_kwargs["slicing_repeat"], na_kwargs["start_seed"],
            na_kwargs["alpha"], na_kwargs["objective"], na_kwargs["k_full"])
    else:
        sa_kwargs.pop("objective", None)   # the Python search: score only
        sa_kwargs.pop("k_full", None)
        order, slicing_bonds = simulate_annealing(
            clone_network(tn), parallel=parallel, **sa_kwargs)
    for bond in slicing_bonds:
        tn.slicing(bond)
    ctree = ContractionTree(tn, order)
    return order, slicing_bonds, ctree
