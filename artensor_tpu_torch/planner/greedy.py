"""Greedy contraction-order initializer.

Port of ``artensor_tpu/planner/greedy.py``.  Keeps per cluster its
contained tensors, boundary bonds and neighbour clusters, and a pair ->
value table; repeatedly contracts the minimum-value pair with a seeded
random tie-break, applying the big-batch penalty when merging two
partial-batch subtrees overflows the batch budget.  Disconnected leftovers
are chained by outer products at the end.
"""

from math import ceil, log2

import numpy as np

from ..utils import log10sumexp2, log2_prod_dims


class GreedyOrderFinder:
    """Callable: (strategy, seed) -> (order, tc, sc)."""

    def __init__(self, tensor_network):
        self.tn = tensor_network

    # -- pair bookkeeping -------------------------------------------------

    def _pair_value(self, pair):
        i, j = pair
        merged_tensors = self.members[i] | self.members[j]
        common = self.bonds[i] & self.bonds[j]
        gone = {b for b in common if self.tn.bond_tensors[b] <= merged_tensors}
        result = (self.bonds[i] | self.bonds[j]) - gone
        nfq = sum(self.tn.num_fq[t] for t in merged_tensors)
        factor = min(self.tn.log2_max_bitstring, nfq)
        sc = log2_prod_dims(self.tn.bond_dims, result) + factor
        if "min_dim" in self.strategy:
            return sc
        if "max_reduce" in self.strategy:
            return sc - (log2_prod_dims(self.tn.bond_dims, self.bonds[i])
                         + log2_prod_dims(self.tn.bond_dims, self.bonds[j]))
        return 1.0

    def _contract(self, pair):
        """Merge cluster j into i; returns the step's (tc, sc)."""
        i, j = pair
        new_pairs = []
        for n in self.neighbors[j]:
            self.pair_values.pop((min(j, n), max(j, n)))
            if n != i and n not in self.neighbors[i]:
                new_pairs.append((min(i, n), max(i, n)))
        new_pairs += [(min(i, n), max(i, n)) for n in self.neighbors[i] if n != j]

        merged_tensors = self.members[i] | self.members[j]
        all_bonds = self.bonds[i] | self.bonds[j]
        common = self.bonds[i] & self.bonds[j]
        gone = {b for b in common if self.tn.bond_tensors[b] <= merged_tensors}
        result = all_bonds - gone

        nfq_i = sum(self.tn.num_fq[t] for t in self.members[i])
        nfq_j = sum(self.tn.num_fq[t] for t in self.members[j])
        nfq = nfq_i + nfq_j
        budget = self.tn.log2_max_bitstring
        factor = min(budget, nfq)
        if nfq_i < budget and nfq_j < budget and nfq > ceil(budget):
            # merging two partial amplitude batches overflows the budget:
            # the cross-product blows up before being pruned back down
            factor += nfq - ceil(budget)
        sc = log2_prod_dims(self.tn.bond_dims, result) + factor
        tc = log2_prod_dims(self.tn.bond_dims, all_bonds)
        if not gone:
            tc -= 1.0  # outer product: no summed bond
        tc += factor

        self.members[i] = merged_tensors
        self.bonds[i] = result
        self.neighbors[i] = (self.neighbors[i] | self.neighbors[j]) - {i, j}
        for n in self.neighbors[j]:
            if n != i:
                self.neighbors[n].discard(j)
                self.neighbors[n].add(i)
        for p in set(new_pairs):
            self.pair_values[p] = self._pair_value(p)
        return tc, sc

    def _select(self, rng):
        lo = min(self.pair_values.values())
        ties = [p for p, v in self.pair_values.items() if v == lo]
        return ties[rng.choice(len(ties))]

    # -- the search -------------------------------------------------------

    def __call__(self, strategy="min_dim", seed=0):
        self.strategy = strategy
        n = len(self.tn.tensor_bonds)
        self.members = [{i} for i in range(n)]
        self.bonds = [set(self.tn.tensor_bonds[i]) for i in range(n)]
        self.neighbors = []
        for i in range(n):
            nbrs = set()
            for b in self.bonds[i]:
                nbrs |= self.tn.bond_tensors[b]
            nbrs.discard(i)
            self.neighbors.append(nbrs)
        self.pair_values = {}
        for i in range(n):
            for j in self.neighbors[i]:
                self.pair_values[(min(i, j), max(i, j))] = None
        for p in self.pair_values:
            self.pair_values[p] = self._pair_value(p)

        rng = np.random.RandomState(seed)
        order, tcs = [], []
        scs = [log2_prod_dims(self.tn.bond_dims, self.tn.tensor_bonds[i])
               for i in range(n)]
        while True:
            if self.pair_values:
                pair = self._select(rng)
                tc, sc = self._contract(pair)
                order.append(pair)
                tcs.append(tc)
                scs.append(sc)
            else:
                # disconnected leftovers: outer-product chain onto the last
                # contraction's representative
                merged = {p[1] for p in order}
                leftovers = set(range(n)) - merged
                source = order[-1][0] if order else min(leftovers)
                for node in sorted(leftovers):
                    if node == source:
                        continue
                    tc, sc = self._contract((source, node))
                    order.append((source, node))
                    tcs.append(tc)
                    scs.append(sc)
                break
        return order, log10sumexp2(tcs), max(scs)
