"""Binary contraction tree with incrementally maintained cost caches.

Port of ``artensor_tpu/planner/tree.py``: building a tree from a pairwise
order, ``complexity()`` and its what-if forms, slicing (``slicing`` /
``add_bond`` / ``whatif_slice`` / ``slice_candidates``), the annealer's
local 3-leaf rewrites, the order exports (``to_order_dfs`` for scheme
emission, ``to_order_bfs`` for snapshots and saved plans), snapshots, and
``clone_network``.  Nodes hold parent/child pointers and a bond ->
refcount ``boundary``; traversals are iterative; a snapshot is an
(order, sliced bonds) pair rebuilt onto a fresh network clone.
"""

from math import log2

from ..utils import log10sumexp2, log2sumexp2
from .cost import leaf_cost, merge_cost


class Node:
    __slots__ = (
        "left", "right", "parent", "leaf_id", "rep",
        "tc", "sc", "mc", "mfactor", "boundary", "contract_bonds",
    )

    def __init__(self):
        self.left = None
        self.right = None
        self.parent = None
        self.leaf_id = None    # tensor id for leaves, None for internal nodes
        self.rep = -1          # representative tensor id (scheme emission)

    def is_leaf(self):
        return self.leaf_id is not None

    def refresh(self, tn):
        """Recompute cached costs from the network (leaf) or children."""
        if self.is_leaf():
            self.tc, self.sc, self.mfactor = leaf_cost(tn, self.leaf_id)
            self.boundary = {b: 1 for b in tn.tensor_bonds[self.leaf_id]}
            self.contract_bonds = set()
        else:
            (self.tc, self.sc, self.mfactor, self.boundary, self.mc,
             self.contract_bonds, _) = merge_cost(tn, self.left, self.right)

    def has_bond(self, bond):
        return bond in self.boundary or bond in self.contract_bonds


class ContractionTree:
    """Contraction tree over an AbstractTensorNetwork.

    ``order`` is a pairwise contraction order over representative tensor
    ids: each pair (i, j) merges the branch currently represented by j
    into i.
    """

    def __init__(self, tn, order):
        self.tn = tn
        self.order = list(order)
        self.leaves = {}
        branch = {}
        root = None
        for i, j in self.order:
            left = branch.get(i) or self._make_leaf(i)
            right = branch.get(j) or self._make_leaf(j)
            root = self._make_parent(left, right)
            branch[i] = root
        if root is None:
            (tid,) = tn.tensor_bonds.keys()
            root = self._make_leaf(tid)
        self.root = root

    def _make_leaf(self, tid):
        node = Node()
        node.leaf_id = tid
        node.refresh(self.tn)
        self.leaves[tid] = node
        return node

    def _make_parent(self, left, right):
        node = Node()
        node.left, node.right = left, right
        left.parent = right.parent = node
        node.refresh(self.tn)
        return node

    def nodes_root_to_leaves(self):
        out = []
        stack = [self.root]
        while stack:
            v = stack.pop()
            out.append(v)
            if not v.is_leaf():
                stack.append(v.left)
                stack.append(v.right)
        return out

    def nodes_leaves_to_root(self):
        out = self.nodes_root_to_leaves()
        out.reverse()
        return out

    def complexity(self):
        """(tc, sc, mc): log10 total mul-adds, log2 max elements, log10 mem."""
        tcs, scs, mcs = [], [], []
        for v in self.nodes_root_to_leaves():
            scs.append(v.sc)
            if not v.is_leaf():
                tcs.append(v.tc)
                mcs.append(v.mc)
        return log10sumexp2(tcs), max(scs), log10sumexp2(mcs)

    @staticmethod
    def local_complexity(internal, leaves):
        """Complexity of a connected sub-forest given its internal nodes and
        leaves."""
        tcs = [v.tc for v in internal]
        mcs = [v.mc for v in internal]
        scs = [v.sc for v in internal] + [v.sc for v in leaves]
        return log10sumexp2(tcs), max(scs), log10sumexp2(mcs)

    def complexity_with_order(self, leaves, order):
        """What-if complexity of re-contracting ``leaves`` in ``order``;
        builds throwaway cost nodes only, the tree is untouched."""
        branch = {}
        tcs, scs, mcs = [], [], []
        for i, j in order:
            left = branch.get(i, leaves[i])
            right = branch.get(j, leaves[j])
            probe = Node()
            probe.left, probe.right = left, right
            probe.refresh(self.tn)
            branch[i] = probe
            tcs.append(probe.tc)
            scs.append(probe.sc)
            mcs.append(probe.mc)
        scs += [v.sc for v in leaves]
        return log10sumexp2(tcs), max(scs), log10sumexp2(mcs)

    def slice_candidates(self):
        """Bonds on the boundary of any maximal-sc node.  Open (degree-1)
        bonds are excluded: slicing sums over the sliced index, which would
        marginalise an output leg.  An empty set means the sc budget cannot
        be reached by slicing."""
        _, sc, _ = self.complexity()
        pool = set()
        for v in self.nodes_root_to_leaves():
            if v.sc == sc:
                pool.update(
                    b for b in v.boundary
                    if len(self.tn.bond_tensors[b]) > 1)
        return pool

    def _refresh_marked(self, marked):
        for v in self.nodes_leaves_to_root():
            if v in marked:
                v.refresh(self.tn)

    def slicing(self, bond):
        """Remove ``bond`` from the network and refresh affected caches."""
        endpoints = self.tn.bond_tensors[bond]
        marked = set()
        for tid in endpoints:
            v = self.leaves[tid]
            while v is not None and v not in marked:
                marked.add(v)
                if bond in v.contract_bonds:
                    break
                v = v.parent
        self.tn.slicing(bond)
        self._refresh_marked(marked)

    def add_bond(self, bond):
        """Restore a sliced bond and refresh affected caches."""
        endpoints = self.tn.add_bond(bond)
        marked = set()
        for tid in endpoints:
            v = self.leaves[tid]
            while v is not None and v not in marked:
                marked.add(v)
                v = v.parent
        self._refresh_marked(marked)

    def whatif_slice(self, bond):
        """(tc, sc, mc) if ``bond`` were sliced, without mutating anything:
        one pass over the tree adjusting each affected node's cached
        numbers (tc and sc exact; mc recombined from the adjusted scs)."""
        dim = log2(self.tn.bond_dims[bond])
        tcs, scs, mcs = [], [], []
        for v in self.nodes_root_to_leaves():
            if v.has_bond(bond):
                sc = v.sc - dim if bond in v.boundary else v.sc
                if v.is_leaf():
                    scs.append(sc)
                    continue
                tc = v.tc - dim
                if bond in v.contract_bonds and len(v.contract_bonds) == 1:
                    tc -= 1.0
                sc_l = v.left.sc - dim if v.left.has_bond(bond) \
                    else v.left.sc
                sc_r = v.right.sc - dim if v.right.has_bond(bond) \
                    else v.right.sc
                tcs.append(tc)
                scs.append(sc)
                mcs.append(log2sumexp2([sc_l, sc_r, sc]))
            else:
                scs.append(v.sc)
                if not v.is_leaf():
                    tcs.append(v.tc)
                    mcs.append(v.mc)
        return log10sumexp2(tcs), max(scs), log10sumexp2(mcs)

    # -- local rewrites (the annealer's moves) ------------------------------

    def spanning_subtree(self, root, size=3):
        """BFS a subtree of ~``size`` frontier nodes below ``root``.
        Returns (frontier, internal): the subtree's leaves (tree nodes, not
        necessarily network leaves) and its interior nodes bottom-up (root
        last)."""
        queue = [root]
        leaves = []
        visited = []
        while queue and len(queue) + len(leaves) < size:
            v = queue.pop(0)
            visited.append(v)
            if v.is_leaf():
                leaves.append(v)
            else:
                queue.append(v.left)
                queue.append(v.right)
        frontier = queue + leaves
        internal = visited + queue
        internal.reverse()
        return frontier, internal

    @staticmethod
    def current_order_3(subroot, frontier):
        """The 3-leaf contraction order currently realised under
        ``subroot``."""
        branch = subroot.left if subroot.left not in frontier \
            else subroot.right
        if branch in frontier:
            raise ValueError("malformed local subtree")
        first = sorted((frontier.index(branch.left),
                        frontier.index(branch.right)))
        if first == [0, 2]:
            return [(0, 2), (0, 1)]
        if first == [0, 1]:
            return [(0, 1), (0, 2)]
        return [(1, 2), (0, 1)]

    def apply_local_order(self, order, frontier, internal, subroot):
        """Re-wire the subtree under ``subroot`` to realise ``order``; only
        caches at and below ``subroot`` change (its leaf set, hence its
        boundary and sc, is unchanged)."""
        slots = list(frontier)
        for idx, (i, j) in enumerate(order):
            left, right = slots[i], slots[j]
            parent = subroot if idx == len(order) - 1 else Node()
            parent.left, parent.right = left, right
            left.parent = right.parent = parent
            parent.refresh(self.tn)
            slots[i] = parent

    # -- order export ---------------------------------------------------------

    def mark_representatives(self):
        """Pick, per node, the child branch whose result tensor is larger
        (its buffer is reused for the step output); ties go right."""
        for v in self.nodes_leaves_to_root():
            if v.is_leaf():
                v.rep = v.leaf_id
            else:
                v.rep = v.left.rep if v.left.sc > v.right.sc else v.right.rep

    def to_order_dfs(self):
        """Depth-first order over representative ids (scheme emission order)."""
        self.mark_representatives()
        order = []
        stack = [self.root]
        while stack:
            v = stack.pop()
            if v.is_leaf():
                continue
            if v.rep == v.left.rep:
                order.append((v.left.rep, v.right.rep))
            else:
                order.append((v.right.rep, v.left.rep))
            if v.left.sc > v.right.sc:
                stack += [v.left, v.right]
            else:
                stack += [v.right, v.left]
        order.reverse()
        return order

    def to_order_bfs(self):
        """Breadth-first order keyed by the least contained tensor id
        (stable: the order snapshots and saved plans carry)."""
        mins = {}
        for v in self.nodes_leaves_to_root():
            mins[id(v)] = v.leaf_id if v.is_leaf() else min(
                mins[id(v.left)], mins[id(v.right)])
        order = []
        queue = [self.root]
        while queue:
            v = queue.pop(0)
            if not v.is_leaf():
                queue += [v.left, v.right]
                a, b = mins[id(v.left)], mins[id(v.right)]
                order.append((min(a, b), max(a, b)))
        order.reverse()
        return order

    # -- snapshots ------------------------------------------------------------

    def snapshot(self):
        """Cheap restorable state: (bfs order, sliced bond labels)."""
        return self.to_order_bfs(), tuple(self.tn.sliced.keys())

    @classmethod
    def from_snapshot(cls, pristine_tn, snap):
        """Rebuild a tree from ``snapshot()`` output onto a fresh clone of
        ``pristine_tn``."""
        order, sliced = snap
        tn = clone_network(pristine_tn)
        for bond in sliced:
            tn.slicing(bond)
        return cls(tn, order)


def clone_network(tn):
    """Cheap structural copy of an AbstractTensorNetwork (no payloads),
    with its sliced bonds' restore records ``(dim, touching, after)``."""
    from ..network import AbstractTensorNetwork

    new = AbstractTensorNetwork.__new__(AbstractTensorNetwork)
    new.tensor_bonds = {t: list(b) for t, b in tn.tensor_bonds.items()}
    new.bond_dims = dict(tn.bond_dims)
    new.bond_tensors = {b: set(s) for b, s in tn.bond_tensors.items()}
    new.final_qubits = tuple(tn.final_qubits)
    new.num_fq = dict(tn.num_fq)
    new.max_bitstring = tn.max_bitstring
    new.log2_max_bitstring = tn.log2_max_bitstring
    new.sliced = {b: (d, set(s), {t: list(a) for t, a in after.items()})
                  for b, (d, s, after) in tn.sliced.items()}
    return new
