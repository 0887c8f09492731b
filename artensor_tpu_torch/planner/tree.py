"""Binary contraction tree with cached per-node costs.

Port of the plan-loading half of ``artensor_tpu/planner/tree.py``: building
a tree from a pairwise order, ``complexity()``, the scheme-emission order
``to_order_dfs()``, and ``slicing`` / ``add_bond`` (the dense output-block
walk slices open legs post hoc).  The annealer's local rewrites and
what-if slicing are not ported: this package loads committed plans.
"""

from ..utils import log10sumexp2
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
