"""Tensor-network topology (and numpy payload) representation.

Port of ``artensor_tpu/network.py``: ``AbstractTensorNetwork`` (the
hypergraph plus big-batch metadata, the state a loaded plan re-slices) and
``NumericalTensorNetwork`` with the host-side ``simplify``.  Pure numpy.
"""

from math import log2

import numpy as np


class AbstractTensorNetwork:
    """Hypergraph of tensors and (possibly hyper-) bonds.

    Parameters
    ----------
    tensor_bonds : dict[int, list]
        For each tensor id, the ordered list of bond labels on that tensor.
    bond_dims : dict[label, float]
        Dimension of every bond.
    final_qubits : iterable[int]
        Tensor ids that carry an amplitude-batch axis in sparse (big-batch)
        mode, ORDERED BY QUBIT: final_qubits[q] is the tensor holding qubit
        q's open leg.  A raw set is sorted once; ordered inputs are kept
        verbatim, which the sparse scheme compiler relies on to map batch
        axes to qubits.
    max_bitstring : int
        Upper bound on the number of bitstring amplitudes computed at once.
    """

    def __init__(self, tensor_bonds, bond_dims, final_qubits=(),
                 max_bitstring=1):
        if not isinstance(tensor_bonds, dict):
            tensor_bonds = {i: list(b) for i, b in enumerate(tensor_bonds)}
        self.tensor_bonds = {i: list(b) for i, b in tensor_bonds.items()}
        self.bond_dims = dict(bond_dims)
        self.bond_tensors = {b: set() for b in self.bond_dims}
        for tid, bonds in self.tensor_bonds.items():
            for b in bonds:
                self.bond_tensors[b].add(tid)
        if isinstance(final_qubits, (set, frozenset)):
            final_qubits = sorted(final_qubits)
        self.final_qubits = tuple(final_qubits)
        self.num_fq = {
            tid: (1 if tid in self.final_qubits else 0)
            for tid in self.tensor_bonds
        }
        self.max_bitstring = max_bitstring
        self.log2_max_bitstring = log2(max_bitstring)
        # bonds currently removed by slicing: label -> (dim, tensors it
        # touched, per tensor the bonds that followed it there)
        self.sliced = {}

    @property
    def slicing_bonds(self):
        """Mapping of sliced bond -> dimension."""
        return {b: dim for b, (dim, _t, _a) in self.sliced.items()}

    def slicing(self, bond):
        """Remove ``bond`` from the live network, remembering how to restore
        it: its dimension, the tensors it touches, and for each of them
        the bonds that followed it in the tensor's bond list."""
        dim = self.bond_dims.pop(bond)
        touching = self.bond_tensors.pop(bond)
        after = {}
        for tid in touching:
            bonds = self.tensor_bonds[tid]
            after[tid] = bonds[bonds.index(bond) + 1:]
            bonds.remove(bond)
        self.sliced[bond] = (dim, touching, after)

    def add_bond(self, bond):
        """Restore a previously sliced bond at its original position in
        every tensor's bond list: before the first bond that followed it
        there and is live now (at the end if none is), so that any order
        of restores rebuilds the lists as they were.  (The JAX package
        appends it, which reorders a leaf's axes for later scheme
        compiles.)  Returns the tensors it touches."""
        dim, touching, after = self.sliced.pop(bond)
        self.bond_dims[bond] = dim
        self.bond_tensors[bond] = touching
        for tid in touching:
            bonds = self.tensor_bonds[tid]
            live = set(bonds)
            nxt = next((b for b in after[tid] if b in live), None)
            bonds.insert(len(bonds) if nxt is None else bonds.index(nxt),
                         bond)
        return touching

    def contract(self, x, y):
        """Symbolically merge tensor ``y`` into ``x``."""
        bonds_x = self.tensor_bonds.pop(x)
        bonds_y = self.tensor_bonds.pop(y)
        common = [b for b in bonds_x if b in bonds_y]
        # a common bond disappears only when no third tensor still uses it
        gone = [b for b in common if self.bond_tensors[b] <= {x, y}]
        new_bonds = [b for b in bonds_x + bonds_y if b not in gone]
        seen = set()
        new_bonds = [b for b in new_bonds if not (b in seen or seen.add(b))]
        for b in gone:
            del self.bond_tensors[b]
        for b in set(bonds_y) - set(gone):
            self.bond_tensors[b].discard(y)
            self.bond_tensors[b].add(x)
        for b in set(bonds_x) - set(gone):
            self.bond_tensors[b].add(x)
        self.tensor_bonds[x] = new_bonds
        return new_bonds

    def neighbor_with_most_bonds(self, tid):
        """Among tensors sharing a bond with ``tid``, the one of largest rank
        (None if the tensor is isolated)."""
        cands = set()
        for b in self.tensor_bonds[tid]:
            cands |= self.bond_tensors[b]
        cands.discard(tid)
        if not cands:
            return None
        return max(cands, key=lambda t: (len(self.tensor_bonds[t]), t))


def _bond_qubit(bond):
    """Qubit index encoded in a wire-style bond label '{step}-{qubit}'."""
    return int(str(bond).split("-")[1])


def _bond_step(bond):
    return int(str(bond).split("-")[0])


class NumericalTensorNetwork(AbstractTensorNetwork):
    """Tensor network with numpy payload arrays attached (complex128 by
    default; the runtime casts them when staging onto the device)."""

    def __init__(self, tensors, tensor_bonds, bond_dims, final_qubits=(),
                 max_bitstring=1):
        super().__init__(tensor_bonds, bond_dims, final_qubits, max_bitstring)
        if not isinstance(tensors, dict):
            tensors = {i: t for i, t in enumerate(tensors)}
        self.tensors = {i: np.asarray(t) for i, t in tensors.items()}
        if self.tensors.keys() != self.tensor_bonds.keys():
            raise ValueError("tensors and tensor_bonds have different ids")

    def contract(self, x, y):
        bonds_x = list(self.tensor_bonds[x])
        bonds_y = list(self.tensor_bonds[y])
        new_bonds = super().contract(x, y)
        tx, ty = self.tensors.pop(x), self.tensors.pop(y)
        labels = {b: i for i, b in enumerate({*bonds_x, *bonds_y})}
        self.tensors[x] = np.einsum(
            tx, [labels[b] for b in bonds_x],
            ty, [labels[b] for b in bonds_y],
            [labels[b] for b in new_bonds],
        )
        return new_bonds

    def simplify(self, strategy="normal"):
        """Fuse trivial structure on the host before planning.

        1. Repeatedly absorb rank-1 (dangling) tensors into their neighbor.
        2. Repeatedly absorb rank-2 (matrix) tensors into their larger
           neighbor (final-qubit tensors are preserved: they carry open legs).
        3. Merge parallel bonds (two tensors connected by >1 bond).
        4. Renumber tensor ids densely to 0..N-1.

        Returns ``(tensor_bonds_renumbered, final_qubit_ids)`` where
        ``final_qubit_ids[q]`` is the renumbered tensor id holding qubit q's
        open leg — qubit-indexed and NOT sorted (the renumbering need not be
        monotone in qubit order).  In ``'sparse'`` mode each final-qubit
        tensor keeps only its input-side bond: its output axis becomes the
        implicit amplitude-batch axis (payload axis 0).
        """
        if strategy not in ("normal", "sparse"):
            raise ValueError(f"unknown simplify strategy {strategy!r}")
        # 1. dangling tensors (re-scan each round)
        while True:
            dangling = [
                t for t, bs in self.tensor_bonds.items()
                if len(bs) == 1 and t not in self.final_qubits
            ]
            progressed = False
            for tid in dangling:
                if tid not in self.tensor_bonds \
                        or len(self.tensor_bonds[tid]) != 1:
                    continue
                host = self.neighbor_with_most_bonds(tid)
                if host is None:
                    continue
                self.contract(host, tid)
                progressed = True
            if not progressed:
                break
        # 2. matrix tensors
        while True:
            mats = [
                t for t, bs in self.tensor_bonds.items()
                if len(bs) == 2 and t not in self.final_qubits
                and self.neighbor_with_most_bonds(t) is not None
            ]
            if not mats:
                break
            tid = mats[0]
            self.contract(self.neighbor_with_most_bonds(tid), tid)
        # 3. parallel bonds, re-grouped after every merge
        while True:
            by_endpoints = {}
            for bond, touching in self.bond_tensors.items():
                by_endpoints.setdefault(tuple(sorted(touching)),
                                        []).append(bond)
            fq = set(self.final_qubits)
            pair = next(
                (eps for eps, bs in sorted(by_endpoints.items())
                 if len(eps) == 2 and len(bs) > 1
                 and not (eps[0] in fq and eps[1] in fq)), None)
            if pair is None:
                break
            x, y = pair
            if y in fq:  # the surviving tensor keeps its open-leg identity
                x, y = y, x
            self.contract(x, y)
        # 4. dense renumbering
        old_ids = list(self.tensor_bonds.keys())
        remap = {old: new for new, old in enumerate(old_ids)}
        final_qubit_ids = [0] * len(self.final_qubits)
        new_bonds_map = {}
        for old, new in remap.items():
            bonds = self.tensor_bonds[old]
            if old in self.final_qubits:
                if len(bonds) != 2:
                    raise ValueError(
                        "final-qubit tensor must keep out+in legs")
                out_bond, in_bond = bonds
                if _bond_qubit(out_bond) != _bond_qubit(in_bond):
                    raise ValueError("final-qubit legs on different qubits")
                final_qubit_ids[_bond_qubit(out_bond)] = new
                if strategy == "sparse":
                    if _bond_step(out_bond) <= _bond_step(in_bond):
                        raise ValueError("final-qubit legs out of order")
                    bonds = [in_bond]  # output axis becomes the batch axis
            new_bonds_map[new] = bonds
        self.tensors = {remap[old]: self.tensors[old] for old in old_ids}
        return new_bonds_map, final_qubit_ids
