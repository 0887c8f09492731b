"""The benchmark's plain reference past the state vector: amplitudes by
contracting the circuit's tensor network along a frozen plan, so that no
tensor holds the ``2**n`` state.

``amplitudes(n, layers, plan, bitstrings, slice_ids)`` returns, in
complex128, the amplitude of each bitstring (qubit 0 first) summed over
the slice ids (default: every slice of the plan).  The plan is the cell's
plan file, read as data (``tensor_bonds``, ``slicing_bonds``, ``order``);
nothing else of the program is shared.

1. The gate network, written out from the gate list under the circuit's
   wire-segment labels: ``"{k}-{q}"`` is qubit ``q`` after its ``k``-th
   gate, ``"0-{q}"`` its ``|0>`` input, and a wire that ends on a
   two-qubit gate (or on its input) is capped with an identity, so that
   each output leg ``"{w}-{q}"`` lies on a single-qubit tensor.
2. The network cut at the bonds the plan's tensors hold: each piece
   between them is contracted into one leaf, and each leaf matched to the
   plan tensor with the same bonds (its output leg aside).  A piece that
   matches no plan tensor, or two, is an error.
3. For each slice id: the sliced bonds fixed to its bits (the first
   sliced bond the most significant), the output legs fixed to the
   bitstrings' bits (one batch axis of the bitstrings), and the leaves
   contracted pairwise in the plan's ``order`` (a pair ``(i, j)`` leaves
   its product at ``i``), in plain ``torch`` products.

Where an intermediate would hold more than ``MAX_ELEMS`` values, further
bonds are sliced inside the reference and summed over.
"""

import json

import numpy as np
import torch

from .gates import gate_matrix

BATCH = "#bitstring"
MAX_ELEMS = 2 ** 28


def gate_network(n, layers):
    """``(tensors, outputs)``: ``[(array, bonds)]`` of the circuit's
    network and ``{output leg: qubit}``."""
    tensors = [(np.array([1.0, 0.0], dtype=np.complex128), [f"0-{q}"])
               for q in range(n)]
    wire, single = [0] * n, [False] * n
    for layer in layers:
        for name, qubits, params in layer:
            m, nq = gate_matrix(name, params)
            tensors.append((m.reshape((2,) * (2 * nq)),
                            [f"{wire[q] + 1}-{q}" for q in qubits]
                            + [f"{wire[q]}-{q}" for q in qubits]))
            for q in qubits:
                wire[q] += 1
                single[q] = nq == 1
    for q in range(n):
        if not single[q]:
            tensors.append((np.eye(2, dtype=np.complex128),
                            [f"{wire[q] + 1}-{q}", f"{wire[q]}-{q}"]))
            wire[q] += 1
    return tensors, {f"{wire[q]}-{q}": q for q in range(n)}


def pair(a, la, b, lb):
    """``(tensor, labels)`` of the product of ``a`` (axes labelled ``la``)
    and ``b``: shared labels are summed, but for ``BATCH``, which both
    keep."""
    shared = [x for x in la if x in lb]
    keep = [x for x in shared if x == BATCH]
    summed = [x for x in shared if x != BATCH]
    fa = [x for x in la if x not in shared]
    fb = [x for x in lb if x not in shared]
    dim = dict(zip(la, a.shape)) | dict(zip(lb, b.shape))
    size = lambda ls: int(np.prod([dim[x] for x in ls]))   # noqa: E731
    a = a.permute([la.index(x) for x in keep + fa + summed])
    b = b.permute([lb.index(x) for x in keep + summed + fb])
    out = torch.matmul(a.reshape(size(keep), size(fa), size(summed)),
                       b.reshape(size(keep), size(summed), size(fb)))
    labels = keep + fa + fb
    return out.reshape([dim[x] for x in labels]), labels


def _contract_all(items):
    """One tensor of ``items`` (``[(tensor, labels)]``): at each step the
    pair sharing a bond whose product is the smallest."""
    items = list(items)
    while len(items) > 1:
        best = None
        for i in range(len(items)):
            for j in range(i + 1, len(items)):
                li, lj = items[i][1], items[j][1]
                if not set(li) & set(lj):
                    continue
                rank = len(set(li) ^ set(lj))
                if best is None or rank < best[0]:
                    best = (rank, i, j)
        if best is None:        # disconnected: an outer product
            best = (0, 0, 1)
        _, i, j = best
        b = items.pop(j)
        items[i] = pair(*items[i], *b)
    return items[0]


def leaves(n, layers, plan, device="cpu"):
    """``({plan tensor id: (tensor, labels)}, outputs)``: the gate network
    cut at the plan's bonds, each piece contracted on ``device``."""
    tensors, outputs = gate_network(n, layers)
    planned = {int(t): frozenset(map(str, bs))
               for t, bs in plan["tensor_bonds"].items()}
    kept = frozenset().union(*planned.values())
    ends = {}
    for i, (_, bonds) in enumerate(tensors):
        for b in bonds:
            ends.setdefault(b, []).append(i)
    missing = kept - set(ends)
    if missing:
        raise ValueError(f"the plan's bonds {sorted(missing)[:4]} are no "
                         "wire segments of the circuit")
    root = list(range(len(tensors)))

    def find(i):
        while root[i] != i:
            root[i] = root[root[i]]
            i = root[i]
        return i
    for b, ts in ends.items():
        if b not in kept:
            for t in ts[1:]:
                root[find(t)] = find(ts[0])
    pieces = {}
    for i in range(len(tensors)):
        pieces.setdefault(find(i), []).append(i)
    by_bonds = {}
    for t, bonds in planned.items():
        if bonds in by_bonds:
            raise ValueError(f"plan tensors {by_bonds[bonds]} and {t} hold "
                             "the same bonds")
        by_bonds[bonds] = t
    out = {}
    for members in pieces.values():
        bonds = frozenset(b for i in members for b in tensors[i][1]
                          if b in kept)
        t = by_bonds.get(bonds)
        if t is None or t in out:
            raise ValueError(f"a piece of the circuit with bonds "
                             f"{sorted(bonds)} matches no plan tensor")
        out[t] = _contract_all(
            (torch.as_tensor(tensors[i][0], device=device), tensors[i][1])
            for i in members)
    if len(out) != len(planned):
        raise ValueError(f"{len(planned) - len(out)} plan tensors match no "
                         "piece of the circuit")
    return out, outputs


def _fix(t, labels, bond, bit):
    ax = labels.index(bond)
    return t.select(ax, bit), labels[:ax] + labels[ax + 1:]


def _fix_outputs(t, labels, outputs, bits):
    """The output legs of a leaf fixed to each bitstring's bits: one
    ``BATCH`` axis in front."""
    rows = torch.arange(bits.shape[0], device=bits.device)
    for leg in [x for x in labels if x in outputs]:
        ax = labels.index(leg)
        col = bits[:, outputs[leg]]
        labels = labels[:ax] + labels[ax + 1:]
        if BATCH in labels:
            t = t.movedim(ax, 1)[rows, col]
        else:
            t = t.movedim(ax, 0)[col]
            labels = [BATCH] + labels
    return t, labels


def _sizes(labels, order, dims):
    """``(values, labels)`` of every tensor the contraction starts from or
    makes."""
    cur = {t: list(ls) for t, ls in labels.items()}
    seen = list(cur.values())
    for i, j in order:
        a, b = cur[i], cur.pop(j)
        cur[i] = [x for x in a if x not in b or x == BATCH] + \
            [x for x in b if x not in a]
        seen.append(cur[i])
    return [(int(np.prod([dims[x] for x in ls])), ls) for ls in seen]


def extra_slices(labels, order, dims):
    """Bonds to slice besides the plan's so that no tensor of the
    contraction holds more than ``MAX_ELEMS`` values: at each step the
    bond in the most tensors above it."""
    extra = []
    while True:
        big = [ls for size, ls in _sizes(labels, order, dims)
               if size > MAX_ELEMS]
        if not big:
            return extra
        count = {}
        for ls in big:
            for x in ls:
                if x != BATCH and dims[x] > 1:
                    count[x] = count.get(x, 0) + 1
        if not count:
            raise MemoryError("a tensor of the bitstrings alone exceeds "
                              "the reference's budget")
        bond = max(count, key=count.get)
        extra.append(bond)
        dims = {**dims, bond: 1}


def contract(items, order):
    """The product of ``items`` (``{id: (tensor, labels)}``) along
    ``order``; what is left unjoined is multiplied in at the end."""
    cur = dict(items)
    for i, j in order:
        b = cur.pop(j)
        cur[i] = pair(*cur[i], *b)
    return _contract_all(cur.values())


def amplitudes(n, layers, plan, bitstrings, slice_ids=None, device="cpu"):
    """complex128 amplitudes of ``bitstrings`` (qubit 0 first), summed
    over ``slice_ids`` (default every slice) of ``plan`` (a dict, or the
    path of a plan file)."""
    if not isinstance(plan, dict):
        with open(plan) as f:
            plan = json.load(f)
    if any(float(d) != 2.0 for d in plan["bond_dims"].values()):
        raise ValueError("the reference takes bonds of dimension 2")
    sliced = [str(b) for b in plan["slicing_bonds"]]
    ids = range(2 ** len(sliced)) if slice_ids is None else slice_ids
    order = [tuple(p) for p in plan["order"]]
    found, outputs = leaves(n, layers, plan, device)
    bits = torch.as_tensor(np.array([[int(c) for c in b] for b in bitstrings],
                                    dtype=np.int64), device=device)
    fixed = {t: _fix_outputs(x, ls, outputs, bits)
             for t, (x, ls) in found.items()}
    dims = {BATCH: len(bitstrings)}
    for x, ls in fixed.values():
        dims.update(zip(ls, x.shape))
    dims.update({b: 1 for b in sliced})
    extra = extra_slices({t: ls for t, (_, ls) in fixed.items()}, order,
                         dims)
    bonds = sliced + extra
    acc = torch.zeros(len(bitstrings), dtype=torch.complex128, device=device)
    for s in ids:
        for e in range(2 ** len(extra)):
            word = (s << len(extra)) | e
            items = {}
            for t, (x, ls) in fixed.items():
                for pos, b in enumerate(bonds):
                    if b in ls:
                        bit = (word >> (len(bonds) - 1 - pos)) & 1
                        x, ls = _fix(x, ls, b, bit)
                items[t] = (x, ls)
            val, ls = contract(items, order)
            if ls != [BATCH]:
                raise ValueError(f"the contraction leaves legs {ls}")
            acc += val
            del items, val
    return acc.cpu().numpy()
