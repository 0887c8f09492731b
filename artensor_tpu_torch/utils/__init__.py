"""Numeric helpers shared by the planner and the runtime (host-side, pure
Python).  Port of ``artensor_tpu/utils/__init__.py``: the log-space sums,
``log2_prod_dims``, ``popcount_configs`` and the letter-einsum helpers."""

import math

LOG10_2 = math.log10(2.0)


def log2_prod_dims(bond_dims, bonds):
    """log2 of the product of the dimensions of ``bonds`` (summed log2s, so
    1000-leg intermediates do not overflow)."""
    return sum(math.log2(bond_dims[b]) for b in bonds)


def log2sumexp2(values):
    """log2(sum_i 2^{v_i}) computed stably; 0.0 for an empty list."""
    if not len(values):
        return 0.0
    m = max(values)
    return m + math.log2(sum(2.0 ** (v - m) for v in values))


def log10sumexp2(values):
    """log10(sum_i 2^{v_i}) computed stably; 0.0 for an empty list."""
    if not len(values):
        return 0.0
    m = max(values)
    return math.log10(sum(2.0 ** (v - m) for v in values)) + m * LOG10_2


def popcount_configs(num_bits, value):
    """Binary digits of ``value`` as a list of ints, MSB first, width
    ``num_bits``."""
    return [(value >> (num_bits - 1 - k)) & 1 for k in range(num_bits)]


_ASCII_LETTERS = [chr(c) for c in list(range(65, 91)) + list(range(97, 123))]


def einsum_eq_convert(ixs, iy):
    """Letter einsum equation for bond-label lists ``ixs -> iy`` (for code
    written against letter equations; the package itself uses integer
    sublists, which have no 52-label cap).  Raises past 52 labels."""
    labels = {}
    for ix in list(ixs) + [iy]:
        for b in ix:
            labels.setdefault(b, len(labels))
    if len(labels) > len(_ASCII_LETTERS):
        raise ValueError(
            f"{len(labels)} distinct labels exceed the 52-letter einsum "
            "alphabet; use integer-sublist einsum instead")
    m = {b: _ASCII_LETTERS[k] for b, k in labels.items()}
    return ",".join("".join(m[b] for b in ix) for ix in ixs) + \
        "->" + "".join(m[b] for b in iy)


def tensordot2einsum(len_i, len_j, idxi_j, idxj_i, permute=None):
    """Letter einsum equation for a tensordot of ranks ``len_i``/``len_j``
    contracting axes ``idxi_j`` (of i) against ``idxj_i`` (of j), with an
    optional output permutation."""
    n_c = len(idxi_j) if idxi_j and idxj_i else 0
    if permute and len(permute) != len_i + len_j - 2 * n_c:
        raise ValueError("permute does not cover the output axes")
    if len_i + len_j - n_c > len(_ASCII_LETTERS):
        raise ValueError("too many axes for the 52-letter einsum alphabet")
    eq_i = [_ASCII_LETTERS[a] for a in range(len_i)]
    out = [eq_i[a] for a in range(len_i) if a not in set(idxi_j or ())]
    eq_j = [""] * len_j
    for a, b in zip(idxi_j or (), idxj_i or ()):
        eq_j[b] = eq_i[a]
    count = len_i
    for b in range(len_j):
        if not eq_j[b]:
            eq_j[b] = _ASCII_LETTERS[count]
            out.append(_ASCII_LETTERS[count])
            count += 1
    if permute:
        out = [out[p] for p in permute]
    return "".join(eq_i) + "," + "".join(eq_j) + "->" + "".join(out)
