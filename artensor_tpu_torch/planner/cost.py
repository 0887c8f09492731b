"""Contraction cost model: tc / sc / mc with the big-batch multiconfig factor.

Port of the tree-cost half of ``artensor_tpu/planner/cost.py`` (``leaf_cost``
and ``merge_cost``), which a loaded plan's ``ContractionTree`` needs for
``complexity()`` and ``to_order_dfs()``.  The annealer's score and the
TPU-calibrated roofline are not ported: this package loads committed plans.

All quantities live in log space:
  tc : log2 of the multiply-add count of one pairwise contraction step
  sc : log2 of the element count of the step's result tensor
  mc : log2 of the memory (elements) live during the step
A subtree containing f final qubits carries a batch axis of size
min(2^f, max_bitstring), so both tc and sc grow by min(f, log2(max_bitstring)).
"""

from math import log2

from ..utils import log2sumexp2


def leaf_cost(tn, tensor_id):
    """(tc, sc, mfactor) of a leaf: no FLOPs, storage = its bonds (+ batch)."""
    mfactor = min(tn.log2_max_bitstring, float(tn.num_fq[tensor_id]))
    sc = sum(log2(tn.bond_dims[b]) for b in tn.tensor_bonds[tensor_id]) \
        + mfactor
    return 0.0, sc, mfactor


def merge_cost(tn, left, right):
    """Cost of contracting two subtrees (planner nodes).

    ``left`` / ``right`` expose ``boundary`` (dict bond -> leaf refcount,
    restricted to bonds not yet fully contracted), ``sc`` and ``mfactor``.
    Returns (tc, sc, mfactor, boundary, mc, contract_bonds, all_bonds).
    """
    dims = tn.bond_dims
    degree = tn.bond_tensors
    merged = dict(left.boundary)
    contract_bonds = set()
    for b, c in right.boundary.items():
        if b in merged:
            c = merged[b] + c
            if c == len(degree[b]):
                contract_bonds.add(b)
        merged[b] = c
    log2_all = 0.0
    log2_out = 0.0
    boundary = {}
    for b, c in merged.items():
        d = log2(dims[b])
        log2_all += d
        if b in contract_bonds:
            continue
        log2_out += d
        boundary[b] = c
    combined = left.mfactor + right.mfactor
    mfactor = min(tn.log2_max_bitstring, combined)
    # an outer product (no bond summed) loses one factor of 2 in tc, as the
    # reference library counts it
    tc = (log2_all if contract_bonds else log2_all - 1.0) + mfactor
    sc = log2_out + mfactor
    if combined > tn.log2_max_bitstring:
        # batch axes of both operands get aligned to the merged batch
        mc = log2sumexp2([
            left.sc - left.mfactor + mfactor,
            right.sc - right.mfactor + mfactor,
            sc,
        ])
    else:
        mc = log2sumexp2([left.sc, right.sc, sc])
    return tc, sc, mfactor, boundary, mc, contract_bonds, merged


# -- the card's budgets for the slice-width choice (runtime/metrics.py) -------
#
# Device memory the slice-batched live set (``metrics.scheme_peak_bytes_at_
# width``) may take on one "NVIDIA H100 80GB HBM3" (PyTorch sees 79.18 GiB).
# Measured (``torch.cuda.max_memory_allocated`` over warm runs,
# scripts/fit_calibration_torch_port.py): every path of the three workloads
# peaks at the modeled live set plus 0.04 GiB at every width from 8 to 128
# (1k 24.04 GiB at width 64, 10k 48.04 at 128, 1k-sc25 24.04 at 32).  The
# budget leaves about 25 GB for what the model does not count (the staged
# operands, ``PEAK_RESERVE_BYTES``, the caching allocator's free blocks).
HBM_BUDGET_BYTES = 60e9
# What a run holds beyond the modeled peak (``metrics.scheme_device_peak_
# bytes``: the live set, the dot fallback's operand copies and the GK
# tables) and the staged operands, at any width: cuBLAS's workspace and the
# other kernels' device index tables (measured 0.04 GiB, above;
# chip_smoke.py and tests/test_torch_cuda.py hold the measured peak to
# model + staged + this).
PEAK_RESERVE_BYTES = 64 << 20
# Host cost of enqueueing one step at slice width 1 (wrapper Python, tables,
# launches): the fitted ``step_overhead_w1_s`` of
# ``scripts/fit_calibration_torch_port.py`` (``data/calibration_h100.json``),
# used when no calibration file is present.
STEP_OVERHEAD_W1_S = 323e-6
