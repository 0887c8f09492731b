"""Contraction cost model: tc / sc / mc with the big-batch multiconfig
factor, the annealer's score, and the H100 roofline of a planned tree.

Port of ``artensor_tpu/planner/cost.py``.  ``leaf_cost``, ``merge_cost``
and ``score`` are device-neutral and unchanged.  The roofline
(``slice_vmap_width``, ``step_overhead_for``, ``tree_roofline_seconds``,
``plan_roofline_seconds``, and the constants the native search's roofline
objective takes) is rebuilt on one H100: the card's memory rate and its
3xTF32 tensor-core rate (``kernels.H100_*``), the device budget the slice
width is chosen under (``HBM_BUDGET_BYTES``) and the fitted per-step
overhead of the port's wall estimate (``data/calibration_h100.json``).

All quantities live in log space:
  tc : log2 of the multiply-add count of one pairwise contraction step
  sc : log2 of the element count of the step's result tensor
  mc : log2 of the memory (elements) live during the step
A subtree containing f final qubits carries a batch axis of size
min(2^f, max_bitstring), so both tc and sc grow by min(f, log2(max_bitstring)).
"""

from math import log2, log10

from .. import kernels
from ..utils import LOG10_2, log2sumexp2


def score(tc, sc, mc, sc_target=30.0, alpha=32.0, sc_weight=2.0):
    """Scalar planner objective: smaller is better.

    log10(alpha * 10^mc + 10^tc) penalized by 2*log10(2) per unit of sc above
    the memory budget ``sc_target`` (log2 elements of the largest allowed
    intermediate).
    """
    if alpha > 0.0:
        m = max(mc + log10(alpha), tc)
        body = m + log10(alpha * 10.0 ** (mc - m) + 10.0 ** (tc - m))
    else:
        body = tc
    return body + sc_weight * LOG10_2 * max(0.0, sc - sc_target)


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


# -- the H100 roofline of a planned tree ---------------------------------------
#
# Complex multiply-adds a second: the split-complex float32 products of the
# port's tensor-core kernels run at 3xTF32 (three TF32 passes, 8 real flops
# a complex multiply-add).
H100_COMPLEX_MULADD_PER_S = kernels.H100_TF32_FLOP_PER_S / 3.0 / 8.0
H100_HBM_BYTES_PER_S = kernels.H100_HBM_BYTES_PER_S
# The tensor cores' k-step (the k8 slice of ``wgmma m64nNk8`` TF32 in
# ``csrc/wgmma_core.cuh``): a step contracting K < 8 bond values fills
# only K/8 of it; wider steps run at the full rate.
MMA_K_STEP = 8.0
# No per-step floor: the port's wall estimate charges only the width-
# amortized overhead (``metrics.scheme_wall_estimate``).
STEP_OVERHEAD_S = 0.0
SLICE_WIDTH_CAP = 256.0


def step_overhead_w1_s():
    """The per-step overhead at width 1: the calibration's fitted value,
    else ``STEP_OVERHEAD_W1_S``."""
    from ..runtime.metrics import load_calibration

    return load_calibration()["step_overhead_w1_s"] or STEP_OVERHEAD_W1_S


def slice_vmap_width(mc_log2):
    """Budget-limited slice width for a plan whose live set is 2^mc
    elements (8 bytes each as a split-complex pair)."""
    w = HBM_BUDGET_BYTES / (8.0 * 2.0 ** mc_log2)
    return max(1.0, min(w, SLICE_WIDTH_CAP))


def step_overhead_for(mc_log2):
    """Width-aware per-step overhead for the roofline objective."""
    return max(STEP_OVERHEAD_S,
               step_overhead_w1_s() / slice_vmap_width(mc_log2))


def tree_roofline_seconds(tree, bytes_per_elem=8.0,
                          muladds_per_s=H100_COMPLEX_MULADD_PER_S,
                          bytes_per_s=H100_HBM_BYTES_PER_S,
                          step_overhead_s=None):
    """Predicted per-slice wall seconds on the card under a two-resource
    roofline: each contraction step costs max(compute, memory traffic) +
    overhead.  Traffic reads both operands and writes the result once;
    compute runs at the tensor-core rate discounted by min(1, K /
    ``MMA_K_STEP``).  The overhead is the width-1 step overhead over the
    slice width the largest step's live set allows."""
    if step_overhead_s is None:
        mcs = [v.mc for v in tree.nodes_root_to_leaves() if not v.is_leaf()]
        step_overhead_s = step_overhead_for(max(mcs, default=0.0))
    total = 0.0
    for v in tree.nodes_root_to_leaves():
        if v.is_leaf():
            continue
        k = 2.0 ** max(0.0, v.tc - v.sc)
        rate = muladds_per_s * min(1.0, k / MMA_K_STEP)
        compute = (2.0 ** v.tc) / rate
        traffic = bytes_per_elem * (
            2.0 ** v.left.sc + 2.0 ** v.right.sc + 2.0 ** v.sc) / bytes_per_s
        total += max(compute, traffic) + step_overhead_s
    return total


def plan_roofline_seconds(tree):
    """Whole-plan prediction: per-slice roofline x 2^(#sliced bonds)."""
    return tree_roofline_seconds(tree) * 2.0 ** len(tree.tn.sliced)
