"""Executors: stage a network, fold static steps, and run the 2^k slice loop.

Port of ``artensor_tpu/runtime/executor.py:24-237`` (``stage_tensors``,
``precompute_static_steps``, ``slice_select``, ``build_slicing_axes`` and
the sliced runner).  The JAX package traces the slice loop into one XLA
program (``lax.scan`` over ``jax.vmap``-ed groups); here the runner loops in
Python over groups of ``slice_batch`` slices and runs every step eagerly.
In place of ``vmap``, slice-dependent buffers carry an explicit leading
width axis of ``slice_batch`` instances; slice-invariant buffers stay
unbatched, and every step (dot fallback or kernel) reads them once for all
instances.  Slice bits are taken MSB-first, as in the reference.

CUDA-graph capture of a group's step sequence is not done yet.
"""

import numpy as np
import torch

from .lowering import physical_shape


def stage_tensors(field, arrays, device="cuda"):
    """Stage numpy payloads on ``device`` in flat physical form."""
    return [field.reshape(field.wrap(a, device), physical_shape(np.shape(a)))
            for a in arrays]


def precompute_static_steps(steps, arrays, slicing_axes=(),
                            max_elems=1 << 18):
    """Evaluate slice-independent, batch-free steps on the host and drop
    them from the device program.

    A step folds when neither operand is DYNAMIC (dynamic = carries a
    sliced bond per ``slicing_axes``, carries an amplitude batch — its
    array rank then disagrees with the step's leg count — or was produced
    by a dynamic step) and both operands are small.  Returns
    ``(remaining_steps, arrays2)``; ``arrays2`` holds folded results in the
    producing slots (consumed slots are shrunk to scalars).
    """
    dyn = {tid for spec in slicing_axes for (tid, _a, _d, _p) in spec}
    arrays = [np.asarray(a) for a in arrays]
    out = []
    for n_s, s in enumerate(steps):
        i, j = s.i, s.j
        # the final step always runs on the device: the executor returns
        # the last step's result slot
        ok = (n_s < len(steps) - 1
              and i not in dyn and j not in dyn
              and s.gathers is None and s.reshape is None
              and s.post_select is None
              and i < len(arrays) and j < len(arrays))
        if ok:
            ti, tj = arrays[i], arrays[j]
            ok = (ti.ndim == len(s.ix_i) and tj.ndim == len(s.ix_j)
                  and ti.size <= max_elems and tj.size <= max_elems)
        if not ok:
            dyn.add(i)
            out.append(s)
            continue
        res = np.einsum(ti, list(s.ix_i), tj, list(s.ix_j), list(s.iy))
        if res.size > max_elems:
            dyn.add(i)
            out.append(s)
            continue
        arrays[i] = np.ascontiguousarray(res)
        arrays[j] = np.zeros((), dtype=arrays[j].dtype)  # dead slot
    return out, arrays


def build_slicing_axes(tensor_bonds, slicing_bonds, batched_tensors=(),
                       bond_dims=None, batch_dim=2):
    """Static slice-selection specs for each sliced bond.

    ``tensor_bonds`` is the UNSLICED bond mapping.  ``batched_tensors``:
    ids whose payload carries a leading amplitude-batch axis.  Each entry
    is (tensor_id, logical_axis, logical_dims_before, physical_shape_after);
    the dims are tracked per tensor so that sequential selections on one
    tensor stay consistent.
    """
    batched = set(batched_tensors)
    bond_dims = bond_dims or {}
    state = {}
    specs = [[] for _ in slicing_bonds]
    for x, bond in enumerate(slicing_bonds):
        for tid, bonds in tensor_bonds.items():
            if bond in bonds:
                if tid not in state:
                    cur = (["#batch"] if tid in batched else []) + list(bonds)
                    dims = [batch_dim if b == "#batch"
                            else int(bond_dims.get(b, 2)) for b in cur]
                    state[tid] = (cur, dims)
                cur, dims = state[tid]
                ax = cur.index(bond)
                dims_before = tuple(dims)
                cur.pop(ax)
                dims.pop(ax)
                specs[x].append(
                    (tid, ax, dims_before, physical_shape(tuple(dims))))
    return specs


def slice_select(tensors, slicing_axes, slice_ids, num_sliced, field):
    """Select the slice configurations ``slice_ids`` (a 1-D int64 tensor
    of W ids on the buffers' device).

    Every tensor touched by a sliced bond comes back with a leading width
    axis of W instances; returns ``(buffers, ids_of_batched_buffers)``.
    Bits are MSB-first: sliced bond x is bit (k - 1 - x) of the id.
    """
    bufs = list(tensors)
    batched = set()
    k = num_sliced
    for x, entries in enumerate(slicing_axes):
        bits = (slice_ids >> (k - 1 - x)) & 1
        for tid, ax, dims, phys in entries:
            bufs[tid] = field.index_logical(bufs[tid], dims, ax, bits, phys)
            batched.add(tid)
    return bufs, batched


def make_sliced_runner(execute, steps, slicing_axes, num_sliced,
                       output_shape, field, slice_batch=1):
    """fn(tensors) -> sum over the 2^k slices of ``execute(sliced, steps)``.

    ``output_shape`` is LOGICAL; the result uses the flat physical form.
    ``slice_batch`` slices run per group as one width-``slice_batch``
    pass; it must divide the slice count.  Peak memory grows with it.
    """
    phys_out = physical_shape(output_shape)
    n_slices = 2 ** num_sliced
    if slice_batch < 1 or n_slices % slice_batch:
        raise ValueError(f"slice_batch {slice_batch} must divide the "
                         f"{n_slices} slices")

    def run(tensors):
        if num_sliced == 0:
            out, _ = execute(tensors, steps, field)
            return field.reshape(out, phys_out)
        device = next(t[0].device for t in tensors if t is not None)
        acc = field.zeros(phys_out, device)
        for g0 in range(0, n_slices, slice_batch):
            ids = torch.arange(g0, g0 + slice_batch, device=device)
            sliced, batched = slice_select(tensors, slicing_axes, ids,
                                           num_sliced, field)
            part, is_batched = execute(sliced, steps, field, batched)
            part = field.reshape(part, ((slice_batch,) if is_batched else ())
                                 + phys_out)
            acc = field.add(acc, field.sum0(part) if is_batched
                            else field.scale(part, slice_batch))
        return acc

    return run
