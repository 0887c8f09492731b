"""Executors: stage a network, fold static steps, and run the 2^k slice loop.

Port of ``artensor_tpu/runtime/executor.py`` (``stage_tensors``,
``precompute_static_steps``, the dense executor ``apply_dense_step`` /
``execute_dense`` / ``tensor_contraction``, ``slice_select``,
``build_slicing_axes`` and the sliced runner, which drives the dense and
the sparse executors alike).  The JAX package traces the slice loop into
one XLA program (``lax.scan`` over ``jax.vmap``-ed groups); here the
runner loops in Python over groups of ``slice_batch`` slices and runs
every step eagerly.
In place of ``vmap``, slice-dependent buffers carry an explicit leading
width axis of ``slice_batch`` instances; slice-invariant buffers stay
unbatched, and every step (dot fallback or kernel) reads them once for all
instances.  Slice bits are taken MSB-first, as in the reference.

CUDA-graph capture of a group's step sequence is not done yet.
"""

import numpy as np
import torch

from ..ops.field import SplitField
from .lowering import apply_lowered, physical_shape


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
              and getattr(s, "gathers", None) is None
              and getattr(s, "reshape", None) is None
              and getattr(s, "post_select", None) is None
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


def apply_dense_step(field, x, y, s, bx=False, by=False):
    """One dense step on flat-stored field tensors: its kernel where the
    scheme gave it one, else the dot fallback.  ``bx`` / ``by``: the
    operand carries a leading slice-width axis (so does the result, if
    either does)."""
    if s.lane is not None and field.supports_lanes:
        from .gatherk import GKPlan, apply_gk_step
        from .lanes import PairPlan, apply_lane_step, apply_pair_step

        if isinstance(s.lane, GKPlan):
            return apply_gk_step(field, x, y, s.lane, bx, by)
        if isinstance(s.lane, PairPlan):
            return apply_pair_step(field, x, y, s.lane, bx, by)
        return apply_lane_step(field, x, y, s.lane, bx, by)
    return apply_lowered(field, x, y, s.lowered, bx, by)


def execute_dense(tensors, steps, field, batched=()):
    """Run dense scheme ``steps`` over staged (flat) field tensors.
    ``batched``: ids of the buffers that carry a leading slice-width axis.
    Returns ``(result, result_is_batched)``."""
    bufs = list(tensors)
    bat = set(batched)
    last = 0
    for s in steps:
        bi, bj = s.i in bat, s.j in bat
        bufs[s.i] = apply_dense_step(field, bufs[s.i], bufs[s.j], s, bi, bj)
        bufs[s.j] = None    # free the consumed operand
        if bj:
            bat.add(s.i)
        last = s.i
    return bufs[last], last in bat


def split_invariant_steps(steps, slicing_axes):
    """``(once, per_slice)``: the steps that no sliced bond reaches
    (neither operand slice-dependent, in scheme order) and the rest.  The
    last step is always in ``per_slice`` (the runner returns its slot)."""
    dyn = {tid for spec in slicing_axes for (tid, *_rest) in spec}
    once, rest = [], []
    for n, s in enumerate(steps):
        if s.i in dyn or s.j in dyn or n == len(steps) - 1:
            dyn.add(s.i)
            rest.append(s)
        else:
            once.append(s)
    return once, rest


def fold_invariant_steps(tensors, steps, slicing_axes, field):
    """Run once, on staged (flat) tensors, the dense steps that no sliced
    bond reaches; returns ``(per_slice_steps, buffers)`` for the sliced
    runner.  The dense output-block walk folds so: a tree planned for the
    whole state keeps its big slice-invariant intermediates when open
    legs are sliced post hoc, and each block would otherwise recompute
    them."""
    once, rest = split_invariant_steps(steps, slicing_axes)
    bufs = list(tensors)
    for s in once:
        bufs[s.i] = apply_dense_step(field, bufs[s.i], bufs[s.j], s)
        bufs[s.j] = None
    return rest, bufs


def tensor_contraction(tensors, steps, field=None, device="cuda"):
    """Contract numpy ``tensors`` by dense ``steps`` on ``device``; returns
    the result as numpy, logically shaped (the last step's dims)."""
    from ..simulation import require_device

    field = field or SplitField()
    staged = stage_tensors(field, [np.asarray(t) for t in tensors],
                           require_device(device))
    out, _ = execute_dense(staged, steps, field)
    return field.unwrap(out).reshape(steps[-1].lowered.dims_y)


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
    """fn(tensors, slice_ids=None) -> sum over the slices ``slice_ids``
    (default all 2^k) of ``execute(sliced, steps)``.

    Drives the dense (``execute_dense``) and the sparse
    (``sparse.execute_sparse``) executors.  ``output_shape`` is LOGICAL;
    the result uses the flat physical form.  ``slice_batch`` slices run
    per group as one width-``slice_batch`` pass; it must divide the
    number of slices summed.  Peak memory grows with it.  ``slice_ids``
    (a range or sequence of ints) sums a subset: the dense output-block
    walk passes the ids of one block.
    """
    phys_out = physical_shape(output_shape)
    n_slices = 2 ** num_sliced
    if slice_batch < 1 or n_slices % slice_batch:
        raise ValueError(f"slice_batch {slice_batch} must divide the "
                         f"{n_slices} slices")

    def run(tensors, slice_ids=None):
        if num_sliced == 0:
            out, _ = execute(tensors, steps, field)
            return field.reshape(out, phys_out)
        device = next(t[0].device for t in tensors if t is not None)
        ids_all = torch.arange(n_slices, device=device) \
            if slice_ids is None else torch.as_tensor(
                np.asarray(slice_ids), dtype=torch.long).to(device)
        if len(ids_all) % slice_batch:
            raise ValueError(f"slice_batch {slice_batch} must divide the "
                             f"{len(ids_all)} slices summed")
        acc = None
        for g0 in range(0, len(ids_all), slice_batch):
            ids = ids_all[g0:g0 + slice_batch]
            sliced, batched = slice_select(tensors, slicing_axes, ids,
                                           num_sliced, field)
            part, is_batched = execute(sliced, steps, field, batched)
            if not is_batched:
                part = field.scale(field.reshape(part, phys_out),
                                   slice_batch)
            elif slice_batch > 1:
                part = field.sum0(field.reshape(part, (slice_batch,)
                                                + phys_out))
            else:               # one instance: drop the width axis, no copy
                part = field.reshape(part, phys_out)
            acc = part if acc is None else field.add(acc, part)
        return acc

    return run


def make_sliced_contraction(steps, slicing_axes, num_sliced, output_shape,
                            field, slice_batch=1):
    """The dense path's sliced runner (see ``make_sliced_runner``)."""
    return make_sliced_runner(execute_dense, steps, slicing_axes,
                              num_sliced, output_shape, field, slice_batch)
