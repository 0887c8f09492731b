"""Scientific-notation execution: every intermediate renormalised.

Port of ``artensor_tpu/runtime/rescaled.py``.  Deep contractions drive
amplitude magnitudes far below the float32 range; each step's output is
divided by its largest magnitude (the field's ``max_abs``) and the log10
of that divisor accumulates in a factor.  Sliced partial sums carry their
own factors and are combined in units of the larger one
(``combine_rescaled``).  Results are ``(tensor, log10_factor)``: true value
= tensor * 10**factor.  Each step's output is scaled in place (it is a
fresh tensor of that step), so the run holds no more than the plain one.

The factor stays a device scalar (no host sync per step), so a slice is
captured as a CUDA graph on the card and replayed for every slice, as the
sliced runner does (``executor.GroupRunner``); the CPU runs every step
eagerly.  Slices run one at a time (width 1), as in the JAX package.
"""

import torch

from .executor import (GroupRunner, _device, slice_ids_tensor, slice_select,
                       sum_spec)
from .lowering import physical_shape


def execute_rescaled(apply_step, tensors, steps, field, batched=()):
    """Run a scheme, renormalising after every step.  ``batched``: ids of
    the buffers that carry a leading slice-width axis.  Returns
    ``(result, log10_factor, result_is_batched)``."""
    bufs = list(tensors)
    bat = set(batched)
    factor = None
    last = 0
    for s in steps:
        bi, bj = s.i in bat, s.j in bat
        out = apply_step(field, bufs[s.i], bufs[s.j], s, bi, bj)
        norm = field.max_abs(out)
        safe = torch.where(norm > 0, norm, torch.ones_like(norm))
        inv = 1.0 / safe
        for c in field.buffers(out):    # in place: the step's own output
            c.mul_(inv)
        f = torch.log10(safe)
        factor = f if factor is None else factor + f
        bufs[s.i] = out
        bufs[s.j] = None
        if bj:
            bat.add(s.i)
        last = s.i
    if factor is None:
        factor = torch.zeros((), dtype=field.rdtype,
                             device=field.device(bufs[last]))
    return bufs[last], factor, last in bat


def combine_rescaled(a, b, field):
    """(t1, f1) + (t2, f2) -> their sum in units of 10**max(f1, f2)."""
    t1, f1 = a
    t2, f2 = b
    m = torch.maximum(f1, f2)
    t = field.add(field.scale(t1, torch.pow(10.0, f1 - m)),
                  field.scale(t2, torch.pow(10.0, f2 - m)))
    return t, m


def _combine_into(acc, part):
    """``combine_rescaled`` in place on ``(*buffers, log10_factor)``
    tuples (the field's tensors, then the factor): ``acc * 10**(fa - m) +
    part * 10**(fp - m)``, ``m`` the larger factor, with no temporary of
    the output's size."""
    m = torch.maximum(acc[-1], part[-1])
    a, b = torch.pow(10.0, acc[-1] - m), torch.pow(10.0, part[-1] - m)
    for c, v in zip(acc[:-1], part[:-1]):
        c.mul_(a).add_(v.mul_(b))
    acc[-1].copy_(m)


def make_rescaled_runner(apply_step, steps, slicing_axes, num_sliced,
                         output_shape, field):
    """Sliced rescaled contraction: fn(tensors, slice_ids=None) ->
    ``(tensor, log10_factor)``, the tensor flat physical, the factor a
    0-d device tensor.  On a CUDA device one slice is captured as a CUDA
    graph and replayed for every slice, its part combined into a static
    accumulator in place (``executor.GroupRunner``; the whole run is one
    graph, with nothing sliced); the result is a copy.  ``fn.stats``: the
    ``GroupRunner``'s."""
    phys_out = physical_shape(output_shape)
    n_slices = 2 ** num_sliced

    def one(tensors, table):
        batched = ()
        if num_sliced:
            tensors, batched = slice_select(tensors, slicing_axes,
                                            table["ids"], num_sliced, field)
        t, f, _ = execute_rescaled(apply_step, tensors, steps, field,
                                   batched)
        table["part"] = field.buffers(field.reshape(t, phys_out)) + (f,)

    runner = GroupRunner(field, [one], _combine_into,
                         sum_spec(field, phys_out)
                         + [((), -1e30, field.rdtype)])

    def run(tensors, slice_ids=None):
        ids = slice_ids_tensor(slice_ids, n_slices,
                               _device(tensors, field)) \
            if num_sliced else None
        out = runner(tensors, ids)
        return field.join(out[:-1]), out[-1]

    run.stats = runner.stats
    return run
