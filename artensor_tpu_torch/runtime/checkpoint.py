"""Checkpoint/resume and retry for long sliced contractions.

Port of ``artensor_tpu/runtime/checkpoint.py``.  Slices are independent
sub-tasks summed into one accumulator: ``run_sliced_checkpointed`` walks
the 2^k slice ids in chunks through the sliced runner
(``executor.make_sliced_runner``, which on the card replays one captured
group for every chunk), saves the partial accumulator and the next slice
id after every chunk, resumes from the saved file on restart, and retries
a chunk that failed.  The file holds the flat physical accumulator under
the JAX package's keys: ``acc_re`` and ``acc_im`` for a split field, one
array ``acc`` for the complex field (complex) and the fused one (folded
re/im), and ``next_slice``; so either package resumes the other's
checkpoint in every mode.  A chunk need not be a multiple of the runner's
width, nor start on one (a file written at another width): the runner
runs its rest as one narrower group (``executor.group_widths``).
"""

import logging
import os
import tempfile

import numpy as np
import torch

from .lowering import physical_shape


def run_sliced_checkpointed(run, tensors, num_sliced, output_shape, field,
                            path, chunk=None, max_retries=2, progress=None):
    """Execute ``run(tensors, slice_ids, init=...)`` over all slices.

    ``run``: the runner from ``executor.make_sliced_runner`` (it takes a
    ``range`` of slice ids and an ``init`` accumulator).  ``path``: the
    checkpoint file (.npz), removed on success.  ``chunk``: slice ids per
    checkpoint interval (default an eighth of the slices, at least 1; any
    size, the runner's width need not divide it).  ``progress(done,
    total)`` is called after each saved chunk.  Returns the flat physical accumulator on the
    tensors' device.
    """
    device = next(field.device(t) for t in tensors if t is not None)
    total = 2 ** num_sliced
    chunk = chunk or max(1, total // 8)
    start = 0
    # the runner accumulates in the FLAT physical form, not the logical
    # output shape
    acc = field.zeros(physical_shape(output_shape), device)
    if path and os.path.exists(path):
        saved = np.load(path)
        start = int(saved["next_slice"])
        acc = _load_acc(saved, field, acc)
    while start < total:
        stop = min(start + chunk, total)
        attempt = 0
        while True:
            try:
                acc_new = run(list(tensors), range(start, stop), init=acc)
                # the copy to the host waits for the chunk: a failure
                # surfaces here, not at the save
                acc_host = tuple(c.cpu().numpy()
                                 for c in field.buffers(acc_new))
                break
            except (TypeError, ValueError):
                raise       # a wrong call: retrying cannot help
            except Exception as e:
                attempt += 1
                logging.getLogger(__name__).warning(
                    "slice chunk [%d, %d) failed (attempt %d/%d): %r",
                    start, stop, attempt, max_retries, e)
                if attempt > max_retries:
                    raise
        acc = acc_new
        if path:
            _atomic_save(path, acc_host, stop)
        if progress is not None:
            progress(stop, total)
        start = stop
    if path and os.path.exists(path):
        os.remove(path)
    return acc


def _load_acc(saved, field, empty):
    """The saved accumulator as ``field``'s value, on ``empty``'s device
    and in its tensors' dtypes: ``acc_re`` / ``acc_im`` for a split
    field, ``acc`` for the others."""
    keys = ("acc_re", "acc_im") if "acc_im" in saved else ("acc",)
    like = field.buffers(empty)
    if len(keys) != len(like):
        raise ValueError(f"the checkpoint holds {', '.join(keys)}: not a "
                         f"{field.mode} field's accumulator")
    return field.join(tuple(
        torch.from_numpy(np.ascontiguousarray(saved[k]))
        .to(device=c.device, dtype=c.dtype) for k, c in zip(keys, like)))


def _atomic_save(path, acc_host, next_slice):
    """Write the checkpoint beside ``path`` and move it into place: a
    pair as ``acc_re`` / ``acc_im``, one array as ``acc``."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        if len(acc_host) == 2:
            np.savez(tmp, acc_re=acc_host[0], acc_im=acc_host[1],
                     next_slice=next_slice)
        else:
            np.savez(tmp, acc=acc_host[0], next_slice=next_slice)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
