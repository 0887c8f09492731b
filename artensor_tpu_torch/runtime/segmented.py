"""Segmented execution: a long scheme walked as several CUDA graphs.

Port of ``artensor_tpu/runtime/segmented.py`` (``_segment_io``,
``SegmentAuditExceeded``, ``SegmentCompileFailed``,
``make_segmented_executor``, ``_is_device_oom``, ``run_segmented``).  The
JAX package compiles a scheme above ``simulation.SEGMENT_AUTO_THRESHOLD``
steps as one program per ``segment_steps`` steps, because one XLA program
of many hundred steps compiles for too long.  Here each segment of a slice
group is captured as one CUDA graph; all of a run's graphs share one
memory pool and are captured and replayed in the same order
(``executor.GroupRunner``), so the memory a segment frees (its consumed
inputs) is reused by the next, as donation does between JAX's programs.
The first segment's graph also selects the group's slices from the static
id buffer, the last one reduces the group over its width and adds it to
the accumulator; the host replays the graphs, group after group.  On the
CPU the segments run eagerly.

Before any buffer is made, each segment's peak is audited
(``make_segmented_executor``): the device peak model
(``metrics.scheme_device_peak_bytes``) of its steps plus the buffers held
across it, against ``planner/cost.HBM_BUDGET_BYTES``; this takes the place
of XLA's ``memory_analysis()``.  At width > 1, an audit over budget or a
``torch.cuda.OutOfMemoryError`` while a segment is captured halves the
width and starts again, as does a device out-of-memory error during the
run (the backstop).  Any other error propagates.
``run_segmented_sharded`` partitions the slice ids over a mesh's
replicas, one ``run_segmented`` each.
"""

import logging

import torch

from ..planner import cost
from .executor import (CaptureOutOfMemory, GroupRunner, _device, add_into,
                       apply_dense_step, reduce_group, slice_ids_tensor,
                       slice_select, sum_spec)
from .lowering import physical_shape
from .sparse import apply_sparse_step

__all__ = ["SegmentAuditExceeded", "SegmentCompileFailed", "LAST_RUN",
           "apply_dense_step", "apply_sparse_step", "make_segmented_executor",
           "run_segmented", "run_segmented_sharded", "segment_peak_bytes"]

# the last run_segmented call: its width, segments, whether it ran as
# graphs, its group replays and warm-up groups, the seconds of its
# captures (warm-up group included) and of its group loop (``replay_s``:
# on the card the graph replays, to a synchronize)
LAST_RUN = {}


def _segment_io(segments, n_bufs):
    """Per-segment (inputs, outputs): which buffer ids a segment consumes
    from the buffer table and which it must hand back."""
    reads_later = [set() for _ in segments]
    acc = set()
    final_id = segments[-1][-1].i
    acc.add(final_id)
    for s in range(len(segments) - 1, -1, -1):
        reads_later[s] = set(acc)
        for st in segments[s]:
            acc.add(st.i)
            acc.add(st.j)
    io = []
    for s, seg in enumerate(segments):
        produced = set()
        inputs = []
        for st in seg:
            for tid in (st.i, st.j):
                if tid not in produced and tid not in inputs:
                    inputs.append(tid)
            produced.add(st.i)
        needed_after = reads_later[s]  # = final ∪ reads of segments after s
        outputs = [tid for tid in sorted(produced) if tid in needed_after]
        io.append((inputs, outputs))
    return io, final_id


class SegmentAuditExceeded(Exception):
    """The audit found a segment whose modeled peak (the device peak
    model of its steps plus the buffers held across it) exceeds the
    budget: raised before any device work."""

    def __init__(self, segment, peak_bytes, budget_bytes):
        self.segment = segment
        self.peak_bytes = peak_bytes
        self.budget_bytes = budget_bytes
        super().__init__(
            f"segment {segment} needs {peak_bytes / 2**30:.2f} GiB "
            f"(device peak model + held buffers) of "
            f"{budget_bytes / 2**30:.2f} GiB")


class SegmentCompileFailed(Exception):
    """The card ran out of memory while a segment's graph was captured
    (or during the warm-up group before the captures): nothing has been
    accumulated, so the caller retries at a smaller width; at width 1
    the cause propagates."""

    def __init__(self, segment, cause):
        self.segment = segment
        self.cause = cause
        super().__init__(f"segment {segment} failed to capture: {cause}")


def segment_peak_bytes(segments, width, slicing_axes, bytes_per_elem=4.0):
    """Each segment's modeled device peak at ``width``: the device peak
    model of its steps (``metrics.scheme_device_peak_bytes``, with every
    buffer that varies by slice, by the whole scheme, counted per
    instance) plus the buffers held across it (alive, read by a later
    segment or the final result, not by this one)."""
    from .metrics import (_lows, _prod, scheme_device_peak_bytes,
                          slice_dynamic_ids)

    steps = [st for seg in segments for st in seg]
    dyn = slice_dynamic_ids(steps, slicing_axes or ())
    seeds = [[(t,) for t in sorted(dyn)]]
    size = {}       # elements each slot holds: leaves at first use
    for st in steps:
        lows = _lows(st)
        if getattr(st, "gathers", None) is not None:
            si = sum(_prod(low.shape_l) for low in lows)
            sj = sum(_prod(low.shape_r) for low in lows)
        else:
            a, b = _prod(lows[0].shape_l), _prod(lows[0].shape_r)
            si, sj = (b, a) if lows[0].swapped else (a, b)
        size.setdefault(st.i, si)
        size.setdefault(st.j, sj)
    final_id = segments[-1][-1].i
    dead, peaks = set(), []
    for n, seg in enumerate(segments):
        reads = {t for st in seg for t in (st.i, st.j)}
        later = {t for sg in segments[n + 1:] for st in sg
                 for t in (st.i, st.j)} | {final_id}
        held = sum(size[t] * (width if t in dyn else 1) for t in size
                   if t not in dead and t not in reads and t in later)
        peaks.append(scheme_device_peak_bytes(seg, width, seeds,
                                              bytes_per_elem)
                     + 2 * bytes_per_elem * held)
        for st in seg:
            size[st.i] = sum(_prod(low.phys_y) for low in _lows(st))
            dead.add(st.j)
    return peaks


def make_segmented_executor(steps, apply_step, field, segment_steps=64,
                            width=1, slicing_axes=(), hbm_budget_bytes=None):
    """Build ``(run_once, final_id)``: ``run_once(bufs, batched)`` runs
    every segment on the buffer table ``bufs`` (a dict id -> value,
    mutated; ``batched``: the ids that carry a leading width axis,
    updated) and returns ``(final_buffer, final_is_batched)``.
    ``run_once.segments`` holds one callable per segment, ``fn(bufs,
    batched)``, which runs that segment's steps and drops the inputs it
    does not hand back (``_segment_io``).

    ``hbm_budget_bytes``: each segment's modeled peak at ``width``
    (``segment_peak_bytes``) is audited against it here, before any
    buffer is made; over budget raises ``SegmentAuditExceeded``."""
    segments = [list(steps[i:i + segment_steps])
                for i in range(0, len(steps), segment_steps)]
    io, final_id = _segment_io(segments, None)
    if hbm_budget_bytes:
        bpe = torch.finfo(field.rdtype).bits // 8
        for si, peak in enumerate(segment_peak_bytes(
                segments, width, slicing_axes, bpe)):
            if peak > hbm_budget_bytes:
                raise SegmentAuditExceeded(si, peak, hbm_budget_bytes)

    def make(seg, inputs, outputs):
        drop = [t for t in inputs if t not in outputs]

        def fn(bufs, bat):
            for st in seg:
                bi, bj = st.i in bat, st.j in bat
                bufs[st.i] = apply_step(field, bufs[st.i], bufs[st.j], st,
                                        bi, bj)
                bufs[st.j] = None
                if bj:
                    bat.add(st.i)
            for t in drop:
                bufs[t] = None
        return fn

    fns = [make(seg, inputs, set(outputs))
           for seg, (inputs, outputs) in zip(segments, io)]

    def run_once(bufs, batched=()):
        bat = batched if isinstance(batched, set) else set(batched)
        for fn in fns:
            fn(bufs, bat)
        return bufs[final_id], final_id in bat

    run_once.segments = fns
    return run_once, final_id


def _is_device_oom(e):
    """True only for a genuine exhaustion of device memory: a
    ``torch.cuda.OutOfMemoryError`` (the caching allocator's), or a
    ``RuntimeError`` carrying CUDA's or cuBLAS's allocation failure,
    anywhere on the exception's chain.  An error that merely mentions
    memory is not one."""
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, torch.cuda.OutOfMemoryError):
            return True
        if isinstance(e, RuntimeError) and any(
                m in str(e) for m in ("CUDA error: out of memory",
                                      "CUBLAS_STATUS_ALLOC_FAILED")):
            return True
        e = e.__cause__ or e.__context__
    return False


def run_segmented(tensors, steps, slicing_axes, num_sliced, output_shape,
                  field, apply_step, segment_steps=64, progress=None,
                  slice_batch=1, slice_ids=None, audit_width=True):
    """The full contraction in segmented mode, slice group by slice group.

    ``slice_batch`` > 1 runs that many slices per group through every
    segment (the width axis of ``executor.make_sliced_runner``); peak
    memory scales with it.  ``slice_ids`` restricts the walk to a subset
    of the slice ids.  ``audit_width``: the width is first clamped by
    ``metrics.max_safe_slice_batch``, then each segment is audited at it
    (``make_segmented_executor``), and an audit over budget or an
    out-of-memory error during capture or the run halves it; False
    forces the width unaudited.  ``progress(done, total)`` after each
    group.  Returns the flat physical result on the tensors' device;
    ``LAST_RUN`` records the width used, the segments, the capture
    seconds and the replays.
    """
    log = logging.getLogger(__name__)
    device = _device(tensors, field)
    total = 2 ** num_sliced if num_sliced else 1
    ids = slice_ids_tensor(slice_ids, total, device) if num_sliced else None
    n = len(ids) if num_sliced else 1
    phys_out = physical_shape(output_shape)
    if audit_width and slice_batch > 1:
        from .metrics import max_safe_slice_batch
        safe = max_safe_slice_batch(steps, slice_batch,
                                    slicing_axes=slicing_axes)
        if safe < slice_batch:
            log.warning("segmented slice_batch %d exceeds the modeled "
                        "budget; clamping to %d", slice_batch, safe)
            slice_batch = safe

    def attempt(W):
        budget = cost.HBM_BUDGET_BYTES if audit_width and W > 1 else None
        run_once, final_id = make_segmented_executor(
            steps, apply_step, field, segment_steps, W, slicing_axes,
            budget)
        last = len(run_once.segments) - 1

        def segment(si, fn):
            def seg(tensors, table):
                if si == 0:     # the group's slices, from its ids
                    bat = ()
                    table["w"] = 1 if table["ids"] is None \
                        else table["ids"].shape[0]
                    if num_sliced:
                        tensors, bat = slice_select(
                            tensors, slicing_axes, table["ids"], num_sliced,
                            field)
                    table["bufs"], table["bat"] = dict(enumerate(tensors)), \
                        set(bat)
                fn(table["bufs"], table["bat"])
                if si == last:  # the group's part, reduced over its width
                    bufs, bat = table.pop("bufs"), table.pop("bat")
                    part = bufs.pop(final_id)
                    part = reduce_group(
                        field, part, final_id in bat, table.pop("w"),
                        phys_out) \
                        if num_sliced else field.reshape(part, phys_out)
                    table["part"] = field.buffers(part)
            return seg

        runner = GroupRunner(field, [segment(si, fn) for si, fn in
                                     enumerate(run_once.segments)],
                             add_into, sum_spec(field, phys_out), W)
        try:
            acc = field.join(runner(tensors, ids, progress=progress))
        except CaptureOutOfMemory as e:
            raise SegmentCompileFailed(e.segment, e.cause) from e.cause
        st = runner.stats
        LAST_RUN.clear()
        LAST_RUN.update(width=W, segments=last + 1,
                        graphs=device.type == "cuda",
                        capture_s=st["capture_s"], replays=st["replays"],
                        warmup_groups=st["warmup_groups"],
                        replay_s=st["run_s"])
        return acc

    W = slice_batch if slice_batch > 1 and n % slice_batch == 0 else 1
    while True:
        try:
            return attempt(W)
        except (SegmentAuditExceeded, SegmentCompileFailed) as e:
            # nothing has been accumulated: at width 1 a capture failure is
            # a real error, an audit failure means the scheme cannot run
            # segmented on this card at all
            if not (audit_width and W > 1):
                raise (e.cause if isinstance(e, SegmentCompileFailed)
                       else e)
            W //= 2
            log.warning("segmented width rejected (%s); retrying with "
                        "slice_batch=%d", str(e).splitlines()[0][:120], W)
        except Exception as e:  # noqa: BLE001 — narrowed by _is_device_oom
            if not (audit_width and W > 1 and _is_device_oom(e)):
                raise
            # the backstop: the audit passed but the allocator refused;
            # halve and restart
            W //= 2
            log.warning("segmented slice batch ran out of device memory "
                        "(%s); retrying with slice_batch=%d",
                        str(e).splitlines()[0][:120], W)


def run_segmented_sharded(tensors, steps, slicing_axes, num_sliced,
                          output_shape, field, apply_step, devices,
                          segment_steps=64, slice_batch=1):
    """Segmented execution with the slice ids partitioned over ``devices``
    (a mesh's replicas; a device may repeat): replica ``d`` of ``n`` runs
    ``run_segmented`` over ``range(d*total//n, (d+1)*total//n)`` on its
    copy of the staged tensors (one per distinct device), and the
    partials are added on ``devices[0]`` in replica order; a replica with
    no ids is skipped.  The replicas run in turn, as JAX's dispatch loop
    does (there the queues fill asynchronously): each one captures its
    segments, which cannot overlap other work on the card, and may halve
    its width.  ``LAST_RUN``: ``replicas``, each one's ``run_segmented``
    record with its device and slices, and their capture seconds and
    replays summed."""
    from ..parallel import _as_device, _on, _placer

    devices = [_as_device(d) for d in devices]
    total = 2 ** num_sliced if num_sliced else 1
    n = len(devices)
    place = _placer(tensors, field)
    acc, replicas = None, []
    for d, dev in enumerate(devices):
        ids = range(d * total // n, (d + 1) * total // n)
        if not len(ids):
            continue
        with _on(dev):
            part = run_segmented(
                place(dev), steps, slicing_axes, num_sliced, output_shape,
                field, apply_step, segment_steps, slice_batch=slice_batch,
                slice_ids=ids)
        replicas.append(dict(LAST_RUN, device=str(dev), slices=len(ids),
                             first_slice=ids.start))
        part = field.join(tuple(c.to(devices[0])
                                for c in field.buffers(part)))
        acc = part if acc is None else field.add(acc, part)
    LAST_RUN.clear()
    LAST_RUN.update(replicas=replicas,
                    capture_s=sum(r["capture_s"] for r in replicas),
                    replays=sum(r["replays"] for r in replicas))
    return acc
