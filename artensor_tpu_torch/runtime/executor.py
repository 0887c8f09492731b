"""Executors: stage a network, fold static steps, and run the 2^k slice loop.

Port of ``artensor_tpu/runtime/executor.py`` (``stage_tensors``,
``precompute_static_steps``, the dense executor ``apply_dense_step`` /
``execute_dense`` / ``tensor_contraction``, ``slice_select``,
``build_slicing_axes`` and the sliced runner, which drives the dense and
the sparse executors alike).  The JAX package traces the slice loop into
one XLA program (``lax.scan`` over ``jax.vmap``-ed groups, ``jax.jit``).
Here the runner walks groups of ``slice_batch`` slices; on a CUDA device
it captures one group (slice selection, every step, the width reduction
and the accumulation into a static accumulator) as a CUDA graph and
replays it for every group, with the group's slice ids copied into a
static id buffer before each replay (``GroupRunner``, which also drives
the segmented and the rescaled runs): the card runs every step without
the host in between, the counterpart of the one XLA program.  On the
CPU, or when asked (``eager=True``), it runs every step eagerly from the
Python loop: the plain version of the graph run, which the tests and the
card's graph-against-eager check use.
In place of ``vmap``, slice-dependent buffers carry an explicit leading
width axis of ``slice_batch`` instances; slice-invariant buffers stay
unbatched, and every step (dot fallback or kernel) reads them once for all
instances.  Slice bits are taken MSB-first, as in the reference.
"""

import numpy as np
import torch

from ..ops.field import SplitField
from . import tracing
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
    Returns ``(result, result_is_batched)``.  Each step runs in a ``step``
    span while tracing is enabled (``sparse.step_span``)."""
    from .sparse import step_span

    bufs = list(tensors)
    bat = set(batched)
    last = 0
    for n, s in enumerate(steps):
        bi, bj = s.i in bat, s.j in bat
        with step_span(n, s, field):
            bufs[s.i] = apply_dense_step(field, bufs[s.i], bufs[s.j], s,
                                         bi, bj)
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


def reduce_group(field, part, is_batched, width, phys_out):
    """A slice group's result summed over its ``width`` instances, flat
    physical: a result without the width axis is the same for every
    instance (scaled by the width)."""
    if not is_batched:
        return field.scale(field.reshape(part, phys_out), width)
    if width > 1:
        return field.sum0(field.reshape(part, (width,) + phys_out))
    return field.reshape(part, phys_out)   # drop the width axis, no copy


_STREAM = {}


def capture_stream(device):
    """The side stream every capture (and the warm-up before it) runs on,
    one per device: captures that share a memory pool must share their
    stream, and the warm-up makes the stream's cuBLAS workspace before the
    capture needs it."""
    key = str(device)
    if key not in _STREAM:
        _STREAM[key] = torch.cuda.Stream(device)
    return _STREAM[key]


def on_capture_stream(fn, device):
    """Run ``fn()`` eagerly on the capture stream, ordered after the work
    already queued on the current stream and before the work queued after
    it; returns its result."""
    stream = capture_stream(device)
    cur = torch.cuda.current_stream(device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        out = fn()
    cur.wait_stream(stream)
    return out


def out_of_memory(e):
    """True if a ``torch.cuda.OutOfMemoryError`` is on the exception's
    chain (``__cause__``, else ``__context__``): the end of a failed
    capture may raise its own error on top of it."""
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, torch.cuda.OutOfMemoryError):
            return True
        e = e.__cause__ or e.__context__
    return False


class CaptureOutOfMemory(Exception):
    """The card ran out of memory in a slice group's warm-up or while its
    graph ``segment`` was captured: nothing has been accumulated, so a
    caller may retry at a smaller width."""

    def __init__(self, segment, cause):
        self.segment = segment
        self.cause = cause
        super().__init__(f"segment {segment} failed to capture: {cause}")


class GroupGraphs:
    """A slice group's work captured as CUDA graphs, in order, sharing one
    memory pool (``torch.cuda.graph_pool_handle``, or ``pool``): the
    graphs are replayed in the order they were captured, so memory that
    one frees is reused by the next, as donation does between JAX's
    programs.  The graphs of another width of the same run may share the
    pool: only one group runs at a time, and no buffer of a group
    outlives it."""

    def __init__(self, device, pool=None):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self.graphs = []

    def capture(self, fn):
        """Capture ``fn()`` as the next graph."""
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=self.pool,
                              stream=capture_stream(self.device)):
            fn()
        self.graphs.append(g)

    def replay(self):
        for g in self.graphs:
            g.replay()


def _key(tensors, field):
    """What a capture depends on: the staged buffers' addresses."""
    return tuple(tuple(c.data_ptr() for c in field.buffers(t))
                 for t in tensors if t is not None)


def _device(tensors, field):
    return next(field.device(t) for t in tensors if t is not None)


def slice_ids_tensor(slice_ids, n_slices, device):
    """The slice ids to sum as an int64 tensor on ``device``: all
    ``n_slices`` by default; a ``range`` is made on the device (no
    upload)."""
    if slice_ids is None:
        return torch.arange(n_slices, device=device)
    if isinstance(slice_ids, range):
        return torch.arange(slice_ids.start, slice_ids.stop,
                            slice_ids.step, device=device)
    return torch.as_tensor(np.asarray(slice_ids),
                           dtype=torch.long).to(device)


def add_into(acc, part):
    """The summing runs' combine: ``part`` added into ``acc`` in place."""
    for a, p in zip(acc, part):
        a.add_(p)


def group_widths(n, width):
    """``[(w, groups)]``: how a run of ``n`` slice ids is walked at
    ``width``: ``n // width`` groups of ``width``, then the rest, if any,
    as one group of its own width (the largest that divides it).  A
    checkpointed run resumes at any slice, so a chunk need not be a
    multiple of the width."""
    out = [(width, n // width)] if n >= width else []
    if n % width:
        out.append((n % width, 1))
    return out


class GroupRunner:
    """Runs a slice group's work for every group of a run and combines the
    groups' parts into one accumulator, for the sliced, the segmented and
    the rescaled runs alike, on the values of any ``field``.

    ``segments``: callables ``seg(tensors, table)``, run in order on one
    group; ``table`` starts as ``{"ids": ids}`` (the group's slice ids,
    None with nothing sliced), carries buffers from a segment to the next,
    and the last segment leaves the group's part, a tuple of tensors
    (``field.buffers`` of a value, and any extra), under ``"part"``.
    ``combine(acc, part)`` folds a part into the accumulator in place;
    ``acc_spec``: the accumulator's tensors as ``(shape, empty value,
    dtype)``.

    The ``n`` slice ids of a call run as ``group_widths(n, width)``: groups
    of the width, and a last group of the rest where the width does not
    divide ``n``.  On a CUDA device (unless ``eager``) the first group of
    each width used runs once eagerly on the capture stream as a warm-up
    (it makes every device table the steps use, loads the kernels and the
    stream's cuBLAS workspace, and is discarded), then each segment is
    captured as a CUDA graph, one pool for every graph of the run
    (``GroupGraphs``), the last one folding the part into the static
    accumulator all widths share; every group of this and later calls
    copies its ids into its width's static id buffer and replays that
    width's graphs, as long as the staged buffers (by ``data_ptr``) are
    the same, else it captures anew.  With nothing sliced the run is one
    group whose part is the result (no accumulator).  Results are copies,
    never the graphs' static buffers.  An out-of-memory error in the
    warm-up or a capture raises ``CaptureOutOfMemory``; any other failure
    propagates; nothing falls back to the eager run.  Elsewhere every
    group runs eagerly: the plain version of the graph run.  ``stats``:
    captures (one per width), replays, warm-up groups, capture seconds
    (warm-up included: the ``runner.capture`` spans), and ``run_s``, the
    last call's ``runner.call`` span less the captures it made (on the
    card to a synchronize).

    Spans (``tracing``): a capture is a set-up span, ``runner.capture``
    (``runner.warmup``, then one ``runner.graph`` a segment); a call is
    ``runner.call``, and while tracing is enabled its parts under it:
    ``runner.key`` (the staged buffers' addresses), ``runner.ids`` (the
    slice ids made, and copied into a width's static buffer),
    ``runner.reset`` (the accumulator), ``runner.replay`` (one a group:
    the graph launch) or, eagerly, ``runner.group``, ``runner.clone``
    (the result copied out of the graphs' buffers) and ``runner.sync``.
    The counter ``runner.recaptures`` counts captures made anew because
    the staged buffers moved."""

    def __init__(self, field, segments, combine, acc_spec, width=1,
                 eager=False):
        self.field, self.segments, self.combine = field, segments, combine
        self.acc_spec = acc_spec
        self.width, self.eager = width, eager
        self.stats = dict(captures=0, replays=0, warmup_groups=0,
                          capture_s=0.0, run_s=0.0)
        self._caps = {}         # width -> its captured graphs
        self._cap_key = None
        self._acc = self._pool = None

    def _group(self, tensors, ids):
        table = {"ids": ids}
        for seg in self.segments:
            seg(tensors, table)
        return table["part"]

    def _empty(self, device):
        return tuple(torch.full(shape, v, dtype=dt, device=device)
                     for shape, v, dt in self.acc_spec)

    def __call__(self, tensors, ids=None, init=None, progress=None):
        """``init`` (tensors as ``acc_spec``; default the empty
        accumulator) combined with every group's part over the slice ids
        ``ids`` (an int64 tensor on the tensors' device, or a callable
        that makes it from the device; None: nothing sliced, one group).
        ``progress(done, total)`` after each group."""
        with tracing.timed("runner.call") as call:
            captured = self.stats["capture_s"]
            device = _device(tensors, self.field)
            if callable(ids):
                with tracing.hot("runner.ids"):
                    ids = ids(device)
            plan = self.capture(tensors, ids)
            if device.type == "cuda" and not self.eager:
                acc = self._replay(plan, ids, init, device, progress)
            else:
                acc = self._eager(plan, tensors, ids, init, device,
                                  progress)
        self.stats["run_s"] = call.seconds - (self.stats["capture_s"]
                                              - captured)
        return acc

    def _eager(self, plan, tensors, ids, init, device, progress):
        n = 1 if ids is None else len(ids)
        with tracing.hot("runner.reset"):
            acc = None if init is None else tuple(c.clone() for c in init)
            if acc is None and ids is not None:
                acc = self._empty(device)
        g0 = 0
        for w, groups in plan:
            for _ in range(groups):
                with tracing.hot("runner.group"):
                    part = self._group(tensors, None if ids is None
                                       else ids[g0:g0 + w])
                    if acc is None:
                        acc = part
                    else:
                        self.combine(acc, part)
                g0 += w or 1
                if progress is not None:
                    progress(g0, n)
        if device.type == "cuda":
            with tracing.hot("runner.sync"):
                torch.cuda.synchronize(device)
        return acc

    def capture(self, tensors, ids=None):
        """Make, without running the call, the graphs that a call over
        ``ids`` replays (on a CUDA device, unless ``eager``; elsewhere
        nothing): each width of its groups that is not captured yet for
        these staged buffers.  The multi-device runs capture every
        replica first, one after another, then replay them in threads:
        a capture fails if another thread works on the card meanwhile.
        Returns the call's groups, ``[(width, groups)]``."""
        device = _device(tensors, self.field)
        if ids is not None and len(ids) == 0:
            raise ValueError("no slice ids to sum")
        plan = [(None, 1)] if ids is None \
            else group_widths(len(ids), self.width)
        if device.type == "cuda" and not self.eager:
            with tracing.hot("runner.key"):
                key = _key(tensors, self.field)
            if key != self._cap_key:
                if self._cap_key is not None:
                    tracing.count("runner.recaptures")
                torch.cuda.synchronize(device)
                self._caps.clear()  # the old graphs and their pool go first
                self._acc = self._pool = None
                self._cap_key = key
            for w, _ in plan:
                if w not in self._caps:
                    self._capture(tensors, ids, w, device)
        return plan

    def _capture(self, tensors, ids, w, device):
        torch.cuda.synchronize(device)
        with tracing.span("runner.capture", width=w) as span:
            sel = None if ids is None else ids[:w].clone()
            with tracing.span("runner.warmup"):
                try:
                    on_capture_stream(lambda: self._group(tensors, sel),
                                      device)
                except Exception as e:
                    if out_of_memory(e):
                        raise CaptureOutOfMemory(0, e) from e
                    raise
                torch.cuda.synchronize(device)
            self.stats["warmup_groups"] += 1
            if self._acc is None and ids is not None:
                self._acc = self._empty(device)
            acc = self._acc
            graphs = GroupGraphs(device, self._pool)
            self._pool = graphs.pool
            table = {}
            last = len(self.segments) - 1
            for si, seg in enumerate(self.segments):
                def body(si=si, seg=seg):
                    if si == 0:
                        table["ids"] = sel
                    seg(tensors, table)
                    if si == last:
                        part = table.pop("part")
                        table.clear()   # no buffer of the group outlives it
                        if acc is None:
                            table["out"] = part
                        else:
                            self.combine(acc, part)

                with tracing.span("runner.graph", segment=si):
                    try:
                        graphs.capture(body)
                    except Exception as e:
                        if out_of_memory(e):
                            raise CaptureOutOfMemory(si, e) from e
                        raise
            self.stats["captures"] += 1
        self.stats["capture_s"] += span.seconds
        self._caps[w] = dict(graphs=graphs, ids=sel, out=table.get("out"))

    def _replay(self, plan, ids, init, device, progress):
        if ids is None:
            cap = self._caps[None]
            with tracing.hot("runner.replay"):
                cap["graphs"].replay()
            self.stats["replays"] += 1
            with tracing.hot("runner.clone"):
                acc = tuple(c.clone() for c in cap["out"])
            if init is not None:
                self.combine(acc, init)
        else:
            acc, n = self._acc, len(ids)
            with tracing.hot("runner.reset"):
                if init is None:
                    for c, (_, v, _dt) in zip(acc, self.acc_spec):
                        c.fill_(v)
                else:
                    for c, v in zip(acc, init):
                        c.copy_(v)
            g0 = 0
            for w, groups in plan:
                cap = self._caps[w]
                for _ in range(groups):
                    with tracing.hot("runner.ids"):
                        cap["ids"].copy_(ids[g0:g0 + w])
                    with tracing.hot("runner.replay"):
                        cap["graphs"].replay()
                    self.stats["replays"] += 1
                    g0 += w
                    if progress is not None:
                        progress(g0, n)
            with tracing.hot("runner.clone"):
                acc = tuple(c.clone() for c in acc)
        with tracing.hot("runner.sync"):
            torch.cuda.synchronize(device)
        if ids is None and progress is not None:
            progress(1, 1)
        return acc


def sum_spec(field, phys_out):
    """A summed accumulator's ``acc_spec``: ``field.zeros``' tensors."""
    return [(tuple(c.shape), 0.0, c.dtype)
            for c in field.buffers(field.zeros(phys_out, "meta"))]


def make_sliced_runner(execute, steps, slicing_axes, num_sliced,
                       output_shape, field, slice_batch=1, eager=False):
    """fn(tensors, slice_ids=None, init=None) -> ``init`` (default zero)
    plus the sum over the slices ``slice_ids`` (default all 2^k) of
    ``execute(sliced, steps)``.

    Drives the dense (``execute_dense``) and the sparse
    (``sparse.execute_sparse``) executors.  ``output_shape`` is LOGICAL;
    the result uses the flat physical form.  ``slice_batch`` slices run
    per group as one width-``slice_batch`` pass; it must divide the 2^k
    slices, and a subset of them that it does not divide runs its rest
    as one narrower group (``group_widths``).  Peak memory grows with
    it.  ``slice_ids``
    (a range or a sequence of ints) sums a subset: the
    dense output-block walk passes the ids of one block, the
    checkpointed run a chunk.  ``init``: the accumulator to add to (flat
    physical form), as JAX's runner takes it.

    On a CUDA device a group (slice selection, every step, the width sum,
    the accumulation) is one CUDA graph, replayed for every group
    (``GroupRunner``); with nothing sliced the whole execution is one
    graph.  ``eager`` (or a CPU device): every step runs from the host.
    ``fn.stats``: the ``GroupRunner``'s.  ``fn.capture(tensors,
    slice_ids=None)``: the graphs a call over those ids replays, made
    without running it (``GroupRunner.capture``).
    """
    phys_out = physical_shape(output_shape)
    n_slices = 2 ** num_sliced
    if slice_batch < 1 or n_slices % slice_batch:
        raise ValueError(f"slice_batch {slice_batch} must divide the "
                         f"{n_slices} slices")

    def group(tensors, table):
        """One group's part, reduced over its width, flat physical."""
        if not num_sliced:
            out, _ = execute(tensors, steps, field)
            table["part"] = field.buffers(field.reshape(out, phys_out))
            return
        ids = table["ids"]
        sliced, batched = slice_select(tensors, slicing_axes, ids,
                                       num_sliced, field)
        part, is_batched = execute(sliced, steps, field, batched)
        table["part"] = field.buffers(reduce_group(
            field, part, is_batched, ids.shape[0], phys_out))

    runner = GroupRunner(field, [group], add_into,
                         sum_spec(field, phys_out), slice_batch, eager)

    def ids_of(tensors, slice_ids):
        return slice_ids_tensor(slice_ids, n_slices,
                                _device(tensors, field)) \
            if num_sliced else None

    def run(tensors, slice_ids=None, init=None):
        # the ids are made inside the runner's call span
        ids = (lambda device: slice_ids_tensor(slice_ids, n_slices, device)) \
            if num_sliced else None
        return field.join(runner(
            tensors, ids, None if init is None else field.buffers(init)))

    run.capture = lambda tensors, slice_ids=None: runner.capture(
        tensors, ids_of(tensors, slice_ids))
    run.stats = runner.stats
    return run


def make_sliced_contraction(steps, slicing_axes, num_sliced, output_shape,
                            field, slice_batch=1, eager=False):
    """The dense path's sliced runner (see ``make_sliced_runner``)."""
    return make_sliced_runner(execute_dense, steps, slicing_axes,
                              num_sliced, output_shape, field, slice_batch,
                              eager)
