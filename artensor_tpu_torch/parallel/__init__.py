"""Multi-device runs: the slice mesh, the output-sharded dense state and
batch dispatch.

Port of ``artensor_tpu/parallel/__init__.py`` (``make_mesh``,
``run_sliced_contraction``, ``run_output_sharded``, ``dispatch_batches``).
The JAX package traces one ``shard_map`` program over a device mesh and
sums the devices' partial slice sums with ``lax.psum``.  Here a mesh
(``Mesh``) is an ordered list of replicas, each a ``torch.device``; a
device may repeat (two replicas on one card stand in for two cards, and
the CPU tests build their meshes so).  Each replica has its own copy of
the staged tensors (one copy per distinct device, shared by the replicas
on it) and its own sliced runner (``executor.make_sliced_runner``), so
its own CUDA graphs and memory pool.  Replica ``d`` of ``n`` sums the
contiguous slice ids ``range(d*total//n, (d+1)*total//n)``, the JAX
package's rule in ``run_segmented_sharded``; JAX pads the ids to equal
shares and masks the padding, which ``shard_map``'s equal shapes need and
a runner that sums any id list does not.  A replica with no ids launches
nothing.  On the card every replica's graphs are captured first, one
replica after another (a capture fails if another thread works on the
card meanwhile), then each replica replays its groups in a host thread of
its own (a replay waits for its card, so one thread would run the cards
one after another); on the CPU the replicas run in turn.  The partial
sums are copied to the first replica's device and added in replica
order.  A mesh across processes (``distributed.global_mesh``) names its
``torch.distributed`` process group: its devices are this process's
replicas, the slice ids are laid out process-major, and the sum is
all-reduced over the group (``field.psum``).

``LAST_RUN``: the last run's replicas (device, slice ids or blocks,
width, captures, replays, capture and run seconds); the host seconds of
their preparation (placement, captures: ``prepare_s``), of their runs
until the result is on the first device (``run_s``: on the card the
replays, to a synchronize) and of the all-reduce (``psum_s``).
"""

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import torch

from ..ops.field import make_field
from ..runtime.executor import execute_dense, make_sliced_runner
from ..runtime.lowering import physical_shape

LAST_RUN = {}


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the replicas' ``devices`` in order and the axis name;
    for a mesh across processes also the ``torch.distributed`` process
    ``group``, this process's ``rank`` in it and its ``size`` (no group,
    rank 0 and size 1 within one process).  Every process of a group
    holds the same number of replicas."""

    devices: tuple
    axis_name: str = "slice"
    group: object = None
    rank: int = 0
    size: int = 1

    @property
    def n_replicas(self):
        """The replicas of every process of the mesh."""
        return self.size * len(self.devices)


def _as_device(d):
    """A ``torch.device``; a card without an index is the current one."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices=None, axis_name="slice", devices=None):
    """1-D mesh over the first ``n_devices`` cards (all of them by
    default), or over ``devices`` in order, which may name one device
    more than once (two replicas on one card; the CPU).  Raises where
    there is no card or fewer than asked: a mesh never shrinks and never
    moves to the CPU unasked."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for a mesh; "
                               "pass devices=[...] to name its devices")
        devices = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in devices]
    devices = [_as_device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"a mesh of {n_devices} devices asked for, "
                             f"{len(devices)} available")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices), axis_name)


def _placer(tensors, field):
    """``place(device)``: the staged ``tensors`` on ``device``: the
    tensors themselves on their own device, elsewhere a copy made once
    per device."""
    src = next(field.device(t) for t in tensors if t is not None)
    copies = {str(src): list(tensors)}

    def place(dev):
        key = str(dev)
        if key not in copies:
            copies[key] = [None if t is None else field.join(
                tuple(c.to(dev) for c in field.buffers(t))) for t in tensors]
        return copies[key]

    return place


def _on(dev):
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _call_on(dev, fn):
    with _on(dev):
        return fn()


def _run_replicas(jobs):
    """``jobs``: ``(device, prepare)`` pairs; ``prepare()`` makes what a
    replica runs (its placement, its graphs' capture) and returns it, a
    callable of no argument.  Every ``prepare`` runs first, in turn, in
    this thread; then the runs: on cards each in a host thread of its
    own under its device, elsewhere in turn.  Returns the runs' results in
    order, the seconds of the preparations and the clock at the runs'
    start; a replica's error is raised here, once every replica has
    ended."""
    t0 = time.perf_counter()
    runs = [(dev, _call_on(dev, prepare)) for dev, prepare in jobs]
    t1 = time.perf_counter()
    if len(runs) < 2 or any(dev.type != "cuda" for dev, _ in runs):
        return [_call_on(dev, run) for dev, run in runs], t1 - t0, t1
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = [pool.submit(_call_on, dev, run) for dev, run in runs]
        return [f.result() for f in futures], t1 - t0, t1


def _replica_stats(dev, run, **extra):
    keys = ("captures", "replays", "warmup_groups", "capture_s", "run_s")
    return dict(device=str(dev), **extra, **{k: run.stats[k] for k in keys})


def run_sliced_contraction(tensors, steps, slicing_axes, num_sliced,
                           output_shape, mesh, field=None,
                           execute=execute_dense, axis_name="slice",
                           slice_batch=1):
    """The sum over all 2^k slices, its slice ids partitioned over the
    mesh's replicas (contiguous ranges, process-major across processes);
    each replica runs its range at width ``slice_batch`` (the runner's
    width: the JAX package's mesh runs drop it), the partials are added
    on ``mesh.devices[0]`` in replica order and, across processes,
    all-reduced over the mesh's group.  With nothing sliced the run is
    made once, by the first replica.  ``tensors``: the staged tensors
    (flat physical, on any device).  Returns the flat physical sum on
    ``mesh.devices[0]`` (on every process)."""
    field = field or make_field()
    total, n = 2 ** num_sliced, mesh.n_replicas
    first = mesh.rank * len(mesh.devices)
    place = _placer(tensors, field)
    jobs, stats = [], []
    for d, dev in enumerate(mesh.devices):
        g = first + d
        if num_sliced:
            ids = range(g * total // n, (g + 1) * total // n)
            if not len(ids):
                continue
        elif g:
            continue
        else:
            ids = None
        run = make_sliced_runner(execute, steps, slicing_axes, num_sliced,
                                 output_shape, field, slice_batch=slice_batch)

        def prepare(run=run, dev=dev, ids=ids):
            arrays = place(dev)
            run.capture(arrays, ids)
            return lambda: run(arrays, ids)

        jobs.append((dev, prepare))
        stats.append((dev, run, ids))
    parts, prepare_s, t_run = _run_replicas(jobs)
    root = mesh.devices[0]
    acc = None
    for p in parts:
        p = field.join(tuple(c.to(root) for c in field.buffers(p)))
        acc = p if acc is None else field.add(acc, p)
    if acc is None:     # this process's replicas have no slice to sum
        acc = field.zeros(physical_shape(output_shape), root)
    if root.type == "cuda":
        torch.cuda.synchronize(root)
    run_s = time.perf_counter() - t_run
    psum_s = None
    if mesh.group is not None:
        t0 = time.perf_counter()
        acc = field.psum(acc, mesh.group)
        if root.type == "cuda":
            torch.cuda.synchronize(root)
        psum_s = time.perf_counter() - t0
    LAST_RUN.clear()
    LAST_RUN.update(
        replicas=[_replica_stats(dev, run, slices=len(ids) if ids else 1,
                                 first_slice=ids.start if ids else 0,
                                 slice_batch=slice_batch)
                  for dev, run, ids in stats],
        prepare_s=prepare_s, run_s=run_s, psum_s=psum_s)
    return acc


def run_output_sharded(tensors, steps, slicing_axes, d_out, k_sum,
                       local_output_shape, mesh, field=None,
                       execute=execute_dense, axis_name="slice"):
    """A dense state with its output sharded over the mesh's replicas.

    The first ``d_out`` entries of ``slicing_axes`` select open output
    legs: each of their 2^d_out assignments gives a disjoint block of the
    state, so blocks are computed by different replicas and never summed;
    each block is the sum of its ``2**k_sum`` slices (ids ``oid *
    2**k_sum + j``), one at a time.  Replica ``d`` computes the blocks
    ``range(d*per, (d+1)*per)``, ``per = 2**d_out / n`` (raises
    ``ValueError`` unless ``n`` divides 2^d_out).  Returns one tensor a
    replica, on that replica's device, holding its blocks stacked on a
    leading axis, each flat physical in ``local_output_shape``: no device
    holds the whole state."""
    field = field or make_field()
    n, total_out = len(mesh.devices), 2 ** d_out
    if total_out % n:
        raise ValueError(f"the {total_out} output blocks do not divide over "
                         f"{n} replicas")
    per, span = total_out // n, 2 ** k_sum
    phys = physical_shape(local_output_shape)
    place = _placer(tensors, field)
    jobs, stats = [], []
    for d, dev in enumerate(mesh.devices):
        oids = range(d * per, (d + 1) * per)
        run = make_sliced_runner(execute, steps, slicing_axes, d_out + k_sum,
                                 local_output_shape, field)

        def prepare(run=run, dev=dev, oids=oids):
            arrays = place(dev)
            run.capture(arrays, range(oids[0] * span, (oids[0] + 1) * span))

            def blocks():
                out = field.zeros((per,) + phys, dev)
                for i, oid in enumerate(oids):
                    block = run(arrays, range(oid * span, (oid + 1) * span))
                    for o, b in zip(field.buffers(out),
                                    field.buffers(block)):
                        o.view(per, -1)[i].copy_(b.reshape(-1))
                    del block
                return out
            return blocks

        jobs.append((dev, prepare))
        stats.append((dev, run, oids))
    parts, prepare_s, t_run = _run_replicas(jobs)
    LAST_RUN.clear()
    LAST_RUN.update(
        replicas=[_replica_stats(dev, run, blocks=len(oids),
                                 first_block=oids.start)
                  for dev, run, oids in stats],
        prepare_s=prepare_s, run_s=time.perf_counter() - t_run, psum_s=None)
    return parts


def dispatch_batches(make_runner, batch_plans, devices=None):
    """The second parallel axis: independent batch groups (each its own
    compiled scheme) run on different devices at once.  Group ``g`` goes
    to ``devices[g % n]`` (default: every card, ``make_mesh``).

    ``make_runner(plan) -> callable(device)``: the callable builds the
    group's run with its inputs placed on ``device`` and returns it, a
    callable of no argument that returns the group's result (in the JAX
    package it returns the run's futures).  Every group is built and
    launched before any result is waited on: the callables are called in
    group order (staging, a graph's capture: a capture cannot overlap
    other work on the card), then every run starts, each in a host thread
    under its device (in turn where a device is not a card).  Returns the
    results in group order; ``LAST_RUN`` has the seconds of the builds
    (``prepare_s``) and of the runs (``run_s``)."""
    devices = make_mesh().devices if devices is None \
        else [_as_device(d) for d in devices]
    jobs = [(devices[g % len(devices)],
             lambda plan=plan, dev=devices[g % len(devices)]:
             make_runner(plan)(dev))
            for g, plan in enumerate(batch_plans)]
    out, prepare_s, t_run = _run_replicas(jobs)
    LAST_RUN.clear()
    LAST_RUN.update(replicas=[], prepare_s=prepare_s,
                    run_s=time.perf_counter() - t_run, psum_s=None)
    return out
