"""Multi-process runs over ``torch.distributed``: the process group, the
global mesh and the sliced contraction across processes.

Port of ``artensor_tpu/parallel/distributed.py`` (``initialize``,
``global_mesh``, ``run_sliced_distributed``).  The JAX package joins a
``jax.distributed`` cluster and runs one ``shard_map`` program over the
devices of every process.  Here each process is a rank of a
``torch.distributed`` process group with its own replicas (one card by
default), runs its share of the slice ids as ``run_sliced_contraction``
runs a mesh's, and the ranks' sums are all-reduced (``field.psum``).  The
backend is the caller's: "nccl" (the default) across cards, "gloo" on the
CPU, or for ranks that share a card (NCCL refuses two ranks on one
device; gloo all-reduces card tensors through the host).  It is never
switched when NCCL is missing: that raises.

Environment variables, read where an argument is not given, as in the
JAX package:
  ARTENSOR_COORDINATOR  host:port of rank 0 (the TCP rendezvous)
  ARTENSOR_NUM_PROCS    the number of processes
  ARTENSOR_PROC_ID      this process's rank
"""

import os

import torch

# ``initialize``'s local devices, read by ``global_mesh``
_LOCAL = {}


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               local_device_ids=None, backend="nccl"):
    """Join the process group (``torch.distributed.init_process_group``
    over ``tcp://<coordinator>``), the arguments defaulting to the
    environment; returns False and does nothing for a single process (no
    coordinator, or one process), True once joined.
    ``local_device_ids``: this process's devices (card indices, or
    devices such as "cpu"); default one card, ``cuda:{rank % count}``."""
    import torch.distributed as dist

    from . import _as_device

    coordinator_address = coordinator_address or os.environ.get(
        "ARTENSOR_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("ARTENSOR_NUM_PROCS", "1"))
    if process_id is None:
        process_id = int(os.environ.get("ARTENSOR_PROC_ID", "0"))
    if num_processes <= 1 or coordinator_address is None:
        return False
    if not dist.is_available() or (backend == "nccl"
                                   and not dist.is_nccl_available()):
        raise RuntimeError(f"the {backend!r} backend of torch.distributed "
                           "is not available in this build of torch")
    _LOCAL["devices"] = None if local_device_ids is None else [
        torch.device("cuda", d) if isinstance(d, int) else _as_device(d)
        for d in local_device_ids]
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            rank=process_id, world_size=num_processes)
    return True


def global_mesh(axis_name="slice"):
    """The mesh of every process: the world group, this rank and the
    world's size, with this process's devices (``initialize``'s
    ``local_device_ids``, else ``cuda:{rank % count}``).  Outside a
    process group, ``make_mesh`` over this process's cards."""
    import torch.distributed as dist

    from . import Mesh, make_mesh

    if not dist.is_available() or not dist.is_initialized():
        return make_mesh(axis_name=axis_name)
    rank, size = dist.get_rank(), dist.get_world_size()
    devices = _LOCAL.get("devices")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "local_device_ids to initialize")
        devices = [torch.device("cuda", rank % torch.cuda.device_count())]
    return Mesh(tuple(devices), axis_name, dist.group.WORLD, rank, size)


def run_sliced_distributed(tensors, steps, slicing_axes, num_sliced,
                           output_shape, mesh, field=None, execute=None,
                           axis_name="slice", slice_batch=1):
    """The sliced contraction over a mesh across processes: call it from
    every process with the same arguments (``tensors``: this process's
    staged copy); each rank sums its contiguous, process-major share of
    the slice ids on its devices, then the ranks' sums are all-reduced
    over ``mesh.group``, outside any graph capture.  Every rank returns
    the same sum (``run_sliced_contraction``)."""
    from ..runtime.executor import execute_dense
    from . import run_sliced_contraction

    return run_sliced_contraction(
        tensors, steps, slicing_axes, num_sliced, output_shape, mesh,
        field=field, execute=execute or execute_dense, axis_name=axis_name,
        slice_batch=slice_batch)
