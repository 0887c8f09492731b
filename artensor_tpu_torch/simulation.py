"""Orchestration: circuit -> simplified network -> plan -> compiled scheme
-> sliced execution on the card.

Port of ``artensor_tpu/simulation.py``: ``TensorNetworkSimulation`` in its
two modes, fixed at construction by the bitstrings (``check_bitstrings``):
the sparse big-batch amplitudes (``simplify('sparse')``,
``runtime/sparse.py``) and the dense full amplitude ("normal":
``simplify('normal')``, ``runtime/scheme.py``), which returns the whole
``(2,)*n`` state in qubit order; and the dense single-card output-block
walk ``contraction_output_blocks``.  A simulation plans on the host
(``prepare_contraction`` under a ``PlannerConfig``: ``planner.find_order``,
the native search where it builds) or loads a saved plan (``load_plan``),
and compiles the JAX package's default scheme (gate-block fusion and
producer-order negotiation on); ``update_scheme`` recompiles for a new
batch without re-planning.  ``prepare_output_sharded`` plans the dense
state with ``d_out`` output legs removed first, so that the block walk's
memory budget applies to each block; without it the walk slices the legs
post hoc on the tree planned for the whole state.  The one-shots
``tensor_network_contraction`` and ``quantum_circuit_simulation`` plan,
compile and run in one call.
``prepare`` and ``contraction`` take the slice width the caller passes;
``runtime/metrics.dividing_slice_width`` gives the one the H100 model
picks (for the split kernels: the width and the scheme do not depend on
the field, as in the JAX package).  The entry points take the JAX
package's field options (``ops/field.make_field``): ``precision``,
``mode`` ('split', 'complex', 'fused') and ``algo``; the kernels run in
split mode only.  ``contraction`` has the JAX package's single-card modes, routed
in its order: scientific notation (``runtime/rescaled.py``),
checkpoint/resume (``runtime/checkpoint.py``), the segmented executor
for schemes above ``SEGMENT_AUTO_THRESHOLD`` device steps
(``runtime/segmented.py``), else the whole-group run; with a ``report``
and a ``profile_dir`` (``torch.profiler``).  On the card every mode runs
as CUDA-graph replay (``runtime/executor.py``).  Over a device mesh
(``parallel.make_mesh``, or ``parallel.distributed.global_mesh`` across
processes) ``contraction(mesh=...)`` partitions the slices over the
mesh's replicas (``parallel.run_sliced_contraction``, or above
``SEGMENT_AUTO_THRESHOLD`` steps ``segmented.run_segmented_sharded``),
and ``contraction_output_sharded`` computes a dense state's output blocks
on the replicas (``parallel.run_output_sharded``); the one-shots take a
``mesh`` too.
"""

import json
import logging
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from .circuits import TensorNetworkCircuit
from .network import NumericalTensorNetwork
from .plan_io import plan_from_dict
from .planner import find_order
from .runtime import tracing

# schemes above this many device steps run segmented (one CUDA graph per
# ``segment_steps`` steps, runtime/segmented.py), as in the JAX package
SEGMENT_AUTO_THRESHOLD = 256


@dataclass
class PlannerConfig:
    """The planner's knobs in one place (``find_order``'s keywords)."""

    sc_target: float = 30.0
    trials: int = 6
    iters: int = 20
    betas: tuple = tuple(np.linspace(3.0, 21.0, 61))
    slicing_repeat: int = 4
    start_seed: int = 0
    alpha: float = 32.0
    parallel: bool = True

    def find_order_kwargs(self):
        return dict(sc_target=self.sc_target, trials=self.trials,
                    iters=self.iters, betas=list(self.betas),
                    slicing_repeat=self.slicing_repeat,
                    start_seed=self.start_seed, alpha=self.alpha,
                    parallel=self.parallel)


def _config(config, overrides):
    if config is None:
        return PlannerConfig(**overrides)
    if overrides:
        raise TypeError("pass either a PlannerConfig or keyword overrides, "
                        "not both")
    return config


def check_bitstrings(bitstrings):
    """'sparse' big-batch mode if amplitudes were requested, else 'normal'
    (dense), with the batch size."""
    if len(bitstrings):
        return "sparse", len(np.unique(bitstrings))
    return "normal", 1


def get_bond_tensors(tensor_bonds):
    """Inverted bond -> tensors index."""
    out = {}
    for tid, bonds in tensor_bonds.items():
        for b in bonds:
            out.setdefault(b, set()).add(tid)
    return out


def _bond_sort_key(bond):
    """Output-leg ordering key: the encoded qubit for wire-style labels
    '{step}-{qubit}', else the label itself."""
    s = str(bond)
    parts = s.split("-")
    if len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
        return (0, int(parts[1]), 0)
    if isinstance(bond, (int, np.integer)):
        return (0, int(bond), 0)
    return (1, 0, s)


def require_device(device):
    """The device to run on; ``cuda`` must exist — an entry point never
    falls back to the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain versions on the CPU")
    return device


def run_device(device, mesh):
    """The device a run stages its tensors on: ``device``
    (``require_device``), or with a ``mesh`` its first replica's.  A mesh
    names its devices: a ``device`` other than the default beside it
    raises."""
    if mesh is None:
        return require_device(device)
    if torch.device(device) != torch.device("cuda"):
        raise ValueError("a mesh names its devices: pass no device with it")
    return mesh.devices[0]


class TensorNetworkSimulation:
    """Stateful pipeline: simplify -> load plan -> compile -> contract, in
    sparse (amplitudes of ``bitstrings``) or dense ("normal": the whole
    state) mode."""

    def __init__(self, tensors, tensor_bonds, bond_dims, final_qubits,
                 bitstrings, pattern=None, max_bitstrings=None):
        self.tensors = tensors              # dict id -> numpy array
        self.tensor_bonds = tensor_bonds    # dict id -> bond list (unsliced)
        self.bond_dims = bond_dims
        self.final_qubits = list(final_qubits)
        self.bitstrings = list(bitstrings)
        mode, n_bits = check_bitstrings(self.bitstrings)
        self.pattern = pattern or mode
        self.max_bitstrings = max_bitstrings or n_bits

    @classmethod
    def from_circuit(cls, circuit, bitstrings=()):
        """Build from a TensorNetworkCircuit (or qsim path / (n, layers)):
        the amplitudes of ``bitstrings``, or without them the whole
        state."""
        if not isinstance(circuit, TensorNetworkCircuit):
            circuit = TensorNetworkCircuit(circuit)
        pattern, max_bitstrings = check_bitstrings(bitstrings)
        tensors, tensor_bonds, bond_dims, final_qubits = \
            circuit.to_numerical_tn()
        ntn = NumericalTensorNetwork(tensors, tensor_bonds, bond_dims,
                                     final_qubits)
        tensor_bonds2, final_qubit_ids = ntn.simplify(pattern)
        return cls(dict(ntn.tensors), tensor_bonds2, ntn.bond_dims,
                   final_qubit_ids, bitstrings, pattern, max_bitstrings)

    def prepare_contraction(self, config=None, **overrides):
        """Plan this network (``planner.find_order`` under ``config``, a
        ``PlannerConfig``, or its fields as keywords) and compile the
        scheme; sparse mode compiles at the config's ``sc_target``.
        ``plan_seconds`` and ``compile_seconds``: the host time of each."""
        config = _config(config, overrides)
        self.config = config
        t0 = time.perf_counter()
        self.order, slicing_bonds, self.ctree = find_order(
            self.tensor_bonds, self.bond_dims, self.final_qubits,
            max_bitstrings=self.max_bitstrings,
            **config.find_order_kwargs())
        self.plan_seconds = time.perf_counter() - t0
        self.slicing_bonds = list(slicing_bonds)
        self.sc_target = float(config.sc_target)
        self._shard_plan = None
        self._compile_scheme()
        return self

    def update_scheme(self, sc_target=None, bitstrings=None):
        """Recompile the scheme (for a new bitstring batch, or another
        ``sc_target``) without re-planning."""
        if bitstrings is not None:
            pattern, _ = check_bitstrings(bitstrings)
            if pattern != self.pattern:
                raise ValueError("sparse or dense mode is fixed at "
                                 "construction")
            self.bitstrings = list(bitstrings)
        if sc_target is not None:
            self.sc_target = float(sc_target)
            if getattr(self, "config", None) is not None:
                self.config.sc_target = sc_target
        self._compile_scheme()
        return self

    def load_plan(self, plan, sc_target=None):
        """Load a plan (path or dict saved by ``plan_io.save_plan`` of
        either package) for this network and compile the scheme.
        ``sc_target`` (sparse mode only) defaults to the plan's
        ``meta.sc_target``.  Runs in a ``load_plan`` span."""
        with tracing.span("load_plan", pattern=self.pattern):
            if not isinstance(plan, dict):
                with open(plan) as f:
                    plan = json.load(f)
            if sc_target is None:
                sc_target = (plan.get("meta") or {}).get("sc_target")
            if sc_target is None and self.pattern == "sparse":
                raise ValueError("the plan names no sc_target: pass one")
            self.order, self.slicing_bonds, self.ctree = plan_from_dict(plan)
            self.sc_target = None if sc_target is None else float(sc_target)
            self._shard_plan = None
            self._compile_scheme()
        return self

    def _compile_scheme(self):
        """Compile the default scheme of the plan; ``compile_seconds``: its
        ``scheme.compile`` span's."""
        if self.pattern == "normal":
            from .runtime.scheme import contraction_scheme

            self._set_scheme(*contraction_scheme(self.ctree))
        else:
            from .runtime.sparse import contraction_scheme_sparse

            # schemes that will run segmented take kernels on up to 10000
            # steps, as in the JAX package
            n_order = len(self.ctree.to_order_dfs())
            lane_max = 10_000 if n_order > SEGMENT_AUTO_THRESHOLD else None
            self._set_scheme(*contraction_scheme_sparse(
                self.ctree, self.bitstrings, sc_target=self.sc_target,
                lane_max_steps=lane_max))
        self.compile_seconds = tracing.last("scheme.compile").seconds

    def _set_scheme(self, steps, output_bonds, bitstrings_sorted=None):
        """Take a compiled scheme (``contraction_scheme_sparse``'s result,
        or ``scheme.contraction_scheme``'s in dense mode) and derive the
        slicing axes and the output permutation for it."""
        from .runtime import executor as ex

        self.steps, self.output_bonds = steps, output_bonds
        self.bitstrings_sorted = bitstrings_sorted
        batched = self.final_qubits if self.pattern == "sparse" else ()
        self.slicing_axes = ex.build_slicing_axes(
            self.tensor_bonds, self.slicing_bonds, batched_tensors=batched)
        # output permutation: the open legs into qubit order
        keys = [_bond_sort_key(b) for b in self.output_bonds]
        perm = tuple(sorted(range(len(keys)), key=keys.__getitem__))
        if self.pattern == "sparse":
            perm = (0,) + tuple(p + 1 for p in perm)
        self.permute_dims = perm

    def _staged(self, device, field=None):
        """``(field, run_steps, arrays, out_shape, execute, apply_step)``:
        the static steps folded, the tensors staged on ``device`` in
        ``field``'s form (default: split complex64)."""
        from .ops.field import SplitField
        from .runtime import executor as ex
        from .runtime.sparse import apply_sparse_step, execute_sparse

        field = field or SplitField()
        with tracing.span("prepare.fold"):
            run_steps, host_arrays = ex.precompute_static_steps(
                self.steps,
                [self.tensors[i] for i in range(len(self.tensors))],
                self.slicing_axes)
        with tracing.span("prepare.stage"):
            arrays = ex.stage_tensors(field, host_arrays, device)
        if self.pattern == "normal":
            out_shape = (2,) * len(self.output_bonds)
            execute, apply_step = ex.execute_dense, ex.apply_dense_step
        else:
            out_shape = (len(self.bitstrings_sorted),) + \
                (2,) * len(self.output_bonds)
            execute, apply_step = execute_sparse, apply_sparse_step
        self.field = field
        self.out_shape = out_shape
        return field, run_steps, arrays, out_shape, execute, apply_step

    def prepare(self, slice_batch=1, device="cuda", eager=False,
                dtype=np.complex64, precision="highest", mode="split",
                algo="naive"):
        """Fold the static steps, stage the tensors on ``device`` in the
        field ``make_field(dtype, precision, mode, algo)`` (default:
        complex64 split pairs) and build the sliced runner.  Returns a
        callable that runs the whole sliced contraction and returns the
        flat result on the device (``self.field``'s value), its axes in
        ``self.output_bonds`` order (after the amplitude axis in sparse
        mode); repeatable: the staged tensors are reused.  On the card its
        first call captures a slice group as a CUDA graph (the whole run,
        with nothing sliced) and every call replays it; ``eager``: every
        step runs from the host, as on the CPU.  ``callable.stats``: the
        runner's captures, replays and capture seconds;
        ``callable.capture()`` makes its graphs without running it (as
        ``parallel.dispatch_batches`` needs of a group's run).  Runs in a
        ``prepare`` span: ``prepare.fold`` and ``prepare.stage`` under
        it."""
        from .runtime import executor as ex

        from .ops.field import make_field

        device = require_device(device)
        with tracing.span("prepare"):
            field, run_steps, arrays, out_shape, execute, _ = self._staged(
                device, make_field(dtype, precision, mode, algo))
            run = ex.make_sliced_runner(
                execute, run_steps, self.slicing_axes,
                len(self.slicing_bonds), out_shape, field,
                slice_batch=slice_batch, eager=eager)
        call = lambda: run(arrays)
        call.stats = run.stats
        call.capture = lambda: run.capture(arrays)
        return call

    def contraction(self, dtype=np.complex64, precision="highest",
                    mode="split", algo="naive", scientific_notation=False,
                    checkpoint_path=None, report=None, slice_batch=1,
                    profile_dir=None, device="cuda", mesh=None):
        """Execute the compiled plan; returns a numpy array: in dense mode
        the ``(2,)*n`` state in qubit order, in sparse mode the amplitudes
        ``(len(bitstrings_sorted),)`` in the order of
        ``self.bitstrings_sorted``.

        ``dtype``: complex64 (the kernels' type) or complex128 (the dot
        fallback alone).  ``precision`` ('highest', 'high', 'default'),
        ``mode`` ('split', 'complex', 'fused') and ``algo`` ('naive',
        'karatsuba'): the field, ``ops/field.make_field``; the kernels
        run in split mode only, at one TF32 pass under 'default'
        (``ops/einsum.py``).  ``scientific_notation``: renormalise every
        intermediate; returns ``(amplitudes, log10_factor)``, true values
        = amplitudes * 10**factor (slices one at a time).
        ``mesh`` (``parallel.Mesh``; with it no ``device``): the slices
        partitioned over the mesh's replicas at width ``slice_batch``
        each (``parallel.run_sliced_contraction``; above
        ``SEGMENT_AUTO_THRESHOLD`` device steps
        ``segmented.run_segmented_sharded``), the result on its first
        replica's device; scientific notation runs before it, on that
        device, and it wins over ``checkpoint_path``, as in the JAX
        package.  ``checkpoint_path``: save the partial slice sum after
        every chunk of slices (an eighth, at least ``slice_batch``) and
        resume from the file; it is removed on success.  Above
        ``SEGMENT_AUTO_THRESHOLD`` device steps the run is segmented.
        Otherwise the whole-group run, whose width halves on a
        ``torch.cuda.OutOfMemoryError`` (logged).  ``report``: a
        ``runtime.metrics.ContractionReport`` to fill in.
        ``profile_dir``: a ``torch.profiler`` trace of the execution,
        written there as ``trace.json``, with tracing enabled (the
        program's spans name its phases in it).  The call runs in a
        ``contraction`` span.  ``self.run_stats`` holds the
        executor, the width it used, and its captures, replays and
        capture seconds (over a mesh, summed over its replicas, each
        replica's under ``replicas``).
        """
        import torch

        from .ops.field import make_field
        from .runtime import executor as ex
        from .runtime import metrics as mt

        device = run_device(device, mesh)
        field, run_steps, arrays, out_shape, execute, apply_step = \
            self._staged(device, make_field(dtype, precision, mode, algo))
        k = len(self.slicing_bonds)
        graphs = device.type == "cuda"
        factor = None
        prof = traced = None
        if profile_dir is not None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + \
                ([ProfilerActivity.CUDA] if graphs else [])
            prof = profile(activities=acts)
            prof.__enter__()
            traced = tracing.enable()
        try:
            with tracing.span("contraction") as wall:
                if scientific_notation:
                    from .runtime.rescaled import make_rescaled_runner

                    run = make_rescaled_runner(
                        apply_step, run_steps, self.slicing_axes, k,
                        out_shape, field)
                    result, factor = run(arrays)
                    stats = dict(run.stats, executor="rescaled",
                                 slice_batch=1)
                elif mesh is not None and \
                        len(run_steps) > SEGMENT_AUTO_THRESHOLD:
                    from .runtime import segmented

                    if mesh.group is not None:
                        raise ValueError("the segmented mesh run is one "
                                         "process's: a mesh across "
                                         "processes runs whole groups")
                    result = segmented.run_segmented_sharded(
                        arrays, run_steps, self.slicing_axes, k, out_shape,
                        field, apply_step, list(mesh.devices),
                        slice_batch=slice_batch)
                    reps = segmented.LAST_RUN["replicas"]
                    stats = dict(executor="segmented-sharded",
                                 replicas=reps,
                                 slice_batch=max(r["width"] for r in reps),
                                 segments=reps[0]["segments"],
                                 capture_s=segmented.LAST_RUN["capture_s"],
                                 replays=segmented.LAST_RUN["replays"])
                elif mesh is not None:
                    from . import parallel

                    result = parallel.run_sliced_contraction(
                        arrays, run_steps, self.slicing_axes, k, out_shape,
                        mesh, field=field, execute=execute,
                        slice_batch=slice_batch)
                    reps = parallel.LAST_RUN["replicas"]
                    stats = dict(executor="mesh", replicas=reps,
                                 slice_batch=slice_batch,
                                 **{key: sum(r[key] for r in reps) for key in
                                    ("captures", "replays", "capture_s")})
                elif checkpoint_path is not None:
                    from .runtime.checkpoint import run_sliced_checkpointed

                    run = ex.make_sliced_runner(
                        execute, run_steps, self.slicing_axes, k, out_shape,
                        field, slice_batch=slice_batch)
                    result = run_sliced_checkpointed(
                        run, arrays, k, out_shape, field, checkpoint_path,
                        chunk=max(slice_batch, 2 ** k // 8))
                    stats = dict(run.stats, executor="checkpointed",
                                 slice_batch=slice_batch)
                elif len(run_steps) > SEGMENT_AUTO_THRESHOLD:
                    from .runtime import segmented

                    result = segmented.run_segmented(
                        arrays, run_steps, self.slicing_axes, k, out_shape,
                        field, apply_step, slice_batch=slice_batch)
                    last = segmented.LAST_RUN
                    stats = dict(executor="segmented",
                                 slice_batch=last["width"],
                                 segments=last["segments"],
                                 capture_s=last["capture_s"],
                                 replays=last["replays"])
                else:
                    result, stats = self._whole_group(
                        execute, run_steps, arrays, out_shape, field,
                        slice_batch)
                if graphs:
                    torch.cuda.synchronize(device)
                result = field.unwrap(result).reshape(out_shape)
        finally:
            if prof is not None:
                tracing.enable(traced)
                prof.__exit__(None, None, None)
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(profile_dir, "trace.json"))
        stats["graphs"] = graphs
        self.run_stats = stats
        if report is not None:
            report.predicted_flops = (2 ** k) * mt.scheme_flops(
                run_steps, algo if mode == "split" else "naive")
            report.wall_s = wall.seconds
            report.compile_s = stats.get("capture_s", 0.0)
            report.num_slices = 2 ** k
            report.num_steps = len(run_steps)
            report.reorders = mt.reorder_census(run_steps)
            report.tc, report.sc, _ = self.ctree.complexity()
            report.executor = stats["executor"]
            report.slice_batch = stats["slice_batch"]
        if self.permute_dims:
            result = result.transpose(self.permute_dims)
        if scientific_notation:
            return result, float(factor.cpu())
        return result

    def _whole_group(self, execute, run_steps, arrays, out_shape, field,
                     slice_batch):
        """The whole-group run (graph replay on the card), its width
        halved on a ``torch.cuda.OutOfMemoryError`` anywhere on the error's
        chain (``executor.out_of_memory``: a failed capture raises its own
        error on top of it), as the JAX package halves it on a
        compile-time memory failure.  Returns the result
        and the runner's stats."""
        import torch

        from .runtime import executor as ex

        while True:
            run = ex.make_sliced_runner(
                execute, run_steps, self.slicing_axes,
                len(self.slicing_bonds), out_shape, field,
                slice_batch=slice_batch)
            try:
                result = run(arrays)
                break
            except Exception as e:  # noqa: BLE001 — narrowed to OOM
                if slice_batch <= 1 or not ex.out_of_memory(e):
                    raise
                msg = str(e).splitlines()[0][:120]
            # outside the handler: the error's frames no longer hold the
            # failed run's buffers
            del run
            slice_batch //= 2
            logging.getLogger(__name__).warning(
                "out of device memory (%s); retrying with slice_batch=%d",
                msg, slice_batch)
            torch.cuda.empty_cache()
        graphs = ex._device(arrays, field).type == "cuda"
        return result, dict(run.stats, slice_batch=slice_batch,
                            executor="graph" if graphs else "eager")

    def prepare_output_sharded(self, d_out, config=None, **overrides):
        """Plan the dense state with ``d_out`` output legs (the lowest in
        qubit order) removed first, so that ``config.sc_target`` bounds
        each 2^(n - d_out) block, and compile the block scheme;
        ``contraction_output_blocks(d_out)`` then walks these planned
        blocks, each the sum of the plan's 2^k slices.  Without it the
        walk slices the legs post hoc on the tree planned for the whole
        state, which cannot push sc below the whole output.  Sets
        ``ctree``, ``order`` and ``slicing_bonds`` to the block plan's,
        and ``plan_seconds`` and ``compile_seconds``."""
        from .runtime import executor as ex
        from .runtime.scheme import contraction_scheme

        if self.pattern != "normal":
            raise ValueError("output blocks are a dense-mode feature")
        config = _config(config, overrides)
        self.config = config
        bt = get_bond_tensors(self.tensor_bonds)
        open_bonds = sorted((b for b, ts in bt.items() if len(ts) == 1),
                            key=_bond_sort_key)
        if len(open_bonds) < d_out:
            raise ValueError(f"{len(open_bonds)} open legs, fewer than the "
                             f"{d_out} requested")
        chosen = open_bonds[:d_out]
        chosen_set = set(chosen)
        tb = {t: [b for b in bs if b not in chosen_set]
              for t, bs in self.tensor_bonds.items()}
        bd = {b: d for b, d in self.bond_dims.items() if b not in chosen_set}
        t0 = time.perf_counter()
        order, sliced, ctree = find_order(
            tb, bd, self.final_qubits, max_bitstrings=self.max_bitstrings,
            **config.find_order_kwargs())
        self.plan_seconds = time.perf_counter() - t0
        steps, output_bonds = contraction_scheme(ctree)
        self.compile_seconds = tracing.last("scheme.compile").seconds
        axes = ex.build_slicing_axes(self.tensor_bonds, chosen + sliced)
        self.ctree, self.order = ctree, order
        self.slicing_bonds = list(sliced)
        self._shard_plan = {"d_out": d_out, "chosen": chosen, "steps": steps,
                            "output_bonds": output_bonds, "axes": axes,
                            "k_sum": len(sliced)}
        return self

    def contraction_output_sharded(self, mesh, d_out=None,
                                   dtype=np.complex64, precision="highest",
                                   mode="split"):
        """The dense state with its output sharded over ``mesh``'s
        replicas: each computes its 2^(n - d_out) amplitudes a block, the
        2^d_out blocks (``d_out`` default ``max(1, ceil(log2 n))``; n
        must divide 2^d_out) split evenly among them
        (``parallel.run_output_sharded``), so that no card holds the
        whole state; the blocks are gathered on the host.  After
        ``prepare_output_sharded(d_out)`` the planned blocks, otherwise
        the legs sliced post hoc (``_dense_shard_setup``); the steps that
        no sliced leg reaches run once, on the first replica's device,
        before the blocks (``executor.fold_invariant_steps``).  Returns
        the whole ``(2,)*n`` state in qubit order (a numpy view)."""
        from .ops.field import make_field
        from .parallel import run_output_sharded
        from .runtime import executor as ex

        if d_out is None:
            d_out = max(1, int(np.ceil(np.log2(len(mesh.devices)))))
        field = make_field(dtype, precision, mode)
        steps, axes, chosen, output_bonds, k_sum, restore = \
            _dense_shard_setup(self, d_out)
        try:
            steps, host_arrays = ex.precompute_static_steps(
                steps, [self.tensors[i] for i in range(len(self.tensors))],
                axes)
            staged = ex.stage_tensors(field, host_arrays, mesh.devices[0])
            steps, staged = ex.fold_invariant_steps(staged, steps, axes,
                                                    field)
            local_shape = (2,) * len(output_bonds)
            parts = run_output_sharded(staged, steps, axes, d_out, k_sum,
                                       local_shape, mesh, field=field)
            del staged
            out = np.concatenate([field.unwrap(p).reshape(-1)
                                  for p in parts])
            del parts
            return out.reshape((2,) * d_out + local_shape).transpose(
                _dense_shard_perm(chosen, output_bonds))
        finally:
            restore()

    def contraction_output_blocks(self, d_out, dtype=np.complex64,
                                  precision="highest", mode="split",
                                  postprocess=None, device="cuda",
                                  eager=False):
        """Generator over the 2^d_out disjoint output blocks, one at a
        time on ONE card (dense mode): the walk of a state too large for
        the card, or of one the host should never hold whole.  After
        ``prepare_output_sharded(d_out)`` it walks that plan's blocks;
        otherwise it slices the legs post hoc (``_dense_shard_setup``).

        Yields ``(fixed_bits, qubits, block)``: the chosen output qubits
        (the ``d_out`` lowest in qubit order), their fixed bit assignment
        (MSB first), and the block of amplitudes of the remaining qubits
        in qubit order.  ``postprocess(field, oid, value)``: an optional
        reduction on the device of each block before it is pulled to the
        host (``value`` is the flat split-complex block, its axes in
        ``output_bonds`` order of the block scheme); its unwrapped result
        is yielded as ``block`` instead.  The ``2^k`` slices of a block
        run one at a time.  The steps that no sliced leg reaches run once,
        before the first block (``executor.fold_invariant_steps``); the
        rest run per block: on the card one graph, captured at the first
        block and replayed for all of them (``eager``: from the host, as
        on the CPU).  ``self.block_run_stats``: that runner's stats.
        """
        from .ops.field import make_field
        from .runtime import executor as ex

        device = require_device(device)
        field = make_field(dtype, precision, mode)
        steps, axes, chosen, output_bonds, k, restore = \
            _dense_shard_setup(self, d_out)
        try:
            steps, host_arrays = ex.precompute_static_steps(
                steps, [self.tensors[i] for i in range(len(self.tensors))],
                axes)
            staged = ex.stage_tensors(field, host_arrays, device)
            # the slice-invariant steps run once for all blocks
            steps, staged = ex.fold_invariant_steps(staged, steps, axes,
                                                    field)
            local_shape = (2,) * len(output_bonds)
            run = ex.make_sliced_contraction(steps, axes, d_out + k,
                                             local_shape, field, eager=eager)
            self.block_run_stats = run.stats
            self.field = field
            self.block_output_bonds = list(output_bonds)
            qubits = [_bond_sort_key(b)[1] for b in chosen]
            local_perm = _dense_shard_perm([], output_bonds)
            for oid in range(2 ** d_out):
                raw = run(staged, range(oid * 2 ** k, (oid + 1) * 2 ** k))
                if postprocess is not None:
                    block = field.unwrap(postprocess(field, oid, raw))
                else:
                    block = field.unwrap(raw).reshape(local_shape) \
                        .transpose(local_perm)
                del raw     # the next block runs without this one held
                yield np.binary_repr(oid, d_out), qubits, block
        finally:
            restore()


def _dense_shard_setup(sim, d_out):
    """``(steps, axes, chosen, output_bonds, k_sum, restore)`` of an
    output-blocked dense contraction.  After ``prepare_output_sharded``
    for the same ``d_out``: that plan's block scheme (``restore`` does
    nothing).  Otherwise the ``d_out`` lowest open legs in qubit order are
    sliced post hoc on the planned tree and the scheme is recompiled (in
    the form ``load_plan`` compiles); ``restore`` puts the legs back, each
    at its place in its tensor's bond list.  The planner cannot push sc
    below the full output that way."""
    from .runtime import executor as ex
    from .runtime.scheme import contraction_scheme

    if sim.pattern != "normal":
        raise ValueError("output blocks are a dense-mode feature")
    plan = getattr(sim, "_shard_plan", None)
    if plan is not None:
        if plan["d_out"] != d_out:
            raise ValueError(f"the planned blocks are for d_out="
                             f"{plan['d_out']}, not {d_out}: plan again or "
                             "load a whole-state plan")
        return (plan["steps"], plan["axes"], plan["chosen"],
                plan["output_bonds"], plan["k_sum"], lambda: None)
    tn = sim.ctree.tn
    open_bonds = sorted((b for b, ts in tn.bond_tensors.items()
                         if len(ts) == 1), key=_bond_sort_key)
    if len(open_bonds) < d_out:
        raise ValueError(f"{len(open_bonds)} open legs, fewer than the "
                         f"{d_out} requested")
    chosen = open_bonds[:d_out]
    for b in chosen:
        sim.ctree.slicing(b)
    try:
        steps, output_bonds = contraction_scheme(sim.ctree)
    except BaseException:
        for b in reversed(chosen):
            sim.ctree.add_bond(b)
        raise
    axes = ex.build_slicing_axes(sim.tensor_bonds,
                                 chosen + list(sim.slicing_bonds))

    def restore():
        for b in reversed(chosen):
            sim.ctree.add_bond(b)

    return steps, axes, chosen, output_bonds, len(sim.slicing_bonds), restore


def _dense_shard_perm(chosen, output_bonds):
    """Permutation taking (chosen qubits + local legs) to qubit order."""
    keys = [_bond_sort_key(b) for b in chosen] + \
        [_bond_sort_key(b) for b in output_bonds]
    return tuple(sorted(range(len(keys)), key=keys.__getitem__))


def tensor_network_contraction(tensors, tensor_bonds, bond_dims, final_qubits,
                               bitstrings=(), sc_target=31, trial_num=8,
                               alpha=0.0, dtype=np.complex64, device="cuda",
                               **kwargs):
    """One-shot: simplify, plan, compile and contract a numerical network
    on ``device`` (the card unless the caller asks for the CPU).

    Returns (amplitudes, bitstrings): bitstrings is the sorted order the
    sparse amplitudes come back in ([] in dense mode).  ``kwargs``: any
    ``PlannerConfig`` field (``iters`` defaults to 50), and
    ``contraction``'s ``precision``, ``mode`` and ``mesh`` (the slices
    over a mesh's replicas; with it no ``device``).
    """
    mesh = kwargs.get("mesh")
    run_device(device, mesh)
    pattern, max_bitstrings = check_bitstrings(bitstrings)
    ntn = NumericalTensorNetwork(tensors, tensor_bonds, bond_dims,
                                 final_qubits)
    tensor_bonds2, final_qubit_ids = ntn.simplify(pattern)
    sim = TensorNetworkSimulation(
        dict(ntn.tensors), tensor_bonds2, ntn.bond_dims, final_qubit_ids,
        bitstrings, pattern, max_bitstrings)
    cfg_kwargs = {"sc_target": sc_target, "trials": trial_num, "iters": 50,
                  "alpha": alpha}
    cfg_kwargs.update({k: v for k, v in kwargs.items()
                       if k in PlannerConfig.__dataclass_fields__})
    sim.prepare_contraction(PlannerConfig(**cfg_kwargs))
    result = sim.contraction(
        dtype=dtype, precision=kwargs.get("precision", "highest"),
        mode=kwargs.get("mode", "split"), device=device, mesh=mesh)
    out_bits = sim.bitstrings_sorted if pattern == "sparse" else []
    return result, out_bits


def quantum_circuit_simulation(circuit_filename, bitstrings=(), sc_target=31,
                               trial_num=8, alpha=0.0, dtype=np.complex64,
                               **kwargs):
    """One-shot from a qsim circuit file, a ``TensorNetworkCircuit`` or an
    ``(n, layers)`` pair (``tensor_network_contraction``'s keywords,
    ``device`` among them)."""
    circ = (circuit_filename
            if isinstance(circuit_filename, TensorNetworkCircuit)
            else TensorNetworkCircuit(circuit_filename))
    tensors, tensor_bonds, bond_dims, final_qubits = circ.to_numerical_tn()
    return tensor_network_contraction(
        tensors, tensor_bonds, bond_dims, final_qubits, bitstrings,
        sc_target, trial_num, alpha, dtype, **kwargs)
