"""Orchestration: circuit -> simplified network -> loaded plan -> compiled
scheme -> sliced execution on the card.

Port of ``artensor_tpu/simulation.py``: ``TensorNetworkSimulation`` in its
two modes, fixed at construction by the bitstrings (``check_bitstrings``):
the sparse big-batch amplitudes (``simplify('sparse')``,
``runtime/sparse.py``) and the dense full amplitude ("normal":
``simplify('normal')``, ``runtime/scheme.py``), which returns the whole
``(2,)*n`` state in qubit order; and the dense single-card output-block
walk ``contraction_output_blocks``.  The planner search is not ported
yet: a simulation loads a committed plan (``load_plan``), as ``python -m
artensor_tpu simulate --plan`` does, and compiles the JAX package's
default scheme (gate-block fusion and producer-order negotiation on).
``prepare`` and ``contraction`` take the slice width the caller passes;
``runtime/metrics.dividing_slice_width`` gives the one the H100 model
picks.  Not ported yet: ``prepare_output_sharded`` (it plans, and waits
for the planner) and ``contraction_output_sharded`` (it waits for
multi-device).
"""

import json

import numpy as np
import torch

from .circuits import TensorNetworkCircuit
from .network import NumericalTensorNetwork
from .plan_io import plan_from_dict


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

    def load_plan(self, plan, sc_target=None):
        """Load a plan (path or dict saved by ``plan_io.save_plan`` of
        either package) for this network and compile the scheme.
        ``sc_target`` (sparse mode only) defaults to the plan's
        ``meta.sc_target``."""
        if not isinstance(plan, dict):
            with open(plan) as f:
                plan = json.load(f)
        if sc_target is None:
            sc_target = (plan.get("meta") or {}).get("sc_target")
        if sc_target is None and self.pattern == "sparse":
            raise ValueError("the plan names no sc_target: pass one")
        self.order, self.slicing_bonds, self.ctree = plan_from_dict(plan)
        self.sc_target = None if sc_target is None else float(sc_target)
        self._compile_scheme()
        return self

    def _compile_scheme(self):
        if self.pattern == "normal":
            from .runtime.scheme import contraction_scheme

            self._set_scheme(*contraction_scheme(self.ctree))
            return
        from .runtime.sparse import contraction_scheme_sparse

        self._set_scheme(*contraction_scheme_sparse(
            self.ctree, self.bitstrings, sc_target=self.sc_target))

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

    def prepare(self, slice_batch=1, device="cuda"):
        """Fold the static steps, stage the tensors on ``device`` as
        complex64 split pairs and build the sliced runner.  Returns a
        callable that runs the whole sliced contraction and returns the flat
        split-complex result on the device, its axes in
        ``self.output_bonds`` order (after the amplitude axis in sparse
        mode); repeatable: the staged tensors are reused."""
        from .ops.field import SplitField
        from .runtime import executor as ex
        from .runtime.sparse import execute_sparse

        device = require_device(device)
        field = SplitField()
        run_steps, host_arrays = ex.precompute_static_steps(
            self.steps, [self.tensors[i] for i in range(len(self.tensors))],
            self.slicing_axes)
        arrays = ex.stage_tensors(field, host_arrays, device)
        if self.pattern == "normal":
            out_shape = (2,) * len(self.output_bonds)
            execute = ex.execute_dense
        else:
            out_shape = (len(self.bitstrings_sorted),) + \
                (2,) * len(self.output_bonds)
            execute = execute_sparse
        run = ex.make_sliced_runner(
            execute, run_steps, self.slicing_axes,
            len(self.slicing_bonds), out_shape, field,
            slice_batch=slice_batch)
        self.field = field
        self.out_shape = out_shape
        return lambda: run(arrays)

    def contraction(self, slice_batch=1, device="cuda"):
        """Execute the compiled plan; returns a numpy array: in dense mode
        the ``(2,)*n`` state in qubit order, in sparse mode the amplitudes
        ``(len(bitstrings_sorted),)`` in the order of
        ``self.bitstrings_sorted``."""
        run = self.prepare(slice_batch, device)
        result = self.field.unwrap(run()).reshape(self.out_shape)
        return result.transpose(self.permute_dims)

    def contraction_output_blocks(self, d_out, postprocess=None,
                                  device="cuda"):
        """Generator over the 2^d_out disjoint output blocks, one at a
        time on ONE card (dense mode): the walk of a state too large for
        the card, or of one the host should never hold whole.

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
        rest run per block.
        """
        from .ops.field import SplitField
        from .runtime import executor as ex

        device = require_device(device)
        field = SplitField()
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
                                             local_shape, field)
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
    output-blocked dense contraction: the ``d_out`` lowest open legs in
    qubit order are sliced post hoc on the planned tree and the scheme is
    recompiled (in the form ``load_plan`` compiles); ``restore`` puts the
    legs back, each at its place in its tensor's bond list.  The planner
    cannot push sc below the full output this way (``prepare_output_
    sharded``, which plans with the legs pre-sliced, waits for the
    planner)."""
    from .runtime import executor as ex
    from .runtime.scheme import contraction_scheme

    if sim.pattern != "normal":
        raise ValueError("output blocks are a dense-mode feature")
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
