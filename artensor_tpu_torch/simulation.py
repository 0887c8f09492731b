"""Orchestration: circuit -> simplified network -> loaded plan -> compiled
sparse scheme -> sliced execution on the card.

Port of the sparse half of ``artensor_tpu/simulation.py``
(``TensorNetworkSimulation``, ``:101-198`` and ``contraction`` ``:199``).
The planner search is not ported yet: a simulation loads a committed plan
(``load_plan``), as ``python -m artensor_tpu simulate --plan`` does, and
compiles the JAX package's default scheme (gate-block fusion and
producer-order negotiation on).  ``prepare`` and ``contraction`` take the
slice width the caller passes; ``runtime/metrics.dividing_slice_width``
gives the one the H100 model picks.
"""

import json

import numpy as np
import torch

from .circuits import TensorNetworkCircuit
from .network import NumericalTensorNetwork
from .plan_io import plan_from_dict


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
    """Stateful pipeline: simplify -> load plan -> compile -> contract
    (sparse big-batch amplitudes)."""

    def __init__(self, tensors, tensor_bonds, bond_dims, final_qubits,
                 bitstrings):
        self.tensors = tensors              # dict id -> numpy array
        self.tensor_bonds = tensor_bonds    # dict id -> bond list (unsliced)
        self.bond_dims = bond_dims
        self.final_qubits = list(final_qubits)
        self.bitstrings = list(bitstrings)

    @classmethod
    def from_circuit(cls, circuit, bitstrings):
        """Build from a TensorNetworkCircuit (or qsim path / (n, layers))
        for the amplitudes of ``bitstrings``."""
        if not len(bitstrings):
            raise NotImplementedError(
                "the dense full-amplitude path is not ported yet")
        if not isinstance(circuit, TensorNetworkCircuit):
            circuit = TensorNetworkCircuit(circuit)
        tensors, tensor_bonds, bond_dims, final_qubits = \
            circuit.to_numerical_tn()
        ntn = NumericalTensorNetwork(tensors, tensor_bonds, bond_dims,
                                     final_qubits)
        tensor_bonds2, final_qubit_ids = ntn.simplify("sparse")
        return cls(dict(ntn.tensors), tensor_bonds2, ntn.bond_dims,
                   final_qubit_ids, bitstrings)

    def load_plan(self, plan, sc_target=None):
        """Load a plan (path or dict saved by ``plan_io.save_plan`` of
        either package) for this network and compile the scheme.
        ``sc_target`` defaults to the plan's ``meta.sc_target``."""
        if not isinstance(plan, dict):
            with open(plan) as f:
                plan = json.load(f)
        if sc_target is None:
            sc_target = plan.get("meta", {}).get("sc_target")
        if sc_target is None:
            raise ValueError("the plan names no sc_target: pass one")
        self.order, self.slicing_bonds, self.ctree = plan_from_dict(plan)
        self.sc_target = float(sc_target)
        self._compile_scheme()
        return self

    def _compile_scheme(self):
        from .runtime.sparse import contraction_scheme_sparse

        self._set_scheme(*contraction_scheme_sparse(
            self.ctree, self.bitstrings, sc_target=self.sc_target))

    def _set_scheme(self, steps, output_bonds, bitstrings_sorted):
        """Take a compiled scheme (``contraction_scheme_sparse``'s result)
        and derive the slicing axes and the output permutation for it."""
        from .runtime import executor as ex

        self.steps, self.output_bonds = steps, output_bonds
        self.bitstrings_sorted = bitstrings_sorted
        self.slicing_axes = ex.build_slicing_axes(
            self.tensor_bonds, self.slicing_bonds,
            batched_tensors=self.final_qubits)
        keys = [_bond_sort_key(b) for b in self.output_bonds]
        perm = tuple(sorted(range(len(keys)), key=keys.__getitem__))
        self.permute_dims = (0,) + tuple(p + 1 for p in perm)

    def prepare(self, slice_batch=1, device="cuda"):
        """Fold the static steps, stage the tensors on ``device`` as
        complex64 split pairs and build the sliced runner.  Returns a
        callable that runs the whole sliced contraction and returns the flat
        split-complex result on the device (repeatable: the staged tensors
        are reused)."""
        from .ops.field import SplitField
        from .runtime import executor as ex
        from .runtime.sparse import execute_sparse

        device = require_device(device)
        field = SplitField()
        run_steps, host_arrays = ex.precompute_static_steps(
            self.steps, [self.tensors[i] for i in range(len(self.tensors))],
            self.slicing_axes)
        arrays = ex.stage_tensors(field, host_arrays, device)
        out_shape = (len(self.bitstrings_sorted),) + \
            (2,) * len(self.output_bonds)
        run = ex.make_sliced_runner(
            execute_sparse, run_steps, self.slicing_axes,
            len(self.slicing_bonds), out_shape, field,
            slice_batch=slice_batch)
        self.field = field
        self.out_shape = out_shape
        return lambda: run(arrays)

    def contraction(self, slice_batch=1, device="cuda"):
        """Execute the compiled plan; returns the amplitudes as a numpy
        array of shape ``(len(bitstrings_sorted),)`` in the order of
        ``self.bitstrings_sorted``."""
        run = self.prepare(slice_batch, device)
        result = self.field.unwrap(run()).reshape(self.out_shape)
        return result.transpose(self.permute_dims)
