"""artensor_tpu_torch: the PyTorch + CUDA port of ``artensor_tpu``.

A host-side planner (greedy start, simulated annealing with dynamic bond
slicing; the search in C++ where g++ builds it, ``native/``) plans a
network; two paths run the plan on one NVIDIA H100: the sparse big-batch
amplitudes (circuit -> ``simplify('sparse')`` -> a plan -> the sparse
scheme compiler -> the sliced executor) and the dense full amplitude
(``simplify('normal')`` -> ``contraction_scheme`` -> the same sliced
runner over the dense executor, whole or an output block at a time),
with hand-written CUDA kernels (``csrc/``) for the gather-K, gathered
gather-K, RGRow, RGFlat, lane and pair steps; the number field is the
JAX package's choice (``make_field``: split pairs, native complex or
fused, at three precisions), the kernels running in split mode.  Entry points run on the
card unless the caller passes ``device='cpu'``, where every kernel wrapper
takes its plain PyTorch version, or over a device mesh (``parallel/``:
``make_mesh``, the slices or a dense state's output blocks partitioned
over its replicas, batch groups dispatched over devices, and
``parallel.distributed`` across processes on ``torch.distributed``).  Around them, as in the JAX package: the
cirq file loader (``load_cirq_circuit``, ``from_cirq``), the truncated-MPS
oracle (``mps_simulate``), the XEB estimators, the scheme and build
caches (``runtime/scheme_cache.py``, ``cache.py``) and the command line,
``python -m artensor_tpu_torch simulate|plan|info|bench|verify``.  This
package imports nothing of JAX or of ``artensor_tpu``.
"""

from .circuits import (TensorNetworkCircuit, from_cirq, load_cirq_circuit,
                       parse_qsim, random_circuit)
from .network import AbstractTensorNetwork, NumericalTensorNetwork
from .ops.field import ComplexField, FusedField, SplitField, make_field
from .parallel import (Mesh, dispatch_batches, make_mesh, run_output_sharded,
                       run_sliced_contraction)
from .plan_io import load_plan, plan_from_dict, plan_to_dict, save_plan
from .planner import (ContractionTree, GreedyOrderFinder, find_order,
                      simulate_annealing)
from .runtime.executor import tensor_contraction
from .runtime.scheme import contraction_scheme
from .runtime.sparse import (contraction_scheme_sparse,
                             tensor_contraction_sparse)
from .simulation import (PlannerConfig, TensorNetworkSimulation,
                         quantum_circuit_simulation,
                         tensor_network_contraction)
from .utils import (einsum_eq_convert, log2sumexp2, log10sumexp2,
                    tensordot2einsum)
from .utils.mps import MPS, mps_simulate
from .utils.xeb import (linear_xeb, sliced_fidelity_estimate, state_fidelity,
                        xeb_against_ground_truth)

__all__ = [
    "TensorNetworkCircuit", "random_circuit", "parse_qsim",
    "load_cirq_circuit", "from_cirq", "AbstractTensorNetwork",
    "NumericalTensorNetwork", "SplitField", "ComplexField", "FusedField",
    "make_field", "Mesh", "make_mesh", "run_sliced_contraction",
    "run_output_sharded", "dispatch_batches", "load_plan", "save_plan", "plan_to_dict",
    "plan_from_dict", "ContractionTree", "GreedyOrderFinder", "find_order",
    "simulate_annealing", "contraction_scheme",
    "contraction_scheme_sparse", "tensor_contraction",
    "tensor_contraction_sparse", "PlannerConfig",
    "TensorNetworkSimulation", "tensor_network_contraction",
    "quantum_circuit_simulation", "einsum_eq_convert", "tensordot2einsum",
    "log2sumexp2", "log10sumexp2", "MPS", "mps_simulate", "state_fidelity",
    "linear_xeb", "xeb_against_ground_truth", "sliced_fidelity_estimate",
]
