"""Circuit front ends: qsim parser, Sycamore gate library, RCS generator,
the generated-cirq-file loader and the exact oracles (numpy copies of
``artensor_tpu.circuits``)."""

from . import gates
from .circuit import TensorNetworkCircuit, parse_qsim
from .cirq_compat import from_cirq, load_cirq_circuit
from .random_circuits import random_circuit

__all__ = ["gates", "TensorNetworkCircuit", "parse_qsim", "random_circuit",
           "load_cirq_circuit", "from_cirq"]
