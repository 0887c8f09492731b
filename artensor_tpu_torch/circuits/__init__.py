"""Circuit front ends: qsim parser, Sycamore gate library, RCS generator and
the exact state-vector oracle (numpy copies of ``artensor_tpu.circuits``;
the cirq loader is not ported yet)."""

from . import gates
from .circuit import TensorNetworkCircuit, parse_qsim
from .random_circuits import random_circuit

__all__ = ["gates", "TensorNetworkCircuit", "parse_qsim", "random_circuit"]
