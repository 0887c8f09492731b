"""artensor_tpu_torch: the PyTorch + CUDA port of ``artensor_tpu``.

The sparse big-batch amplitude path runs on one NVIDIA H100: circuit ->
``simplify('sparse')`` -> a committed plan -> the sparse scheme compiler ->
the sliced executor, with hand-written CUDA kernels (``csrc/``) for the
gather-K, gathered gather-K, RGRow and pair steps.  Entry points run on the
card unless the caller passes ``device='cpu'``, where every kernel wrapper
takes its plain PyTorch version.  This package imports nothing of JAX or of
``artensor_tpu``.
"""

from .circuits import TensorNetworkCircuit, random_circuit
from .network import AbstractTensorNetwork, NumericalTensorNetwork
from .ops.field import SplitField
from .plan_io import load_plan, plan_from_dict
from .simulation import TensorNetworkSimulation

__all__ = [
    "TensorNetworkCircuit", "random_circuit", "AbstractTensorNetwork",
    "NumericalTensorNetwork", "SplitField", "load_plan",
    "plan_from_dict", "TensorNetworkSimulation",
]
