"""Host-side contraction planner (pure Python, with a native C++ search in
``native/``): given the hypergraph of a tensor network, find a pairwise
contraction order minimising time / space / memory complexity, slicing
bonds to fit a log2 memory budget (``sc_target``).  Port of
``artensor_tpu/planner``."""

from .cost import leaf_cost, merge_cost, score
from .greedy import GreedyOrderFinder
from .tree import ContractionTree, clone_network
from .annealing import find_order, sa_trial, simulate_annealing

__all__ = [
    "score", "merge_cost", "leaf_cost",
    "GreedyOrderFinder", "ContractionTree", "clone_network",
    "find_order", "simulate_annealing", "sa_trial",
]
