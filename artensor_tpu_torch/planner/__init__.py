"""Plan-loading half of the planner: cost caches and the contraction tree
(pure Python).  The greedy and annealing search is not ported yet."""

from .cost import leaf_cost, merge_cost
from .tree import ContractionTree

__all__ = ["leaf_cost", "merge_cost", "ContractionTree"]
