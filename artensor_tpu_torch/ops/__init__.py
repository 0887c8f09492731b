from .einsum import PRECISIONS, pairwise_einsum
from .field import ComplexField, FusedField, SplitField, make_field

__all__ = ["ComplexField", "FusedField", "PRECISIONS", "SplitField",
           "make_field", "pairwise_einsum"]
