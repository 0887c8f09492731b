from .field import SplitField

__all__ = ["SplitField"]
