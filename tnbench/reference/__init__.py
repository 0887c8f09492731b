"""The benchmark's plain references in PyTorch: the state vector
(``statevector.py``), and for circuits past it the contraction of the
circuit's network along the cell's frozen plan (``network.py``).  They
import nothing of the program."""
