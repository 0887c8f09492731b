"""The benchmark's plain reference: a state vector in PyTorch.  It imports
nothing of the program."""
