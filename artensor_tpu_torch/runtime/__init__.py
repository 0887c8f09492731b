"""Runtime: step lowering, kernel planners and wrappers, the sparse scheme
compiler and the sliced executor (PyTorch, CUDA kernels on the card)."""
