"""Hand-written CUDA kernels of the port and their plain-torch twins."""
