"""Hand-written kernels of the port (CUDA C++ for Hopper), each beside its
plain PyTorch version."""
