"""The Mamba-1 selective scan, a hand-written CUDA kernel beside its plain
PyTorch version."""
