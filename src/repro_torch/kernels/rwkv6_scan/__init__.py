"""WKV6: RWKV6's data-dependent-decay linear recurrence, a hand-written
CUDA kernel beside its plain PyTorch version."""
