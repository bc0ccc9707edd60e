"""PyTorch port of the BigDAWG polystore reproduction (CUDA on Hopper).

Laid out like the JAX package ``repro`` so each module's counterpart is
easy to find; it imports neither ``jax`` nor ``repro``.  Entry points run
on the GPU unless the caller asks for the CPU
(``core.api.default_deployment(device="cpu")``), where each kernel's
plain PyTorch version stands in for it.
"""
