"""Flash attention: causal or full GQA attention with an online softmax,
a hand-written CUDA kernel beside its plain PyTorch version."""
