"""Kernel ops: each wrapper launches its CUDA kernel on a CUDA tensor (or
raises) and runs its plain PyTorch version on a CPU tensor."""
