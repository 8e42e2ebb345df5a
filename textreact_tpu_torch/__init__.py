"""PyTorch/CUDA port of textreact_tpu for NVIDIA Hopper.

Mirrors the JAX package's module names. Imports torch and never JAX; the
host-side modules it shares with the JAX package (`textreact_tpu.config`,
`textreact_tpu.tokenizers`) import neither JAX nor pandas. Kernels are
hand-written CUDA in `csrc/`, built on first use (`ops/_build.py`).
"""
