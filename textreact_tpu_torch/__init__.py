"""PyTorch/CUDA port of textreact_tpu for NVIDIA Hopper.

Mirrors the JAX package's module names. Imports torch, never JAX and
nothing of the JAX package: what it needs from there (`config`,
`tokenizers`, `data.collate`, `data.mlm`, the vocab assets) it keeps as its
own copies. Kernels are hand-written CUDA in `csrc/`, built on first use
(`ops/_build.py`). Entry points run on the CUDA card unless the caller asks
for another device.
"""
