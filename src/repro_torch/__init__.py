"""PyTorch/CUDA port of the GaLore training path (``src/repro`` is the reference).

The package mirrors the JAX package's subpackages and module names, keeps its
parameter layout (dense kernels stored (d_in, d_out), layers stacked on a
leading L axis, nested dicts keyed like the JAX tree), and imports torch,
numpy and the standard library only. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; the GaLore-Adam leaf steps run as hand-written
Hopper kernel (``csrc/galore_epilogue.cu``) on the card and as their plain
PyTorch versions on the CPU.
"""
