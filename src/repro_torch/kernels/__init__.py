"""Hand-written CUDA kernels, each beside its plain PyTorch version.

A wrapper in ``<kernel>/ops.py`` runs the plain version for a tensor on the
CPU and launches the kernel for a tensor on the CUDA device (or raises).
"""
