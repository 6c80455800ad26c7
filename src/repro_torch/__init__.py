"""PyTorch/CUDA port of the ``repro`` package (inference-time feature injection).

Laid out file for file like ``repro``. It imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``. Entry points run on the CUDA device unless
the caller passes ``device="cpu"``; the hand-written kernels under
``kernels/`` are built with ``nvcc`` at first use (``kernels/_build.py``).
"""
