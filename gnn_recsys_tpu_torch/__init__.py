"""PyTorch + CUDA port of ``gnn_recsys_tpu`` for NVIDIA Hopper.

Same sub-package layout and function names as the JAX package, which stays
the reference.  This package imports neither JAX nor anything of
``gnn_recsys_tpu``.  Entry points run on the CUDA device unless the caller
asks for the CPU; the hand-written kernels (``csrc/``) build with ``nvcc``
at first use.
"""
