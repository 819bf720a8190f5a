"""PyTorch/CUDA port of gerris_tpu (the JAX package stays the reference).

Slice 1a: the 2D uniform-grid lid-cavity Navier-Stokes step under the
fixed one-cycle multigrid schedule, with the multigrid cycle in
hand-written CUDA kernels (ops/cuda/rbgs.py, csrc/rbgs.cu).  The package
imports torch and numpy only; it never imports jax or gerris_tpu.
"""
