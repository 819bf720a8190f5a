"""PyTorch/CUDA port of gerris_tpu (the JAX package stays the reference).

Slices 1a-1b: the 2D uniform-grid lid-cavity Navier-Stokes step under
the fixed one-cycle multigrid schedule, with the multigrid cycle
(ops/cuda/rbgs.py, csrc/rbgs.cu), the BCG predictor (ops/cuda/predict.py,
csrc/predict.cu), both projections (ops/cuda/projops.py,
csrc/projops.cu) and the corrector advection (ops/cuda/bcg.py,
csrc/bcg.cu) in hand-written CUDA kernels.  Entry points run on the
CUDA card unless given device="cpu".  The package imports torch and
numpy only; it never imports jax or gerris_tpu.
"""
