"""dmd_era5_tpu_torch: the PyTorch and CUDA port of dmd_era5_tpu.

The main path of the JAX package on one NVIDIA H100 (Hopper, sm_90a):
the fused sketch/centre/Gram/projection pass over the snapshot matrix
(a hand-written CUDA kernel, ``ops/csrc/``), the randomized Hankel SVD
and the fused fit step built on it, optimized DMD and the forecast.
It imports torch and numpy only; the JAX package is its reference.
"""

__version__ = "0.1.0"
