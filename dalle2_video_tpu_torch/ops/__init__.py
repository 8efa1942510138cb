"""Video ops and the hand-written CUDA kernels of the serving path.

Kernel modules (each holds a ``KERNEL`` with its launch count, the wrapper,
and the plain PyTorch version the wrapper uses for CPU tensors):
  * ``flash_mqa``      -- csrc/flash_mqa.cu
  * ``groupnorm_film`` -- csrc/groupnorm_film.cu
  * ``cross_attention`` -- csrc/cross_attention.cu
"""
