"""Video ops and the hand-written CUDA kernels.

Kernel modules (each holds its ``CudaKernel``s with their launch counts,
the wrappers, and the plain PyTorch versions the wrappers use for CPU
tensors):
  * ``flash_mqa``      -- csrc/flash_mqa.cu (forward), csrc/flash_mqa_bwd.cu
  * ``groupnorm_film`` -- csrc/groupnorm_film.cu (forward),
                          csrc/groupnorm_film_bwd.cu
  * ``cross_attention`` -- csrc/cross_attention.cu (forward only)
"""
