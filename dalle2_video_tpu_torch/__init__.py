"""PyTorch + CUDA port of dalle2_video_tpu for NVIDIA Hopper (H100).

The JAX package ``dalle2_video_tpu`` is the reference; this package mirrors
its subpackage and module names (``diffusion/``, ``ops/``, ``models/``,
``engine/``, ``serve/``, ``utils/``, ``data/``) so each module has an obvious
counterpart. It imports ``torch`` and never ``jax``, ``flax`` or the JAX
package.

Conventions:
  * public functions keep the JAX layout ``(B, T, H, W, C)``;
  * entry points run on ``cuda`` unless the caller passes ``device="cpu"``
    (``utils.device.resolve_device``), and raise when CUDA is asked for and
    absent;
  * the three TPU kernels on the serving path (flash-MQA, GroupNorm-FiLM-
    SiLU, tiny-context cross-attention) are CUDA C++ kernels under
    ``csrc/``, built with ``nvcc`` at first use (``ops/_cuda.py``). Each
    wrapper launches its kernel for a CUDA tensor and uses its plain
    PyTorch version only for a CPU tensor.
"""

__version__ = "0.1.0"
