"""Device resolution and the port's float32 numerics policy.

Entry points take ``device=None`` and run on CUDA; ``device="cpu"`` is for
tests. Asking for CUDA where there is none raises: the port never continues
on the CPU behind the caller's back.

TF32 policy (set whenever a CUDA device is resolved):
  * ``torch.backends.cuda.matmul.allow_tf32 = False``
  * ``torch.backends.cudnn.allow_tf32 = False``
The float32 paths (prior, text tower, and any unet run with
``sample_compute_dtype=None``) are the ones held to the JAX reference, which
computes them in full float32; TF32 would keep only ~3 decimal digits there.
The serving unets run in bfloat16, where the TF32 switches have no effect,
so full float32 costs the hot path nothing.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def set_float32_policy() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> cuda. Raises if CUDA is requested and unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is False; "
                "pass device='cpu' explicitly to run on the CPU"
            )
        set_float32_policy()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def dtype_from_name(name: Optional[str]) -> Optional[torch.dtype]:
    """'bfloat16' / 'float32' / None -> torch dtype or None."""
    if name is None:
        return None
    table = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if name not in table:
        raise ValueError(f"unknown compute dtype {name!r}")
    return table[name]
