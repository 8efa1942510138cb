"""Rematerialisation policies for the checkpointed ResnetBlock3Ds (port of
the JAX package's ``nn.remat(ResnetBlock3D, policy=_remat_policy(name))``,
dalle2_video_tpu/models/unet3d.py:54-72, 399-404).

A checkpointed block keeps its inputs and, by policy, the outputs of some
ops; everything else autograd would save is dropped in the forward and
recomputed by running the block again when the backward first needs it.
That is ``torch.utils.checkpoint``'s non-reentrant mode, with selective
checkpointing saving the outputs of the policy's ops. The JAX names:

==================  ===================================================
``nothing``         no op (a plain checkpoint)
``dots``            the matmuls (``aten.mm`` / ``addmm`` / ``bmm``) and the
                    plain convolutions -- jax's ``dots_saveable`` saves
                    ``conv_general_dilated`` with ``dot_general``
``dots_no_batch``   the matmuls without batch dimensions (``mm``, ``addmm``)
``conv``            ``conv_out``: every SpatialConv output, the plain conv
                    (``aten.convolution``) and the conv kernel
                    (``d2v::conv3x3_xbwd``, ops/spatial_conv.py)
``conv_attn``       ``conv`` and ``attn_out`` (``d2v::attn_out``)
``conv_dots``       ``conv`` and ``dots``
==================  ===================================================

The ops stand for the JAX ``checkpoint_name`` sites. The conv kernel is a
ctypes launch, so it runs inside a ``torch.library`` op the policy can see;
the attention outputs pass through ``attn_out``, an identity op (a copy,
made only when a backward may follow).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, FrozenSet, Sequence

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from dalle2_video_tpu_torch.ops import spatial_conv  # noqa: F401 -- registers d2v::conv3x3_xbwd


@torch.library.custom_op("d2v::attn_out", mutates_args=())
def _attn_out(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


_attn_out.register_fake(torch.empty_like)
_attn_out.register_autograd(lambda ctx, g: g)


def attn_out(x: torch.Tensor) -> torch.Tensor:
    """An attention output, tagged ``attn_out`` (the ``checkpoint_name``
    counterpart): through ``d2v::attn_out`` when a backward may follow."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _attn_out(x)
    return x


_aten = torch.ops.aten
_CONV = (_aten.convolution.default, torch.ops.d2v.conv3x3_xbwd.default)
_DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.convolution.default)
POLICIES = {
    "nothing": frozenset(),
    "dots": frozenset(_DOTS),
    "dots_no_batch": frozenset({_aten.mm.default, _aten.addmm.default}),
    "conv": frozenset(_CONV),
    "conv_attn": frozenset({*_CONV, torch.ops.d2v.attn_out.default}),
    "conv_dots": frozenset({*_CONV, *_DOTS}),
}


def saved_ops(policy: str) -> FrozenSet:
    """The ops whose outputs a policy saves; unknown names raise, as in JAX."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; one of {sorted(POLICIES)}")
    return POLICIES[policy]


def checkpoint_block(fn: Callable, inputs: Sequence, policy: str):
    """``fn(*inputs)`` with the block rematerialised under ``policy``.
    ``fn`` closes over the parameters it uses, so the recomputation sees the
    same tensors as the forward (the trainer's bf16 casts of its f32
    masters)."""
    ops = saved_ops(policy)
    if not ops:
        return checkpoint(fn, *inputs, use_reentrant=False)
    return checkpoint(fn, *inputs, use_reentrant=False,
                      context_fn=partial(create_selective_checkpoint_contexts, list(ops)))
