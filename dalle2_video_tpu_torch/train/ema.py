"""EMA shadow parameters (port of dalle2_video_tpu/train/ema.py).

Same decay spec: before ``update_after_step`` the shadow copies the online
params; after, decay follows 1 - (1 + k/inv_gamma)^-power clamped to
[min_value, beta]; only every ``update_every``-th call blends. The shadow is
a dict of f32 tensors updated in place (the JAX package returns a new tree;
in place saves a copy of the parameters per update).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    beta: float = 0.99
    update_after_step: int = 1000
    update_every: int = 10
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0
    min_value: float = 0.0


@dataclasses.dataclass
class EMAState:
    params: Dict[str, torch.Tensor]  # shadow, by parameter name
    step: int = 0  # number of update() calls so far


def ema_init(params: Mapping[str, torch.Tensor]) -> EMAState:
    return EMAState({k: v.detach().clone() for k, v in params.items()}, 0)


def current_decay(step: int, cfg: EMAConfig) -> float:
    """Decay at a given update step (ema-pytorch's get_current_decay)."""
    epoch = max(step - cfg.update_after_step - 1, 0)
    if epoch <= 0:
        return 0.0
    value = 1.0 - (1.0 + epoch / cfg.inv_gamma) ** -cfg.power
    return min(max(value, cfg.min_value), cfg.beta)


@torch.no_grad()
def ema_update(state: EMAState, online: Mapping[str, torch.Tensor],
               cfg: EMAConfig) -> EMAState:
    """One update() call, in place: shadow = shadow * decay + online *
    (1 - decay) on every ``update_every``-th call (decay 0 copies)."""
    state.step += 1
    if state.step % cfg.update_every == 0:
        decay = current_decay(state.step, cfg)
        names = list(state.params)
        shadow = [state.params[k] for k in names]
        torch._foreach_mul_(shadow, decay)
        torch._foreach_add_(shadow, [online[k].detach().to(shadow[0].dtype) for k in names],
                            alpha=1.0 - decay)
    return state
