"""The video-CLIP trainer: a trainable ViViT, a frozen text tower and a
learned temperature (port of dalle2_video_tpu/train/clip_trainer.py).

``clip_stage_generators(seed)`` is the stage's one derivation of its random
streams (the ViViT's init, the text tower's init, the dropout stream):
training and the embeddings handoff both build their towers through it,
so the handoff's frozen text tower is the one the video tower was trained
against. (A random text tower from another stream of the same seed makes
retrieval score exactly chance.)

The optimiser is the JAX chain scale_by_adam -> add_decayed_weights(wd,
the ViViT only, never the temperature) -> scale_by_learning_rate(schedule),
as ``torch.optim.AdamW`` over two groups (decoupled decay scaled by the
lr), its lr set before every update from ``lr_at(count)``, count being the
updates already taken: ``multistep`` (factor ``lr_step_gamma`` from count
>= int(m * total_steps) for each milestone m; milestones that land on one
step collapse into one factor, as the JAX dict of boundaries does),
``cosine`` (optax cosine_decay_schedule, alpha 0.01) or ``constant``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from dalle2_video_tpu_torch.models.clip_text import (
    CLIPTextConfig,
    CLIPTextEncoder,
    load_openai_clip_text_params,
)
from dalle2_video_tpu_torch.models.vivit import ViViT, ViViTConfig
from dalle2_video_tpu_torch.parallel.collectives import all_gather_cat
from dalle2_video_tpu_torch.parallel.mesh import Mesh, active_mesh
from dalle2_video_tpu_torch.parallel.sharded import reduce_gradients
from dalle2_video_tpu_torch.utils.contrastive import clip_loss, retrieval_metrics, sharded_clip_loss
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device
from dalle2_video_tpu_torch.utils.keys import derive_generator, init_from

_CLIP_STAGE = 3  # the key path's tag for the CLIP stage


def clip_stage_generators(seed: int, device: DeviceLike = "cpu"
                          ) -> Tuple[torch.Generator, torch.Generator, torch.Generator]:
    """(ViViT init, text-tower init, dropout): three independent streams of
    ``seed``; the init streams on the CPU, the dropout stream on ``device``."""
    return (derive_generator(seed, _CLIP_STAGE, 0),
            derive_generator(seed, _CLIP_STAGE, 1),
            derive_generator(seed, _CLIP_STAGE, 2, device=torch.device(device)))


def build_text_encoder(cfg: CLIPTextConfig, generator: torch.Generator,
                       openai_ckpt: Optional[str] = None) -> CLIPTextEncoder:
    """The frozen text tower: initialised from ``generator``, then loaded
    from an OpenAI CLIP checkpoint when one is given."""
    with init_from(generator):
        enc = CLIPTextEncoder(cfg)
    if openai_ckpt:
        enc.load_state_dict(load_openai_clip_text_params(openai_ckpt, cfg), strict=True)
    return enc.eval().requires_grad_(False)


@dataclasses.dataclass(frozen=True)
class ClipTrainerConfig:
    lr: float = 1e-3
    lr_scheduler: str = "multistep"  # "cosine" | "multistep" | "constant"
    lr_multistep_milestones: Tuple[float, ...] = (0.4, 0.6, 0.8, 0.9)
    lr_step_gamma: float = 0.5
    total_steps: int = 10_000
    init_temperature: float = 5.0
    weight_decay: float = 0.0


def lr_at(cfg: ClipTrainerConfig, count: int) -> float:
    """The learning rate of the update that follows ``count`` updates."""
    if cfg.lr_scheduler == "cosine":
        frac = min(count, cfg.total_steps) / cfg.total_steps
        alpha = 0.01
        return cfg.lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)
    if cfg.lr_scheduler == "multistep":
        boundaries = {int(m * cfg.total_steps) for m in cfg.lr_multistep_milestones}
        return cfg.lr * cfg.lr_step_gamma ** sum(count >= b for b in boundaries)
    if cfg.lr_scheduler == "constant":
        return cfg.lr
    raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler!r}")


class ClipTrainer:
    """The ViViT and the frozen text tower on ``device`` (CUDA by default),
    both initialised from ``clip_stage_generators(seed)``;
    ``dropout_generator`` is the stage's dropout stream for ``train_step``."""

    def __init__(self, vivit_config: ViViTConfig,
                 text_config: CLIPTextConfig = CLIPTextConfig(),
                 cfg: ClipTrainerConfig = ClipTrainerConfig(), *, seed: int = 0,
                 openai_ckpt: Optional[str] = None, device: DeviceLike = None):
        if cfg.lr_scheduler not in ("cosine", "multistep", "constant"):
            raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        g_vivit, g_text, self.dropout_generator = clip_stage_generators(seed, self.device)
        with init_from(g_vivit):
            vivit = ViViT(vivit_config)
        self.vivit = vivit.to(self.device)
        self.text_encoder = build_text_encoder(text_config, g_text, openai_ckpt).to(self.device)
        self.temperature = nn.Parameter(
            torch.tensor(float(cfg.init_temperature), device=self.device))
        self.optimizer = torch.optim.AdamW(
            [{"params": list(self.vivit.parameters()), "weight_decay": cfg.weight_decay},
             {"params": [self.temperature], "weight_decay": 0.0}],
            lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        self.step = 0

    @torch.no_grad()
    def embed_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text_encoder(tokens.to(self.device))

    @torch.no_grad()
    def embed_video(self, videos: torch.Tensor) -> torch.Tensor:
        self.vivit.eval()
        return self.vivit(videos.to(self.device, torch.float32))

    def train_step(self, videos: torch.Tensor, tokens: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One update of the ViViT and the temperature; returns the loss,
        the updated temperature and top1 / top10 of the step's embeddings
        (0-dim tensors on the device). With dropout configured a
        ``generator`` is required."""
        return self._step(videos, tokens, generator, None)

    def make_sharded_train_step(self, mesh: Mesh):
        """The data-parallel step with the GLOBAL-batch contrastive loss
        (``sharded_clip_loss``): ``step(videos, tokens, generator=None)`` on
        this rank's rows; each rank embeds its rows, the logits span the
        gathered batch, each rank's gradient (its part of the global loss's)
        is summed over the data axis, and every rank takes the same update.
        The metrics are the global batch's (the embeddings gathered)."""
        return lambda videos, tokens, generator=None: self._step(videos, tokens, generator, mesh)

    def _step(self, videos, tokens, generator, mesh: Optional[Mesh]):
        if self.vivit.cfg.has_dropout and generator is None:
            raise ValueError("ViViT dropout / emb_dropout is configured: pass a generator "
                             "to train_step so training applies it")
        text_embeds = self.embed_text(tokens)
        self.vivit.train()
        self.optimizer.zero_grad(set_to_none=True)
        with active_mesh(mesh):  # the dropout draws: this rank's rows of the global batch's
            video_embeds = self.vivit(videos.to(self.device, torch.float32), generator)
        if mesh is None:
            loss = clip_loss(video_embeds, text_embeds, self.temperature)
            loss.backward()
        else:
            loss = sharded_clip_loss(video_embeds, text_embeds, self.temperature, mesh)
            loss.backward()
            reduce_gradients([*self.vivit.parameters(), self.temperature], mesh.data_group,
                             mean=False)
            video_embeds, text_embeds = (all_gather_cat(e.detach(), mesh.data_group, 0)
                                         for e in (video_embeds, text_embeds))
        lr = lr_at(self.cfg, self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        metrics = {"loss": loss.detach(), "temperature": self.temperature.detach().clone()}
        metrics.update(retrieval_metrics(video_embeds.detach(), text_embeds))
        return metrics

    @torch.no_grad()
    def eval_step(self, videos: torch.Tensor, tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        text_embeds = self.embed_text(tokens)
        video_embeds = self.embed_video(videos)
        metrics = {"loss": clip_loss(video_embeds, text_embeds, self.temperature)}
        metrics.update(retrieval_metrics(video_embeds, text_embeds))
        return metrics

    # ------------------------------------------------------------------ #
    def state_dict(self) -> Dict[str, Any]:
        """The JAX ClipTrainState's fields: the ViViT's params, the
        temperature, the optimiser state and the step."""
        return {"vivit_params": self.vivit.state_dict(),
                "temperature": self.temperature.detach().clone(),
                "opt_state": self.optimizer.state_dict(),
                "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.vivit.load_state_dict(state["vivit_params"], strict=True)
        self.temperature.copy_(state["temperature"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
