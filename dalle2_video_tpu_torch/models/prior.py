"""Diffusion prior: text embedding -> video embedding (port of
dalle2_video_tpu/models/prior.py).

``DiffusionPriorNetwork`` is the causal transformer over
[text_embed, time_embed, noised_video_embed, learned_query] (rotary, T5
relative-position bias, SwiGLU feed-forward); the prediction is read at the
learned-query position. With ``cond_on_text_encodings`` the text
encodings lead the sequence: projected by ``enc_proj``, cut to
``max_text_len`` (not padded: min(n, 77) + 4 tokens), each token whose
encoding is all zero, or whose row the keep mask drops, swapped for its
``null_text_encodings`` row. ``DiffusionPrior.loss`` is the training loss (x0
scaled by ``embed_scale``, q_sample at uniform times on the schedule, the
text dropped to the null embed at ``text_cond_drop_prob``, l2 against x0),
every draw injectable; ``DiffusionPrior.sample`` is best-of-N DDIM (eta 0)
with cosine reranking against the text embed, the encodings repeated per
candidate. Not ported yet (they raise): mixture-of-experts, the scanned /
pipelined layer stack and self-conditioning.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from dalle2_video_tpu_torch.diffusion import DiffusionSchedule
from dalle2_video_tpu_torch.models.layers import (
    Attention,
    Dense,
    LayerNorm,
    ScaleOnlyLayerNorm,
    sinusoidal_pos_emb,
)
from dalle2_video_tpu_torch.ops.as_jax import silu_as_jax
from dalle2_video_tpu_torch.utils.contrastive import l2_normalize
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device
from dalle2_video_tpu_torch.utils.keys import RowKeys


class FeedForward(nn.Module):
    """SwiGLU feed-forward (flax names norm / Dense_0 / Dense_1)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.norm = ScaleOnlyLayerNorm(dim)
        self.Dense_0 = Dense(dim, dim * mult * 2, bias=False)
        self.Dense_1 = Dense(dim * mult, dim, bias=False)

    def forward(self, x):
        a, gate = self.Dense_0(self.norm(x)).chunk(2, dim=-1)
        return x + self.Dense_1(a * silu_as_jax(gate))


class RelPosBias(nn.Module):
    """T5-style bucketed causal relative position bias -> (heads, n, n)."""

    def __init__(self, heads: int, num_buckets: int = 32, max_distance: int = 128):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.table = nn.Parameter(torch.randn(num_buckets, heads) * 0.02)

    def forward(self, n: int) -> torch.Tensor:
        dev = self.table.device
        pos = torch.arange(n, device=dev)
        rel = -torch.clamp(pos[None, :] - pos[:, None], max=0)
        exact = self.num_buckets // 2
        log_ratio = torch.log(rel.float() / exact + 1e-6) / np.log(self.max_distance / exact)
        large = exact + (log_ratio * (self.num_buckets - exact)).to(torch.int64)
        large = torch.clamp(large, max=self.num_buckets - 1)
        buckets = torch.where(rel < exact, rel, large)
        return self.table[buckets].permute(2, 0, 1)


class CausalTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 rotary: bool = True, rel_pos_bias: bool = True):
        super().__init__()
        self.depth = depth
        self.rel_pos_bias = RelPosBias(heads) if rel_pos_bias else None
        for i in range(depth):
            self.add_module(f"attn{i}", Attention(dim, heads=heads, dim_head=dim_head,
                                                  causal=True, rotary=rotary))
            self.add_module(f"ff{i}", FeedForward(dim))
        self.final_norm = LayerNorm(dim)

    def forward(self, x):
        bias = self.rel_pos_bias(x.shape[1]) if self.rel_pos_bias is not None else None
        for i in range(self.depth):
            x = x + getattr(self, f"attn{i}")(x, attn_bias=bias)
            x = getattr(self, f"ff{i}")(x)
        return self.final_norm(x)


@dataclasses.dataclass(frozen=True)
class PriorNetworkConfig:
    dim: int = 512
    depth: int = 6
    heads: int = 8
    dim_head: int = 64
    max_text_len: int = 77
    cond_on_text_encodings: bool = False
    text_encoding_dim: Optional[int] = None
    self_cond: bool = False
    rotary_emb: bool = True
    rel_pos_bias: bool = True
    swiglu_ff: bool = True
    scan_layers: bool = False
    pipeline_microbatches: int = 0
    ff_experts: int = 0
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 1e-2


class DiffusionPriorNetwork(nn.Module):
    def __init__(self, cfg: PriorNetworkConfig):
        super().__init__()
        unported = [k for k, v in {
            "self_cond": cfg.self_cond,
            "swiglu_ff=False": not cfg.swiglu_ff,
            "scan_layers": cfg.scan_layers or cfg.pipeline_microbatches > 0,
            "ff_experts": cfg.ff_experts > 0,
        }.items() if v]
        if unported:
            raise NotImplementedError(f"prior options not ported yet: {unported}")
        self.cfg = cfg
        d = cfg.dim
        self.time_proj = Dense(d, d)
        self.null_text_embed = nn.Parameter(torch.randn(1, d))
        self.learned_query = nn.Parameter(torch.randn(1, d))
        if cfg.cond_on_text_encodings:
            self.enc_proj = Dense(cfg.text_encoding_dim or d, d)
            self.null_text_encodings = nn.Parameter(torch.randn(1, cfg.max_text_len, d))
        self.transformer = CausalTransformer(
            d, cfg.depth, cfg.heads, cfg.dim_head,
            rotary=cfg.rotary_emb, rel_pos_bias=cfg.rel_pos_bias)

    def forward(self, video_embed_noisy, time, *, text_embed, text_encodings=None,
                text_keep_mask=None):
        b, d = video_embed_noisy.shape
        if text_keep_mask is None:
            text_keep_mask = torch.ones(b, dtype=torch.bool, device=time.device)
        t_emb = self.time_proj(sinusoidal_pos_emb(time, d))
        te = torch.where(text_keep_mask[:, None], text_embed, self.null_text_embed)
        seq = torch.stack(
            [te, t_emb, video_embed_noisy, self.learned_query.expand(b, d)], dim=1)
        if self.cfg.cond_on_text_encodings:
            if text_encodings is None:
                raise ValueError("cond_on_text_encodings=True but no text_encodings passed")
            n_max = self.cfg.max_text_len
            enc = self.enc_proj(text_encodings)[:, :n_max]
            keep = (text_encodings != 0).any(-1)[:, :n_max] & text_keep_mask[:, None]
            enc = torch.where(keep[:, :, None], enc, self.null_text_encodings[:, :enc.shape[1]])
            seq = torch.cat([enc, seq], dim=1)
        return self.transformer(seq)[:, -1]


@dataclasses.dataclass(frozen=True)
class DiffusionPriorConfig:
    network: PriorNetworkConfig = PriorNetworkConfig()
    timesteps: int = 1000
    sample_timesteps: Optional[int] = 64
    beta_schedule: str = "cosine"
    loss_type: str = "l2"
    predict_x_start: bool = True
    text_cond_drop_prob: float = 0.1
    video_embed_scale: Optional[float] = None
    sampling_clamp_l2norm: bool = False
    training_clamp_l2norm: bool = False


def prior_from_config(cfg: Dict[str, Any], device: DeviceLike = None) -> "DiffusionPrior":
    """Build the prior from the config's ``prior:`` block and global ``dim``."""
    pc = cfg["prior"]
    return DiffusionPrior(
        DiffusionPriorConfig(
            network=PriorNetworkConfig(
                dim=cfg["dim"], depth=pc["depth"], heads=pc["heads"],
                dim_head=pc["dim_head"],
                scan_layers=bool(pc.get("scan_layers", False)),
                pipeline_microbatches=int(pc.get("pipeline_microbatches", 0)),
                ff_experts=int(pc.get("ff_experts", 0)),
            ),
            timesteps=pc["timesteps"],
            sample_timesteps=pc["sample_timesteps"],
        ),
        device=device,
    )


class DiffusionPrior:
    """Engine: the training loss and best-of-N reranked DDIM sampling in
    embed space, on ``device`` (CUDA by default)."""

    def __init__(self, config: DiffusionPriorConfig, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.network = DiffusionPriorNetwork(config.network).to(self.device).eval()
        self.schedule = DiffusionSchedule.create(
            config.beta_schedule, config.timesteps, device=self.device,
            loss_type=config.loss_type)
        self.embed_scale = (config.video_embed_scale
                            if config.video_embed_scale is not None
                            else config.network.dim**0.5)

    def loss(self, video_embed: torch.Tensor, text_embed: torch.Tensor,
             text_encodings: Optional[torch.Tensor] = None, *,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """The denoising loss of a (b, d) batch, a 0-dim f32 tensor, through
        the network in its current mode (the trainer sets train mode);
        ``text_encodings`` (b, n, d_enc) where the network takes them.
        ``draws`` injects any of "times" (b,), "noise" (b, d) and
        "text_keep" (b,) bool; the rest come from ``generator``."""
        cfg = self.config
        sched = self.schedule
        dev = self.device
        draws = draws or {}

        def draw(name, fn):
            v = draws.get(name)
            return fn() if v is None else torch.as_tensor(v).to(dev)

        x0 = video_embed.to(dev, torch.float32) * self.embed_scale
        b = x0.shape[0]
        times = draw("times", lambda: sched.sample_random_times(b, generator)).long()
        noise = draw("noise", lambda: torch.randn(x0.shape, generator=generator, device=dev))
        keep = draw("text_keep", lambda: torch.rand(
            b, generator=generator, device=dev) < 1.0 - cfg.text_cond_drop_prob)
        pred = self.network(sched.q_sample(x0, times, noise), times,
                            text_embed=text_embed.to(dev, torch.float32),
                            text_encodings=self._on_device(text_encodings),
                            text_keep_mask=keep.bool())
        if cfg.training_clamp_l2norm:
            pred = l2_normalize(pred) * self.embed_scale
        target = x0 if cfg.predict_x_start else noise
        return sched.loss_fn(pred, target).mean()

    def _on_device(self, a: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return None if a is None else a.to(self.device, torch.float32)

    def _pred_x0(self, x, t, cond_scale, text_embed, text_encodings=None):
        b = x.shape[0]
        if cond_scale == 1.0:
            pred = self.network(x, t, text_embed=text_embed, text_encodings=text_encodings)
        else:
            keep = torch.cat([torch.ones(b, dtype=torch.bool, device=x.device),
                              torch.zeros(b, dtype=torch.bool, device=x.device)])
            dup = lambda a: None if a is None else torch.cat([a, a])  # noqa: E731
            out2 = self.network(dup(x), dup(t), text_embed=dup(text_embed),
                                text_encodings=dup(text_encodings), text_keep_mask=keep)
            pred = out2[b:] + (out2[:b] - out2[b:]) * cond_scale
        cfg = self.config
        x0 = pred if cfg.predict_x_start else self.schedule.predict_start_from_noise(x, t, pred)
        if cfg.sampling_clamp_l2norm:
            x0 = l2_normalize(x0) * self.embed_scale
        return x0

    @torch.no_grad()
    def sample_loop(self, keys: RowKeys, text_embed: torch.Tensor,
                    cond_scale: float = 1.0,
                    init_noise: Optional[torch.Tensor] = None, *,
                    text_encodings: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Deterministic DDIM (eta 0) in embed space. ``init_noise`` (b, d)
        replaces the draw from ``keys`` (tests inject the JAX draws)."""
        sched = self.schedule
        text_encodings = self._on_device(text_encodings)
        b, d = text_embed.shape
        k_init, _ = keys.split()
        x = (k_init.normal((b, d), self.device) if init_noise is None
             else init_noise.to(self.device, torch.float32))
        steps = self.config.sample_timesteps or sched.num_timesteps
        times = np.linspace(-1, sched.num_timesteps - 1, steps + 1).astype(int)[::-1]
        acp = torch.cat([torch.ones(1, device=self.device), sched.alphas_cumprod])
        for tn, tnx in zip(times[:-1], times[1:]):
            tvec = torch.full((b,), int(tn), dtype=torch.long, device=self.device)
            x0 = self._pred_x0(x, tvec, cond_scale, text_embed, text_encodings)
            eps = sched.predict_noise_from_start(x, tvec, x0)
            a_next = acp[int(tnx) + 1]
            x = x0 * torch.sqrt(a_next) + torch.sqrt(1.0 - a_next) * eps
        return x / self.embed_scale

    @torch.no_grad()
    def sample(self, keys: RowKeys, text_embed: torch.Tensor,
               num_samples_per_batch: int = 2, cond_scale: float = 1.0,
               init_noise: Optional[torch.Tensor] = None, *,
               text_encodings: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Best-of-N: candidate j of row i draws from fold_in(key_i, j); the
        candidate most cosine-similar to the text embed wins. The text
        encodings (b, n_tokens, d_enc) are repeated per candidate, as the
        embed. ``init_noise`` is (b * n, d), rows in (row, candidate) order."""
        n = num_samples_per_batch
        b, d = text_embed.shape
        rep = text_embed.repeat_interleave(n, dim=0)
        rep_enc = None if text_encodings is None else text_encodings.repeat_interleave(n, dim=0)
        embeds = self.sample_loop(keys.repeat_interleave(n), rep, cond_scale, init_noise,
                                  text_encodings=rep_enc).reshape(b, n, d)
        sims = torch.einsum("bd,bnd->bn", l2_normalize(text_embed),
                            l2_normalize(embeds))
        best = sims.argmax(dim=-1)
        return embeds[torch.arange(b, device=embeds.device), best]
