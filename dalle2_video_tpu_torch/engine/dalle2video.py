"""DALLE2Video: text embedding -> prior -> video embedding -> cascade (port
of dalle2_video_tpu/engine/dalle2video.py: generate and _prior_embeds).
Not ported yet: temporal_emb mode, negative prompts and generate_long."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from dalle2_video_tpu_torch.engine.decoder import VideoDecoder
from dalle2_video_tpu_torch.models.prior import DiffusionPrior
from dalle2_video_tpu_torch.utils.keys import RowKeys


class DALLE2Video:
    def __init__(self, prior: DiffusionPrior, decoder: VideoDecoder,
                 temporal_emb: bool = False, prior_num_samples: int = 2):
        if temporal_emb:
            raise NotImplementedError("temporal_emb mode is not ported yet")
        self.prior = prior
        self.decoder = decoder
        self.prior_num_samples = prior_num_samples

    @torch.no_grad()
    def generate(
        self,
        keys: RowKeys,
        text_embed: torch.Tensor,
        cond_scale: float = 1.0,
        prior_cond_scale: float = 1.0,
        prior_init_noise: Optional[torch.Tensor] = None,
        decoder_init_noises: Optional[Sequence[Optional[torch.Tensor]]] = None,
        **sample_kwargs,
    ) -> torch.Tensor:
        """text_embed (b, d) -> video (b, T, S, S, C) in [0, 1]. ``keys`` has
        one key per row. The optional injected draws replace the prior's
        (b * n, d) x_T and each decoder stage's x_T."""
        k_prior, k_dec = keys.split()
        video_embed = self._prior_embeds(k_prior, text_embed, prior_cond_scale,
                                         prior_init_noise)
        return self.decoder.sample(
            k_dec, video_embed=video_embed, cond_scale=cond_scale,
            init_noises=decoder_init_noises, **sample_kwargs,
        )

    def _prior_embeds(self, keys: RowKeys, text_embed: torch.Tensor,
                      prior_cond_scale: float,
                      init_noise: Optional[torch.Tensor]) -> torch.Tensor:
        return self.prior.sample(
            keys, text_embed.to(self.prior.device, torch.float32),
            num_samples_per_batch=self.prior_num_samples,
            cond_scale=prior_cond_scale, init_noise=init_noise,
        )
