"""DALLE2Video: text embedding -> prior -> video embedding -> cascade (port
of dalle2_video_tpu/engine/dalle2video.py: generate, generate_long and
_prior_embeds, with negative prompting). Not ported yet: temporal_emb mode
(so neither its refusal of negative prompts nor of generate_long arises:
the constructor refuses the mode)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from dalle2_video_tpu_torch.engine.decoder import VideoDecoder
from dalle2_video_tpu_torch.engine.longvideo import generate_long_video, plan_windows
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
        negative_text_embed: Optional[torch.Tensor] = None,
        prior_init_noise: Optional[torch.Tensor] = None,
        negative_prior_init_noise: Optional[torch.Tensor] = None,
        decoder_init_noises: Optional[Sequence[Optional[torch.Tensor]]] = None,
        **sample_kwargs,
    ) -> torch.Tensor:
        """text_embed (b, d) -> video (b, T, S, S, C) in [0, 1]. ``keys`` has
        one key per row. ``negative_text_embed`` ((b, d) or (1, d)) runs the
        prior on it too and makes the result the decoder's CFG baseline
        (needs cond_scale != 1). Extra kwargs (max_batch_size, inpaint_*,
        sample_timesteps, known_noises) pass to decoder.sample. The optional
        injected draws replace the prior's (b * n, d) x_T, the negative
        prior's, and each decoder stage's x_T."""
        if sample_kwargs.get("inpaint_video") is not None:
            self.decoder.check_inpaint(sample_kwargs.get("inpaint_method", "replace"),
                                       sample_kwargs.get("start_at_unet_number", 1),
                                       sample_kwargs.get("stop_at_unet_number"))
        k_prior, k_dec = keys.split()
        video_embed, negative_video_embed = self._prior_embeds(
            k_prior, text_embed, prior_cond_scale, prior_init_noise,
            negative_text_embed, negative_prior_init_noise)
        return self.decoder.sample(
            k_dec, video_embed=video_embed, cond_scale=cond_scale,
            negative_video_embed=negative_video_embed,
            init_noises=decoder_init_noises, **sample_kwargs,
        )

    @torch.no_grad()
    def generate_long(
        self,
        keys: RowKeys,
        text_embed: torch.Tensor,
        *,
        n_frames: int,
        overlap: Optional[int] = None,
        cond_scale: float = 1.0,
        prior_cond_scale: float = 1.0,
        negative_text_embed: Optional[torch.Tensor] = None,
        prior_init_noise: Optional[torch.Tensor] = None,
        negative_prior_init_noise: Optional[torch.Tensor] = None,
        **long_kwargs,
    ) -> torch.Tensor:
        """text -> a video of ``n_frames`` frames: one prior pass, then the
        sliding-window decoding of engine/longvideo.py. Extra kwargs
        (inpaint_method, max_batch_size, stop_at_unet_number,
        sample_timesteps, draws) pass to generate_long_video."""
        plan_windows(self.decoder, n_frames, overlap, long_kwargs.get("inpaint_method", "replace"),
                     long_kwargs.get("stop_at_unet_number"))
        k_prior, k_dec = keys.split()
        video_embed, negative_video_embed = self._prior_embeds(
            k_prior, text_embed, prior_cond_scale, prior_init_noise,
            negative_text_embed, negative_prior_init_noise)
        return generate_long_video(
            self.decoder, k_dec, n_frames=n_frames, overlap=overlap,
            video_embed=video_embed, cond_scale=cond_scale,
            negative_video_embed=negative_video_embed, **long_kwargs,
        )

    def _prior_embeds(self, keys: RowKeys, text_embed: torch.Tensor,
                      prior_cond_scale: float, init_noise: Optional[torch.Tensor],
                      negative_text_embed: Optional[torch.Tensor] = None,
                      negative_init_noise: Optional[torch.Tensor] = None):
        """prior.sample on the text embed and, with a negative, on the
        negative broadcast to the batch from its own key fold_in(keys, 1), so
        the positive stream's draws do not move: (video_embed,
        negative_video_embed or None)."""
        text_embed = text_embed.to(self.prior.device, torch.float32)
        sample = lambda k, e, z: self.prior.sample(
            k, e, num_samples_per_batch=self.prior_num_samples,
            cond_scale=prior_cond_scale, init_noise=z)
        video_embed = sample(keys, text_embed, init_noise)
        negative_video_embed = None
        if negative_text_embed is not None:
            neg = negative_text_embed.to(text_embed).expand_as(text_embed)
            negative_video_embed = sample(keys.fold_in(1), neg, negative_init_noise)
        return video_embed, negative_video_embed
