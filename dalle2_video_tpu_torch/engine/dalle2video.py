"""DALLE2Video: text embedding -> prior -> video embedding -> cascade (port
of dalle2_video_tpu/engine/dalle2video.py: generate, generate_long and
_prior_embeds, with negative prompting, text encodings and the
``temporal_emb`` mode).

Text encodings (b, n, d) go to the prior where its network conditions on
them and to the decoder where one of its unets does. In ``temporal_emb``
mode the text embed is (b, d, t): its t per-frame embeds run through the
prior as b * t rows (the encodings repeated for each), and the (b, t, d)
result is the decoder's per-frame video embed (a decoder built with
``per_frame_embeds=True``). As in the JAX package, that mode refuses per-row
keys (``keys`` is then one key for the whole request, its prior and decoder
rows derived from it), negative prompts and ``generate_long``; and a
negative prompt needs a prior that does not take text encodings (the JAX
package runs the negative prior pass without them).
"""

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
        self.prior = prior
        self.decoder = decoder
        self.temporal_emb = temporal_emb
        self.prior_num_samples = prior_num_samples
        self.decoder_need_text_cond = decoder.condition_on_text_encodings

    @torch.no_grad()
    def generate(
        self,
        keys: RowKeys,
        text_embed: torch.Tensor,
        text_encodings: Optional[torch.Tensor] = None,
        cond_scale: float = 1.0,
        prior_cond_scale: float = 1.0,
        negative_text_embed: Optional[torch.Tensor] = None,
        prior_init_noise: Optional[torch.Tensor] = None,
        negative_prior_init_noise: Optional[torch.Tensor] = None,
        decoder_init_noises: Optional[Sequence[Optional[torch.Tensor]]] = None,
        **sample_kwargs,
    ) -> torch.Tensor:
        """text_embed (b, d), or (b, d, t) in temporal_emb mode -> video (b,
        T, S, S, C) in [0, 1]. ``keys`` has one key per row (one key in
        temporal_emb mode). ``negative_text_embed`` ((b, d) or (1, d)) runs
        the prior on it too and makes the result the decoder's CFG baseline
        (needs cond_scale != 1). Extra kwargs (max_batch_size, inpaint_*,
        negative_text_encodings, sample_timesteps, known_noises) pass to
        decoder.sample. The optional injected draws replace the prior's
        (rows * n, d) x_T, the negative prior's, and each decoder stage's
        x_T."""
        if sample_kwargs.get("inpaint_video") is not None:
            self.decoder.check_inpaint(sample_kwargs.get("inpaint_method", "replace"),
                                       sample_kwargs.get("start_at_unet_number", 1),
                                       sample_kwargs.get("stop_at_unet_number"))
        k_prior, k_dec = self._split_keys(keys, negative_text_embed)
        video_embed, negative_video_embed = self._prior_embeds(
            k_prior, text_embed, prior_cond_scale, prior_init_noise,
            negative_text_embed, negative_prior_init_noise, text_encodings)
        if self.temporal_emb:
            k_dec = k_dec.repeat_interleave(video_embed.shape[0])
        return self.decoder.sample(
            k_dec, video_embed=video_embed,
            text_encodings=text_encodings if self.decoder_need_text_cond else None,
            cond_scale=cond_scale, negative_video_embed=negative_video_embed,
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
        text_encodings: Optional[torch.Tensor] = None,
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
        sample_timesteps, negative_text_encodings, draws) pass to
        generate_long_video."""
        if self.temporal_emb:
            raise ValueError("generate_long is unsupported with temporal_emb")
        plan_windows(self.decoder, n_frames, overlap, long_kwargs.get("inpaint_method", "replace"),
                     long_kwargs.get("stop_at_unet_number"))
        k_prior, k_dec = self._split_keys(keys, negative_text_embed)
        video_embed, negative_video_embed = self._prior_embeds(
            k_prior, text_embed, prior_cond_scale, prior_init_noise,
            negative_text_embed, negative_prior_init_noise, text_encodings)
        return generate_long_video(
            self.decoder, k_dec, n_frames=n_frames, overlap=overlap,
            video_embed=video_embed,
            text_encodings=text_encodings if self.decoder_need_text_cond else None,
            cond_scale=cond_scale, negative_video_embed=negative_video_embed, **long_kwargs,
        )

    def _split_keys(self, keys: RowKeys, negative_text_embed):
        """(prior keys, decoder keys), after the JAX package's refusals."""
        if self.temporal_emb and len(keys) != 1:
            raise ValueError("per-row keys are not supported with temporal_emb")
        if self.temporal_emb and negative_text_embed is not None:
            raise ValueError("negative prompting unsupported with temporal_emb")
        if negative_text_embed is not None and self.prior.config.network.cond_on_text_encodings:
            raise ValueError("negative prompting needs a prior without text encodings: the "
                             "negative prior pass runs without them (JAX dalle2video.py:152-160)")
        return keys.split()

    def _prior_embeds(self, keys: RowKeys, text_embed: torch.Tensor,
                      prior_cond_scale: float, init_noise: Optional[torch.Tensor],
                      negative_text_embed: Optional[torch.Tensor] = None,
                      negative_init_noise: Optional[torch.Tensor] = None,
                      text_encodings: Optional[torch.Tensor] = None):
        """prior.sample on the text embed and, with a negative, on the
        negative broadcast to the batch from its own key fold_in(keys, 1), so
        the positive stream's draws do not move: (video_embed,
        negative_video_embed or None). The encodings reach the prior where
        its network takes them. In temporal_emb mode the (b, d, t) embed is
        b * t prior rows (each row key derived from the one key) and the
        result (b, t, d)."""
        text_embed = text_embed.to(self.prior.device, torch.float32)
        if self.temporal_emb:
            b, d, t = text_embed.shape
            flat = text_embed.transpose(1, 2).reshape(b * t, d)
            enc = None if text_encodings is None else text_encodings.repeat_interleave(t, dim=0)
            keys = keys.repeat_interleave(b * t)
        else:
            flat, enc = text_embed, text_encodings
        if not self.prior.config.network.cond_on_text_encodings:
            enc = None
        sample = lambda k, e, z, enc_: self.prior.sample(  # noqa: E731
            k, e, num_samples_per_batch=self.prior_num_samples,
            cond_scale=prior_cond_scale, init_noise=z, text_encodings=enc_)
        video_embed = sample(keys, flat, init_noise, enc)
        if self.temporal_emb:
            video_embed = video_embed.reshape(b, t, d)
        negative_video_embed = None
        if negative_text_embed is not None:
            neg = negative_text_embed.to(flat).expand_as(flat)
            negative_video_embed = sample(keys.fold_in(1), neg, negative_init_noise, None)
        return video_embed, negative_video_embed
