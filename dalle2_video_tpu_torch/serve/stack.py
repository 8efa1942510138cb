"""The serving stack: tokenizer -> CLIP text tower -> prior -> cascade
(the port's counterpart of scripts/serve.py::build_generate_batch).

``generate_batch`` answers every request option of the JAX callable:
negative prompts (tokenized and run through the text tower and the prior;
the decoder's CFG baseline), inpainting (``inpaint_video`` /
``inpaint_mask`` on the device, ``replace`` or ``guided``) and long video
(``n_frames`` / ``overlap`` route to ``DALLE2Video.generate_long``).

Weights are random, made from ``sample_seed``: the repository holds no
checkpoints yet, and loading them (and OpenAI CLIP weights) waits until it
does. Distilled students and data-parallel serving are not ported yet.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from dalle2_video_tpu_torch.data.tokenizer import tokenize
from dalle2_video_tpu_torch.engine.dalle2video import DALLE2Video
from dalle2_video_tpu_torch.engine.decoder import build_decoder
from dalle2_video_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from dalle2_video_tpu_torch.models.prior import prior_from_config
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device
from dalle2_video_tpu_torch.utils.keys import RowKeys

SMOKE_OVERRIDES: Dict[str, Any] = {
    # the tiny stack of scripts/serve.py smoke=true
    "frame_sizes": [16, 32],
    "frame_numbers": [2, 2],
    "unet1": {"dim": 16, "dim_mults": [1, 2], "num_resnet_blocks": 1,
              "attn_heads": 2, "attn_dim_head": 8},
    "unet2": {"dim": 8, "dim_mults": [1, 2], "num_resnet_blocks": 1,
              "attn_heads": 2, "attn_dim_head": 8},
}


def apply_smoke(cfg: Dict[str, Any]) -> Dict[str, Any]:
    cfg = dict(cfg)
    cfg.update({k: (dict(v) if isinstance(v, dict) else v)
                for k, v in SMOKE_OVERRIDES.items()})
    cfg["prior"] = dict(cfg["prior"], depth=1, heads=2, sample_timesteps=2)
    cfg.setdefault("serve_ddim_steps", 4)
    cfg.setdefault("serve_buckets", (1, 2))
    return cfg


def build_stack(cfg: Dict[str, Any], device: DeviceLike = None
                ) -> Tuple[CLIPTextEncoder, DALLE2Video]:
    """Text tower + DALLE2Video with random weights from ``sample_seed``."""
    device = resolve_device(device)
    if cfg["clip"].get("openai_ckpt"):
        raise NotImplementedError("loading OpenAI CLIP weights is not ported yet")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(cfg.get("sample_seed", 0)))
        text_enc = CLIPTextEncoder(CLIPTextConfig(embed_dim=cfg["dim"]))
        prior = prior_from_config(cfg, device)
        decoder = build_decoder(cfg, device)
    text_enc = text_enc.to(device).eval()
    return text_enc, DALLE2Video(prior, decoder)


def build_generate_batch(cfg: Dict[str, Any], log: logging.Logger,
                         device: DeviceLike = None) -> Callable[..., np.ndarray]:
    """generate_batch(prompts, seeds, *, cond_scale, ddim_steps, [request
    options]) -> video (b, T, H, W, C) float32 numpy in [0, 1], the
    GenerationEngine contract, with scripts/serve.py::generate_batch's
    keywords. ddim_steps=None runs each stage's configured schedule (full
    DDPM when sample_timesteps is null); a number runs that many steps of
    the configured few-step sampler (``sampler``: ddim or dpmpp)."""
    text_enc, wrapper = build_stack(cfg, device)
    dev = wrapper.decoder.device
    log.warning("random weights (no checkpoints in the repository): smoke quality only")

    def embed(texts):
        return text_enc(torch.as_tensor(tokenize(list(texts)), device=dev))

    @torch.no_grad()
    def generate_batch(prompts, seeds, *, cond_scale, ddim_steps,
                       inpaint_video=None, inpaint_mask=None,
                       inpaint_method="replace", inpaint_guidance_weight=10.0,
                       negative_prompts=None, n_frames=None, overlap=None):
        keys = RowKeys.from_request_seeds(np.asarray(seeds, dtype=np.uint32).tolist())
        kw = dict(cond_scale=float(cond_scale), sample_timesteps=ddim_steps)
        if inpaint_video is not None:
            kw.update(inpaint_video=torch.as_tensor(inpaint_video, dtype=torch.float32,
                                                    device=dev),
                      inpaint_mask=torch.as_tensor(inpaint_mask, dtype=torch.float32,
                                                   device=dev),
                      inpaint_method=str(inpaint_method),
                      inpaint_guidance_weight=float(inpaint_guidance_weight))
        if negative_prompts is not None:
            kw["negative_text_embed"] = embed(negative_prompts)
        if n_frames is not None:
            video = wrapper.generate_long(keys, embed(prompts), n_frames=int(n_frames),
                                          overlap=int(overlap) if overlap else None, **kw)
        else:
            video = wrapper.generate(keys, embed(prompts), **kw)
        return video.float().cpu().numpy()

    return generate_batch
