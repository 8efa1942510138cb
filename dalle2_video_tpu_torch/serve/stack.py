"""The serving stack: tokenizer -> CLIP text tower -> prior -> cascade
(the port's counterpart of scripts/serve.py::build_generate_batch).

``generate_batch`` answers every request option of the JAX callable:
negative prompts (tokenized and run through the text tower and the prior;
the decoder's CFG baseline), inpainting (``inpaint_video`` /
``inpaint_mask`` on the device, ``replace`` or ``guided``) and long video
(``n_frames`` / ``overlap`` route to ``DALLE2Video.generate_long``).

Weights, as scripts/serve.py resolves them: the text tower from
``clip.openai_ckpt`` when set; the prior from ``<run_dir>/prior_
<train_name>`` when it holds a checkpoint (its params subtree, the EMA
shadow preferred); the decoder from ``<run_dir>/decoder_<train_name>`` (the
best state's sampling params: the EMA shadows when the trainer keeps
them). Whatever has no checkpoint keeps random weights made from
``sample_seed``, with a warning -- the text tower too: with no OpenAI
checkpoint it comes from ``sample_seed``, not from the CLIP stage's
stream, as in the JAX server.

``serve_distill: {ckpt, steps, unet}`` serves a distilled student
(``python -m dalle2_video_tpu_torch.train.distill``): the EMA student of
the checkpoint at ``ckpt`` takes cascade slot ``unet`` (default 1) and that
slot alone samples ``steps`` DDIM steps (``train/distill.py::
serve_student``). Students fold CFG in, so serve them at cond_scale 1: one
unguided forward a step.

Data-parallel serving (``serve_data_parallel: true`` under torchrun,
scripts/serve.py's sharded sampler): every rank builds the same stack;
rank 0 runs the engine and the HTTP server, and each dispatched group is
broadcast to every rank (``DataParallelGenerate``), which samples its rows
through the whole stack; the videos are gathered back to rank 0. The other
ranks wait in ``serve_worker`` until rank 0 stops them.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dalle2_video_tpu_torch.data.tokenizer import tokenize
from dalle2_video_tpu_torch.engine.dalle2video import DALLE2Video
from dalle2_video_tpu_torch.engine.decoder import build_decoder
from dalle2_video_tpu_torch.models.clip_text import (
    CLIPTextConfig,
    CLIPTextEncoder,
    load_openai_clip_text_params,
)
from dalle2_video_tpu_torch.models.prior import prior_from_config
from dalle2_video_tpu_torch.parallel.mesh import Mesh
from dalle2_video_tpu_torch.parallel.sharded import make_data_parallel_sampler
from dalle2_video_tpu_torch.train.checkpoint import (
    has_checkpoint,
    load_decoder_sampling_params,
    load_params_subtree,
)
from dalle2_video_tpu_torch.train.distill import serve_student
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


_log = logging.getLogger("dalle2_video_tpu_torch.serve")


def build_stack(cfg: Dict[str, Any], device: DeviceLike = None,
                log: logging.Logger = _log) -> Tuple[CLIPTextEncoder, DALLE2Video]:
    """Text tower + DALLE2Video, from the checkpoints scripts/serve.py
    reads where they exist, else random weights from ``sample_seed``."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(cfg.get("sample_seed", 0)))
        text_enc = CLIPTextEncoder(CLIPTextConfig(embed_dim=cfg["dim"]))
        prior = prior_from_config(cfg, device)
        decoder = build_decoder(cfg, device)
    openai = cfg["clip"].get("openai_ckpt")
    if openai:
        text_enc.load_state_dict(load_openai_clip_text_params(openai), strict=True)
    else:
        log.warning("no OpenAI ckpt: random text tower (smoke mode)")
    text_enc = text_enc.to(device).eval()
    run_dir = Path(cfg["run_dir"])
    prior_ckpt = run_dir / f"prior_{cfg['train_name']}"
    if has_checkpoint(str(prior_ckpt)):
        prior.network.load_state_dict(
            load_params_subtree(str(prior_ckpt), map_location=device), strict=True)
        log.info("loaded prior %s", prior_ckpt)
    else:
        log.warning("no prior checkpoint at %s: random prior (smoke quality only)", prior_ckpt)
    dec_ckpt = run_dir / f"decoder_{cfg['train_name']}"
    if has_checkpoint(str(dec_ckpt)):
        decoder.load_sampling_params(
            load_decoder_sampling_params(str(dec_ckpt), map_location=device))
        log.info("loaded decoder %s", dec_ckpt)
    else:
        log.warning("no decoder checkpoint at %s: random decoder (smoke quality only)",
                    dec_ckpt)
    dist = cfg.get("serve_distill")
    if dist:
        unet_no = int(dist.get("unet", 1))
        serve_student(decoder, str(dist["ckpt"]), int(dist["steps"]), unet_no)
        log.info("distilled student in slot %d: %s (DDIM-%d, CFG folded in)", unet_no,
                 dist["ckpt"], int(dist["steps"]))
    return text_enc, DALLE2Video(prior, decoder)


def build_generate_batch(cfg: Dict[str, Any], log: logging.Logger,
                         device: DeviceLike = None) -> Callable[..., np.ndarray]:
    """generate_batch(prompts, seeds, *, cond_scale, ddim_steps, [request
    options]) -> video (b, T, H, W, C) float32 numpy in [0, 1], the
    GenerationEngine contract, with scripts/serve.py::generate_batch's
    keywords. ddim_steps=None runs each stage's configured schedule (full
    DDPM when sample_timesteps is null); a number runs that many steps of
    the configured few-step sampler (``sampler``: ddim or dpmpp)."""
    text_enc, wrapper = build_stack(cfg, device, log=log)
    dev = wrapper.decoder.device

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


# generate_batch's keywords that carry one entry per row (split over ranks)
ROW_KEYWORDS = ("inpaint_video", "inpaint_mask", "negative_prompts")


class DataParallelGenerate:
    """``generate_batch`` over the mesh's data axis. On rank 0 it is the
    engine's callable: each call is broadcast to every rank, then every
    rank samples its rows (``make_data_parallel_sampler``: prompts, seeds
    and the row keywords split, the rest shared) and rank 0 returns the
    whole group's videos. Groups must be multiples of the data axis
    (``parallel.sharded.data_parallel_buckets``). ``stop`` releases the
    workers."""

    def __init__(self, generate_batch: Callable[..., np.ndarray], mesh: Mesh):
        self.mesh = mesh

        def rows_fn(prompts, seeds, *rows, row_keys=(), **kw):
            return generate_batch(prompts, seeds, **dict(zip(row_keys, rows)), **kw)

        self._sampler = make_data_parallel_sampler(rows_fn, mesh)

    def _broadcast(self, msg):
        box = [msg]
        if self.mesh.world_group is not None:
            dist.broadcast_object_list(box, src=0, group=self.mesh.world_group)
        return box[0]

    def run(self, prompts, seeds, **kw) -> np.ndarray:
        """Every rank's part of one group (called on every rank)."""
        rows = {k: kw.pop(k) for k in ROW_KEYWORDS if kw.get(k) is not None}
        return self._sampler(list(prompts), np.asarray(seeds, dtype=np.uint32),
                             *rows.values(), row_keys=tuple(rows), **kw)

    def __call__(self, prompts, seeds, **kw) -> np.ndarray:
        self._broadcast((list(prompts), np.asarray(seeds), kw))
        return self.run(prompts, seeds, **kw)

    def stop(self) -> None:
        self._broadcast(None)


def serve_worker(dp: DataParallelGenerate) -> int:
    """A rank other than 0: sample its rows of each group rank 0 broadcasts,
    until rank 0 stops. Returns the groups served."""
    served = 0
    while True:
        msg = dp._broadcast(None)
        if msg is None:
            return served
        prompts, seeds, kw = msg
        dp.run(prompts, seeds, **kw)
        served += 1
