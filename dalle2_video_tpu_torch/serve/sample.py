"""Text -> video file (the counterpart of scripts/sample.py, the README's
stage 5): the serving stack answers one request and writes the video.

    python -m dalle2_video_tpu_torch.serve.sample [config.yaml] \
        prompt="a person smiling" cond_scale=3.0 out=samples.npy sample_seed=0

Conditional generation (engine/decoder.py's inpainting):

    # extend a clip: frames 0 and 1 of known.npy are kept exactly
    ... inpaint_video=known.npy inpaint_frames=0,1
    # any region: mask.npy broadcastable to (T, H, W, 1), 1 = known
    ... inpaint_video=known.npy inpaint_mask=mask.npy
    # reconstruction guidance on top of replacement (VDM eq. 7); needs
    # unetN.cross_attention_impl=xla (the flash kernel has no backward)
    ... inpaint_method=guided inpaint_guidance_weight=10

Negative prompting (CFG away from a concept; cond_scale > 1):
``negative_prompt="a blurry face"``. Long video (sliding windows,
engine/longvideo.py): ``n_frames=180 overlap=22``; it refuses
inpainting, whose machinery the windows drive themselves.

The stack is ``serve/stack.py::build_generate_batch``: the checkpoints it
resolves (``<run_dir>/prior_<train_name>``, ``<run_dir>/decoder_
<train_name>``, ``clip.openai_ckpt``), random weights from
``sample_seed`` where there are none. The request's seed is
``sample_seed`` too, so the file holds the server's video for the same
prompt and seed. Sampling runs each stage's configured steps
(``sample_timesteps``; null is the full DDPM chain). ``out`` gets a
float32 (1, T, H, W, C) array in [0, 1]. ``smoke=true`` builds the
server's tiny smoke stack; ``device`` defaults to cuda.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from dalle2_video_tpu_torch.serve.stack import apply_smoke, build_generate_batch
from dalle2_video_tpu_torch.utils.config import config_from_argv
from dalle2_video_tpu_torch.utils.device import resolve_device

log = logging.getLogger("dalle2_video_tpu_torch.sample")


def frame_mask(frames, t: int) -> np.ndarray:
    """The (1, t, 1, 1, 1) mask of the known frames (a list, or "0,1")."""
    if not isinstance(frames, (list, tuple)):
        frames = [int(x) for x in str(frames).split(",")]
    mask = np.zeros((1, t, 1, 1, 1), np.float32)
    mask[:, list(map(int, frames))] = 1.0
    return mask


def request_options(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """generate_batch's keywords for the config's request options:
    inpainting (the known video as a batch of one, its mask or frames),
    the negative prompt, a long video's frame count and overlap (refused
    beside inpainting)."""
    kw: Dict[str, Any] = {}
    if cfg.get("inpaint_video"):
        known = np.asarray(np.load(cfg["inpaint_video"]), np.float32)
        if known.ndim == 4:  # (T, H, W, C) -> batch of 1
            known = known[None]
        if cfg.get("inpaint_mask"):
            mask = np.asarray(np.load(cfg["inpaint_mask"]), np.float32)
            if mask.ndim == 4:
                mask = mask[None]
        else:
            frames = cfg.get("inpaint_frames")
            if frames is None:
                raise SystemExit("inpaint_video needs inpaint_mask=<npy> or inpaint_frames=0,1")
            mask = frame_mask(frames, known.shape[1])
        kw.update(inpaint_video=known, inpaint_mask=mask,
                  inpaint_method=str(cfg.get("inpaint_method", "replace")),
                  inpaint_guidance_weight=float(cfg.get("inpaint_guidance_weight", 10.0)))
        log.info("inpainting: known %s, mask %s, method=%s", known.shape, mask.shape,
                 kw["inpaint_method"])
    if cfg.get("negative_prompt"):
        kw["negative_prompts"] = [str(cfg["negative_prompt"])]
        log.info("negative prompt: %r", cfg["negative_prompt"])
    n_frames = cfg.get("n_frames")
    if n_frames is not None and int(n_frames) > int(cfg["frame_numbers"][-1]):
        if "inpaint_video" in kw:
            raise SystemExit("n_frames= (long video) and inpaint_video= are mutually exclusive: "
                             "the long-video path drives the inpainting machinery itself")
        kw.update(n_frames=int(n_frames),
                  overlap=int(cfg["overlap"]) if cfg.get("overlap") else None)
    return kw


def sample(cfg: Dict[str, Any], generate_batch: Optional[Callable[..., np.ndarray]] = None
           ) -> np.ndarray:
    """One request of the config's prompt and options at ``sample_seed``;
    writes and returns the (1, T, H, W, C) float32 video. ``generate_batch``
    is built from the config unless given."""
    kw = request_options(cfg)  # refusals before the stack is built
    if generate_batch is None:
        generate_batch = build_generate_batch(cfg, log, resolve_device(cfg.get("device")))
    prompt = str(cfg.get("prompt", "a person talking"))
    video = generate_batch([prompt], [int(cfg.get("sample_seed", 0))],
                           cond_scale=float(cfg.get("cond_scale", 1.0)), ddim_steps=None, **kw)
    video = np.asarray(video, np.float32)
    out = cfg.get("out", "samples.npy")
    np.save(out, video)
    log.info("wrote %s %s", out, video.shape)
    return video


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    cfg = config_from_argv(None if argv is None else list(argv))
    logging.basicConfig(level=cfg.get("log_level", "INFO"))
    if bool(cfg.get("smoke", False)):
        cfg = apply_smoke(cfg)
    return sample(cfg)


if __name__ == "__main__":
    main()
