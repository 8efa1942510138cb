"""Conditional generation on the curve teacher, scored (the counterpart of
scripts/demo_inpaint.py).

    python -m dalle2_video_tpu_torch.train.demo_inpaint [--run runs/r2_curve] \
        [--out runs/demo_inpaint] [--n 64] [--jobs extend,interpolate,spatial,extend_guided] \
        [--device cuda]

The three inpainting modes with the trained base stage (``masks_for``):
video extension (the first 4 of 16 frames known), temporal interpolation
(every 4th frame known), spatial inpainting (the left half of every frame
known), each by replacement, and the extension by reconstruction guidance
(VDM eq. 7) besides. For each: the known region's largest error (the
replacement keeps it within 1e-6), how far the generated region moved
from the reals, the FVD of the clips against the held-out reals
(``train/eval_quality.py``'s extractor) and a grid PNG.

N held-out clips from RandomState(321) (apart from eval_quality's 123),
DDIM 64, cond_scale 2.0, batches of 16, batch s from request seed 5000 +
s. ``results.json`` is merged into; a mode already scored is skipped.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dalle2_video_tpu_torch.train.common import results_file
from dalle2_video_tpu_torch.train.eval_quality import (
    BATCH,
    COND_SCALE,
    base_geometry,
    build,
    held_out,
    load_teacher,
    sample_base,
)
from dalle2_video_tpu_torch.train.train_curve import RUN
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device
from dalle2_video_tpu_torch.utils.fvd import embed_all, fvd_from_features, vivit_embed_fn
from dalle2_video_tpu_torch.utils.grid import save_grid
from dalle2_video_tpu_torch.utils.profiling import StepTimer

log = logging.getLogger("dalle2_video_tpu_torch.demo_inpaint")

OUT = "runs/demo_inpaint"
N = 64
STEPS = 64
REAL_SEED = 321
SEED_BASE = 5000
JOBS = (("extend", "replace"), ("interpolate", "replace"), ("spatial", "replace"),
        ("extend", "guided"))


def masks_for(mode: str, t: int, s: int) -> np.ndarray:
    """The known region (1 = known) of a mode, broadcastable over (b, t, s,
    s, 1)."""
    m = np.zeros((1, t, 1, 1, 1), np.float32)
    if mode == "extend":
        m[:, : t // 4] = 1.0
    elif mode == "interpolate":
        m[:, ::4] = 1.0
    elif mode == "spatial":
        m = np.zeros((1, 1, s, s, 1), np.float32)
        m[:, :, :, : s // 2] = 1.0
    else:
        raise ValueError(mode)
    return m


def tag_of(mode: str, method: str) -> str:
    return mode if method == "replace" else f"{mode}_{method}"


def inpaint(decoder, reals: np.ndarray, embs: np.ndarray, mode: str, method: str,
            batch: int = BATCH, steps: int = STEPS) -> Tuple[np.ndarray, float]:
    """(clips, sampling seconds) of unet 1 conditioned on ``reals`` under
    ``mode``'s mask by ``method``, at ``steps`` DDIM steps."""
    dev = decoder.device
    mask = masks_for(mode, *reals.shape[1:3])
    timer = StepTimer()
    timer.start()
    outs = sample_base(decoder, embs, SEED_BASE, batch, sample_timesteps=steps,
                       inpaint_video=torch.from_numpy(reals).to(dev),
                       inpaint_mask=torch.from_numpy(mask).to(dev), inpaint_method=method)
    dt = timer.stop(outs)
    return outs.float().cpu().numpy(), dt


def known_errors(outs: np.ndarray, reals: np.ndarray, mask: np.ndarray) -> Tuple[float, float]:
    """(the known region's largest |out - real|, the generated region's)."""
    m = np.broadcast_to(mask, outs.shape[:4] + (1,))
    return (float(np.abs((outs - reals) * m).max()),
            float(np.abs((outs - reals) * (1 - m)).max()))


def demo_inpaint(run: Path = Path(RUN), out: Path = Path(OUT), n: int = N,
                 jobs: Sequence[Tuple[str, str]] = JOBS,
                 device: DeviceLike = None) -> Dict[str, Any]:
    dev = resolve_device(device)
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    cfg, dec = build(dev)
    load_teacher(dec, run)
    reals, embs = held_out(n, REAL_SEED, **base_geometry(cfg))
    embed_fn, provenance = vivit_embed_fn(device=dev)
    feats_real = embed_all(reals, embed_fn, BATCH)
    results, flush = results_file(out, {"extractor": provenance, "n": n, "steps": STEPS,
                                    "cond_scale": COND_SCALE})
    for mode, method in jobs:
        tag = tag_of(mode, method)
        if f"{tag}_fvd" in results:
            log.info("%s: already scored, skipped", tag)
            continue
        outs, dt = inpaint(dec, reals, embs, mode, method, steps=STEPS)
        known_err, gen_dev = known_errors(outs, reals, masks_for(mode, *reals.shape[1:3]))
        fvd = fvd_from_features(feats_real, embed_all(outs, embed_fn, BATCH))
        results.update({f"{tag}_known_max_err": known_err, f"{tag}_gen_deviation": gen_dev,
                        f"{tag}_fvd": fvd, f"{tag}_sample_s": dt})
        log.info("%s: known_err %.2e gen_dev %.3f FVD %.4f (%.1f s)", tag, known_err, gen_dev,
                 fvd, dt)
        flush()
        save_grid(out / f"grid_{tag}.png", outs)
    save_grid(out / "grid_real.png", reals)
    return results


def parse_jobs(text: str) -> Tuple[Tuple[str, str], ...]:
    """"extend,spatial,extend_guided" -> ((mode, method), ...)."""
    jobs = []
    for tag in str(text).split(","):
        mode, _, method = tag.partition("_")
        jobs.append((mode, method or "replace"))
    return tuple(jobs)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run", default=RUN, help="the curve's run directory")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--jobs", type=parse_jobs, default=JOBS,
                    help="modes to score: extend, interpolate, spatial, extend_guided")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(level="INFO")
    return demo_inpaint(Path(args.run), Path(args.out), args.n, args.jobs, args.device)


if __name__ == "__main__":
    main()
