"""Long video from the curve teacher, scored (the counterpart of
scripts/demo_longvideo.py).

    python -m dalle2_video_tpu_torch.train.demo_longvideo [--run runs/r2_curve] \
        [--out runs/demo_longvideo] [--n 32] [--frames 64] [--device cuda]

The 16-frame base stage makes 64-frame clips (4x its window) by
sliding-window extension (``engine/longvideo.py``: each window after the
first keeps the last ``OVERLAP`` frames of the one before by replacement).
Scores in ``results.json``:

- the windowed FVD: every 16-frame window (stride 8) of the long clips
  against N_REAL held-out reals (``train/eval_quality.py``'s extractor);
- the drift: the FVD of the first window (a plain sample) and of the last
  (the deepest extension);
- the seam flicker: the mean consecutive-frame L1 at the windows' seams
  over the same statistic everywhere else (``seam_flicker``; ~1 when the
  stitch is as smooth as the clip's own motion), beside the reals' own
  frame-to-frame L1;
- a grid spanning all the frames.

Held-out embeds and reals from RandomState(321), DDIM 64, cond_scale 2.0,
batches of 16, batch s from request seed 7000 + s.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from dalle2_video_tpu_torch.engine.longvideo import generate_long_video
from dalle2_video_tpu_torch.train.eval_quality import (
    BATCH,
    COND_SCALE,
    base_geometry,
    build,
    held_out,
    load_teacher,
)
from dalle2_video_tpu_torch.train.train_curve import RUN, batch_keys
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device
from dalle2_video_tpu_torch.utils.fvd import embed_all, fvd_from_features, vivit_embed_fn
from dalle2_video_tpu_torch.utils.grid import save_grid
from dalle2_video_tpu_torch.utils.profiling import StepTimer

log = logging.getLogger("dalle2_video_tpu_torch.demo_longvideo")

OUT = "runs/demo_longvideo"
N = 32  # long clips generated
N_REAL = 64  # held-out reals, the FVD's reference set
T_LONG = 64  # 4x the 16-frame window
OVERLAP = 4
STEPS = 64
REAL_SEED = 321
SEED_BASE = 7000


def windows(v: np.ndarray, t: int = 16, stride: int = 8) -> np.ndarray:
    """(N, T_long, H, W, C) -> (N * n_win, t, H, W, C) sliding windows."""
    starts = range(0, v.shape[1] - t + 1, stride)
    return np.concatenate([v[:, s:s + t] for s in starts], axis=0)


def seam_flicker(v: np.ndarray, t_win: int, overlap: int) -> dict:
    """Consecutive-frame L1 at window seams vs everywhere else: with stride
    t_win - overlap, window j's first new frame is j * stride + overlap, and
    its seam the transition from the frame before."""
    d = np.abs(np.diff(v, axis=1)).mean(axis=(0, 2, 3, 4))  # (T_long - 1,)
    stride = t_win - overlap
    seams = [j * stride + overlap - 1 for j in range(1, 99)
             if j * stride + overlap - 1 < len(d)]
    rest = [i for i in range(len(d)) if i not in seams]
    return {
        "seam_l1": float(d[seams].mean()),
        "base_l1": float(d[rest].mean()),
        "ratio": float(d[seams].mean() / d[rest].mean()),
    }


def long_clips(decoder, embs: np.ndarray, n_frames: int = T_LONG, overlap: int = OVERLAP,
               batch: int = BATCH, steps: int = STEPS) -> torch.Tensor:
    """Unet 1's ``n_frames``-frame clips of every embed, ``batch`` at a time."""
    embs = torch.from_numpy(embs).to(decoder.device)
    return torch.cat([generate_long_video(
        decoder, batch_keys(SEED_BASE + s, len(embs[s:s + batch])), n_frames=n_frames,
        overlap=overlap, video_embed=embs[s:s + batch], cond_scale=COND_SCALE,
        stop_at_unet_number=1, sample_timesteps=steps)
        for s in range(0, len(embs), batch)])


def demo_longvideo(run: Path = Path(RUN), out: Path = Path(OUT), n: int = N,
                   n_frames: int = T_LONG, n_real: int = N_REAL,
                   device: DeviceLike = None) -> Dict[str, Any]:
    dev = resolve_device(device)
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    cfg, dec = build(dev)
    load_teacher(dec, run)
    reals, embs = held_out(n_real, REAL_SEED, **base_geometry(cfg))
    embed_fn, provenance = vivit_embed_fn(device=dev)
    feats_real = embed_all(reals, embed_fn, BATCH)
    timer = StepTimer()
    timer.start()
    outs = long_clips(dec, embs[:n], n_frames, steps=STEPS)
    dt = timer.stop(outs)
    outs = outs.float().cpu().numpy()
    t_win = dec.config.frame_numbers[0]
    if outs.shape != (n, n_frames, *reals.shape[2:]):
        raise AssertionError(f"long clips of shape {outs.shape}")
    results = {"extractor": provenance, "n": n, "t_long": n_frames, "overlap": OVERLAP,
               "steps": STEPS, "cond_scale": COND_SCALE, "sample_s": dt,
               "frames_per_s": n * n_frames / dt}
    results["fvd_windows"] = fvd_from_features(
        feats_real, embed_all(windows(outs, t_win), embed_fn, BATCH))
    results["fvd_first_window"] = fvd_from_features(
        feats_real, embed_all(outs[:, :t_win], embed_fn, BATCH))
    results["fvd_last_window"] = fvd_from_features(
        feats_real, embed_all(outs[:, -t_win:], embed_fn, BATCH))
    results.update(seam_flicker(outs, t_win, OVERLAP))
    results["real_base_l1"] = float(np.abs(np.diff(reals, axis=1)).mean())
    (out / "results.json").write_text(json.dumps(results, indent=1))
    save_grid(out / "grid_long.png", outs, n_frames=16)
    save_grid(out / "grid_real.png", reals)
    log.info("results: %s", json.dumps(results))
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run", default=RUN, help="the curve's run directory")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--n", type=int, default=N, help="long clips generated")
    ap.add_argument("--frames", type=int, default=T_LONG, help="frames a long clip")
    ap.add_argument("--n-real", type=int, default=N_REAL, help="held-out reals")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(level="INFO")
    return demo_longvideo(Path(args.run), Path(args.out), args.n, args.frames, args.n_real,
                          args.device)


if __name__ == "__main__":
    main()
