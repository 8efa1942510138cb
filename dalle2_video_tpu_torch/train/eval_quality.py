"""Quality scoring of the curve teacher (the counterpart of
scripts/eval_quality.py): ViViT-FVD, the sampler's step-count ladder and
sample grids.

    python -m dalle2_video_tpu_torch.train.eval_quality [--ladder 8,16,64,250] \
        [--sampler ddim|dpmpp] [--vivit CKPT] [--run runs/r2_curve] \
        [--out runs/eval_quality] [--n 64] [--device cuda]

It reads ``<run>/last`` (``train/train_curve.py``; the EMA cascade) and:

1. samples N base-stage clips conditioned on held-out blob embeds
   (RandomState(123)) at each ladder point (``--sampler``'s step count on
   unet 1 alone, cond_scale 2.0, in batches of 16, batch s from request
   seed 1000 + s);
2. computes the FVD of each ladder point against the held-out reals, beside
   two anchors: split-half real-vs-real (the floor) and real-vs-noise
   (RandomState(7) uniform noise, the ceiling);
3. writes grids: the base stage at DDIM 64, the reals, one full-cascade 128
   px grid (rows 1 of the kernel table, through the SR unet).

``results.json`` in ``--out`` is merged into, and written after every
point, so a rerun that lost a point adds it (``fvd_<sampler><steps>``,
``sample_s_<sampler><steps>``).

The extractor is ``utils/fvd.py::vivit_embed_fn`` (a fixed-seed ViViT, or a
trained tower's state from ``--vivit``): the numbers compare within one
extractor only. Sampling runs in bf16 (``sample_compute_dtype``), as the
script's ``build``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dalle2_video_tpu_torch.engine.decoder import VideoDecoder, VideoDecoderConfig
from dalle2_video_tpu_torch.train.checkpoint import load_decoder_sampling_params
from dalle2_video_tpu_torch.train.common import results_file
from dalle2_video_tpu_torch.train.train_curve import RUN, batch_keys, blob_videos, curve_config
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device
from dalle2_video_tpu_torch.utils.fvd import (
    compute_fvd,
    embed_all,
    fvd_from_features,
    vivit_embed_fn,
)
from dalle2_video_tpu_torch.utils.grid import save_grid
from dalle2_video_tpu_torch.utils.profiling import StepTimer

log = logging.getLogger("dalle2_video_tpu_torch.eval_quality")

OUT = "runs/eval_quality"
N = 64  # samples a ladder point, and reals
BATCH = 16
LADDER = (8, 16, 64, 250)
SAMPLERS = ("ddim", "dpmpp")
COND_SCALE = 2.0
REAL_SEED = 123  # the held-out corpus (the training pools are RandomState(0))
NOISE_SEED = 7
SEED_BASE = 1000  # batch s samples from request seed SEED_BASE + s
CASCADE_SEED = 2024


def eval_config() -> VideoDecoderConfig:
    """The curve recipe with bf16 sampling (the script's ``build``)."""
    return curve_config(sample_compute_dtype="bfloat16")


def build(device: DeviceLike = None) -> Tuple[VideoDecoderConfig, VideoDecoder]:
    """(``eval_config()``, its decoder on ``device``)."""
    cfg = eval_config()
    return cfg, VideoDecoder(cfg, resolve_device(device))


def load_teacher(decoder: VideoDecoder, run: Path) -> None:
    """The EMA cascade of ``<run>/last`` into ``decoder``."""
    path = Path(run) / "last"
    if not path.exists():
        raise FileNotFoundError(f"no curve checkpoint at {path}: run train.train_curve first")
    decoder.load_sampling_params(load_decoder_sampling_params(str(path),
                                                              map_location=decoder.device))
    log.info("teacher: %s (EMA)", path)


def ladder_config(cfg: VideoDecoderConfig, steps: int, sampler: str) -> VideoDecoderConfig:
    """A ladder point's decoder config: ``steps`` on both stages, ``sampler``."""
    return dataclasses.replace(cfg, sample_timesteps=(steps, steps), sampler=sampler)


def with_config(decoder: VideoDecoder, cfg: VideoDecoderConfig) -> VideoDecoder:
    """A decoder of ``cfg`` holding ``decoder``'s unets' parameters."""
    out = VideoDecoder(cfg, decoder.device)
    out.load_sampling_params([dict(u.state_dict()) for u in decoder.unets])
    return out


def sample_base(decoder: VideoDecoder, embs, seed_base: int = SEED_BASE,
                batch: int = BATCH, cond_scale: float = COND_SCALE, **kw) -> torch.Tensor:
    """Unet 1's clips of every embed, ``batch`` at a time, batch s from
    request seed ``seed_base + s``; ``kw`` indexed by batch where it is a
    per-row tensor of len(embs) rows (inpaint_video), else passed whole."""
    embs = torch.as_tensor(embs).to(decoder.device, torch.float32)
    n = embs.shape[0]
    out = []
    for s in range(0, n, batch):
        sl = slice(s, s + batch)
        rows = {k: (v[sl] if isinstance(v, torch.Tensor) and v.shape[0] == n else v)
                for k, v in kw.items()}
        out.append(decoder.sample(batch_keys(seed_base + s, len(embs[sl])), video_embed=embs[sl],
                                  cond_scale=cond_scale, stop_at_unet_number=1, **rows))
    return torch.cat(out)


def held_out(n: int, seed: int = REAL_SEED, frames: int = 16, size: int = 64):
    """(reals, embeds) of n held-out blob clips."""
    return blob_videos(np.random.RandomState(seed), n, frames, size)


def base_geometry(cfg: VideoDecoderConfig) -> Dict[str, int]:
    """The base stage's clip geometry: held_out's ``frames`` and ``size``
    (16 x 64^2 in the recipe)."""
    return dict(frames=cfg.frame_numbers[0], size=cfg.frame_sizes[0])


def eval_quality(run: Path = Path(RUN), out: Path = Path(OUT), n: int = N,
                 ladder: Sequence[int] = LADDER, sampler: str = "ddim",
                 vivit: Optional[str] = None, device: DeviceLike = None) -> Dict[str, Any]:
    """The script's scoring (see the module docstring); returns the results."""
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler {sampler!r} not in {SAMPLERS}")
    dev = resolve_device(device)
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    cfg, dec = build(dev)
    load_teacher(dec, run)
    reals, embs = held_out(n, **base_geometry(cfg))
    embed_fn, provenance = vivit_embed_fn(device=dev, ckpt=vivit)
    log.info("FVD extractor: %s", provenance)
    results, flush = results_file(out, {"extractor": provenance, "n": n, "cond_scale": COND_SCALE})

    feats_real = embed_all(reals, embed_fn, BATCH)  # embedded once
    half = n // 2
    results["fvd_real_vs_real_splithalf"] = fvd_from_features(feats_real[:half],
                                                              feats_real[half:])
    noise = np.random.RandomState(NOISE_SEED).rand(*reals.shape).astype(np.float32)
    results["fvd_real_vs_noise"] = compute_fvd(reals, noise, embed_fn, BATCH)
    log.info("anchors: real vs real (split half) %.4f, real vs noise %.4f",
             results["fvd_real_vs_real_splithalf"], results["fvd_real_vs_noise"])
    flush()

    for st in ladder:
        dec_st = with_config(dec, ladder_config(cfg, st, sampler))
        timer = StepTimer()
        timer.start()
        fakes = sample_base(dec_st, embs)
        dt = timer.stop(fakes)
        fakes = fakes.float().cpu().numpy()
        fvd = fvd_from_features(feats_real, embed_all(fakes, embed_fn, BATCH))
        results[f"fvd_{sampler}{st}"] = fvd
        results[f"sample_s_{sampler}{st}"] = dt
        log.info("%s-%d: FVD %.4f (%.1f s for %d clips)", sampler.upper(), st, fvd, dt, n)
        flush()
        if st == 64 and sampler == "ddim":
            save_grid(out / "grid_base_ddim64.png", fakes)
            np.save(out / "samples_base_ddim64.npy", fakes[:8])
        del dec_st
    save_grid(out / "grid_real.png", reals)

    # one full-cascade grid (base -> 64-frame 128 px SR)
    timer = StepTimer()
    timer.start()
    casc = dec.sample(batch_keys(CASCADE_SEED, 2), video_embed=torch.from_numpy(embs[:2]).to(dev),
                      cond_scale=COND_SCALE)
    results["cascade_sample_s"] = timer.stop(casc)
    casc = casc.float().cpu().numpy()
    save_grid(out / "grid_cascade_128px.png", casc, n_rows=2)
    results["cascade_sample_shape"] = list(casc.shape)
    results["cascade_sample_range"] = [float(casc.min()), float(casc.max())]
    flush()
    log.info("RESULTS %s", json.dumps(results))
    return results


def parse_ladder(text: str) -> Tuple[int, ...]:
    return tuple(int(x) for x in str(text).split(","))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ladder", type=parse_ladder, default=LADDER, help="e.g. 8,16,64,250")
    ap.add_argument("--sampler", default="ddim", choices=SAMPLERS)
    ap.add_argument("--vivit", default=None, help="a trained extractor tower's checkpoint")
    ap.add_argument("--run", default=RUN, help="the curve's run directory")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--n", type=int, default=N, help="samples a ladder point, and reals")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(level="INFO")
    return eval_quality(Path(args.run), Path(args.out), args.n, args.ladder, args.sampler,
                        args.vivit, args.device)


if __name__ == "__main__":
    main()
