"""The curve recipe: train the temporal + spatial SR cascade to a real loss
curve on a synthetic corpus (the counterpart of scripts/train_r2_curve.py).
Its EMA cascade is the trained teacher that the quality path scores
(``train/eval_quality.py``, the demos, the curve source of
``train/distill.py`` and ``train/distill_sr_demo.py``).

    python -m dalle2_video_tpu_torch.train.train_curve [steps_per_stage] \
        [run_dir=runs/r2_curve] [train_name=curve] [device=cuda]

- The model: configs/cascade_sr.yaml's geometry (16 x 64^2 base, 64 x 128^2
  joint temporal and spatial SR): unet 1 dim 64, mults (1, 2, 4, 8), 2
  resnet blocks, 16 x 32 heads; unet 2 the same at dim 32 with its joint
  attention through the flash kernels (rows 1 and 2 of the kernel table);
  T 1000, DDIM 64 on both stages, no learned variance (``CURVE_UNETS``,
  ``curve_config``). Trainer: AdamW lr 3e-4, wd 1e-2, EMA 0.99 from step
  100 every 10, clip 0.5, bf16 compute (``CURVE_TRAINER``).
- The corpus: moving Gaussian blobs whose motion, size and colour are
  written into the first 8 entries of a 512-dim conditioning embed
  (``blob_videos``, NumPy, the script's bit for bit): a pool of 64 base
  clips (16 x 64^2) then 16 SR clips (64 x 128^2) from RandomState(0);
  stage u draws batch indices from RandomState(u) (``batches``), 8 clips a
  base step, 1 an SR step. The videos are [0, 1] pictures the decoder maps
  by x 2 - 1 itself (no store normalisation).
- Each step's loss draws come from a generator keyed on (stage, step)
  alone (``step_generator``), so a resume replays nothing: the batch
  stream skips the drawn indices and the step's key is recomputed.
- ``<run_dir>/last`` (the trainer's state) and ``progress.json`` (stage,
  next step) every ``SAVE_EVERY`` steps and after each stage; a relaunch
  resumes from them (``resume=true`` is accepted and changes nothing).
  Once, half way through stage 1, the run saves, reloads ``last`` and goes
  on from the reloaded state (the script's resume exercise).
- ``MetricsLogger`` writes ``<run_dir>/<train_name>.metrics.jsonl`` (the
  loss every ``LOG_EVERY`` steps) and touches ``<train_name>.heartbeat``,
  so ``python -m dalle2_video_tpu_torch.train.elastic`` can supervise it.
- At the end: an EMA cascade sample of two held-out embeds at DDIM 64 and
  cond_scale 3.0 (``samples.npy``), and ``summary.json`` (ms a step, peak
  memory and the first / last 10 losses per stage).
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from dalle2_video_tpu_torch.engine.decoder import VideoDecoder, VideoDecoderConfig
from dalle2_video_tpu_torch.models.unet3d import UNet3DConfig
from dalle2_video_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from dalle2_video_tpu_torch.train.ema import EMAConfig
from dalle2_video_tpu_torch.train.trainer import DecoderTrainer, DecoderTrainerConfig
from dalle2_video_tpu_torch.utils.config import apply_overrides
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device
from dalle2_video_tpu_torch.utils.keys import RowKeys, derive_generator
from dalle2_video_tpu_torch.utils.logging import MetricsLogger

log = logging.getLogger("dalle2_video_tpu_torch.train_curve")

STEPS = 600  # steps a stage
EMB = 512
BATCHES = (8, 1)  # per stage: the SR stage is 64 frames x 128 px
POOLS = ((64, 16, 64), (16, 64, 128))  # (clips, frames, size) per stage
RUN = "runs/r2_curve"
SAVE_EVERY = 500
LOG_EVERY = 25
KEY_SEED = 42
SAMPLE_SEED = 9  # the end sample's request seed (its rows derived from it)
SAMPLE_COND_SCALE = 3.0

CURVE_UNETS = (
    UNet3DConfig(dim=64, dim_mults=(1, 2, 4, 8), video_embed_dim=EMB, num_resnet_blocks=2,
                 attn_heads=16, attn_dim_head=32),
    UNet3DConfig(dim=32, dim_mults=(1, 2, 4, 8), video_embed_dim=EMB, num_resnet_blocks=2,
                 attn_heads=16, attn_dim_head=32, attention_impl="flash"),
)
CURVE_TRAINER = DecoderTrainerConfig(
    lr=3e-4, wd=1e-2, use_ema=True,
    ema=EMAConfig(beta=0.99, update_after_step=100, update_every=10),
    max_grad_norm=0.5, bf16_compute=True)


def curve_config(sample_compute_dtype: Optional[str] = None,
                 unets: Sequence[UNet3DConfig] = CURVE_UNETS) -> VideoDecoderConfig:
    """The recipe's decoder: 16 x 64^2 -> 64 x 128^2, T 1000, DDIM (64,
    64), no learned variance; f32 sampling (the training script's) unless
    ``sample_compute_dtype`` (the scoring scripts' "bfloat16")."""
    return VideoDecoderConfig(unets=tuple(unets), frame_sizes=(64, 128), frame_numbers=(16, 64),
                              timesteps=1000, sample_timesteps=(64, 64), learned_variance=False,
                              sample_compute_dtype=sample_compute_dtype)


def blob_videos(rng: np.random.RandomState, n: int, t: int, s: int):
    """Moving-Gaussian-blob clips (n, t, s, s, 3) f32 in [0, 1] and their
    (n, EMB) conditioning embeds, the motion written into entries 0-7."""
    ys, xs = np.mgrid[0:s, 0:s].astype(np.float32) / s
    vids = np.zeros((n, t, s, s, 3), np.float32)
    embs = np.zeros((n, EMB), np.float32)
    for i in range(n):
        x0, y0 = rng.rand(2) * 0.6 + 0.2
        vx, vy = (rng.rand(2) - 0.5) * 0.4
        sig = 0.08 + rng.rand() * 0.08
        col = rng.rand(3) * 0.8 + 0.2
        for k in range(t):
            cx, cy = x0 + vx * k / t, y0 + vy * k / t
            g = np.exp(-(((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * sig**2)))
            vids[i, k] = g[..., None] * col
        embs[i, :8] = [x0, y0, vx, vy, sig, *col]
    return vids, embs


def batches(pool, bs: int, key_seed: int, dev: torch.device, skip: int = 0
            ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """(videos, embeds) batches of ``pool`` on ``dev``, their indices
    RandomState(key_seed)'s randint draws, the first ``skip`` drawn and
    dropped (a resume's replay)."""
    vids, embs = pool
    r = np.random.RandomState(key_seed)
    for _ in range(skip):
        r.randint(0, len(vids), bs)
    while True:
        idx = r.randint(0, len(vids), bs)
        yield torch.from_numpy(vids[idx]).to(dev), torch.from_numpy(embs[idx]).to(dev)


def step_generator(stage: int, step: int, dev: torch.device) -> torch.Generator:
    """The generator of one step's loss draws: a pure function of (stage,
    step), the script's fold_in(key, stage * 1e6 + step)."""
    return derive_generator(KEY_SEED, stage * 1_000_000 + step, device=dev)


def batch_keys(seed: int, n: int) -> RowKeys:
    """n row keys derived from one request seed (row j: fold_in(key, j)),
    where the JAX scripts sample a batch from one PRNGKey(seed)."""
    return RowKeys.from_request_seeds([seed]).repeat_interleave(n)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_curve(run: Path, steps: int = STEPS, device: DeviceLike = None, *,
                train_name: str = "curve", config: Optional[VideoDecoderConfig] = None,
                pools: Sequence[Tuple[int, int, int]] = POOLS,
                sample_steps: Optional[int] = None, exercise_resume: bool = True,
                ) -> Dict[str, Any]:
    """The recipe's run into ``run`` (see the module docstring), resumed
    from ``progress.json`` where the directory holds one. ``config`` (the
    recipe's by default), ``pools`` and ``sample_steps`` (the end sample's
    DDIM steps a stage; the recipe's 64 by default) are for cut runs.
    Returns the summary, with the trainer under "trainer"."""
    dev = resolve_device(device)
    run = Path(run)
    run.mkdir(parents=True, exist_ok=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        decoder = VideoDecoder(config or curve_config(), dev)
    trainer = DecoderTrainer(decoder, CURVE_TRAINER)
    log.info("device %s; steps a stage %d; unets %s parameters", dev, steps,
             [sum(p.numel() for p in u.parameters()) for u in decoder.unets])

    rng = np.random.RandomState(0)
    data = [blob_videos(rng, *p) for p in pools]  # the base pool, then the SR pool
    mlog = MetricsLogger(str(run), train_name, False, {"steps": steps})
    progress_file, last = run / "progress.json", run / "last"
    start_stage, start_step = 1, 0
    if progress_file.exists() and last.exists():
        prog = json.loads(progress_file.read_text())
        trainer.load_state_dict(load_checkpoint(str(last), map_location=dev))
        start_stage, start_step = prog["stage"], prog["next_step"]
        log.info("resumed from progress.json: stage %d step %d; steps %s", start_stage,
                 start_step, trainer.steps)

    def save_progress(stage: int, next_step: int) -> None:
        save_checkpoint(str(last), trainer.state_dict())
        progress_file.write_text(json.dumps({"stage": stage, "next_step": next_step}))

    summary: Dict[str, Any] = {"steps_per_stage": steps, "ms_per_step": {},
                               "peak_memory_gib": {}, "loss_first10_mean": {},
                               "loss_last10_mean": {}}
    try:
        for u in (1, 2):
            if u < start_stage:
                continue
            i = start_step if u == start_stage else 0
            gen = batches(data[u - 1], BATCHES[u - 1], u, dev, skip=i)
            logged, losses = [], []
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            _sync(dev)
            t0, n0 = time.perf_counter(), i
            while i < steps:
                vid, emb = next(gen)
                trainer.generator = step_generator(u, i, dev)
                loss = trainer.train_step(vid, video_embed=emb, unet_number=u)
                losses.append(loss.detach())
                mlog.heartbeat()
                if i % LOG_EVERY == LOG_EVERY - 1:
                    logged.append(float(loss))  # a host sync once an interval
                    mlog.log({f"train/loss_unet{u}": logged[-1],
                              "window_mean": float(np.mean(logged[-4:]))},
                             step=trainer.steps[u - 1])
                if exercise_resume and u == 1 and i == steps // 2:
                    save_progress(u, i + 1)
                    trainer.load_state_dict(load_checkpoint(str(last), map_location=dev))
                    log.info("resume exercised at step %d: steps %s", i, trainer.steps)
                elif i % SAVE_EVERY == SAVE_EVERY - 1:
                    save_progress(u, i + 1)
                i += 1
            _sync(dev)
            dt, n_done = time.perf_counter() - t0, i - n0
            if n_done:
                ms = dt / n_done * 1e3
                vals = torch.stack(losses).float().cpu().numpy()
                summary["ms_per_step"][u] = ms
                summary["loss_first10_mean"][u] = float(vals[:10].mean())
                summary["loss_last10_mean"][u] = float(vals[-10:].mean())
                if dev.type == "cuda":
                    summary["peak_memory_gib"][u] = torch.cuda.max_memory_allocated(dev) / 2**30
                log.info("stage %d: %d steps in %.1f s (%.1f ms/step, %.1f frames/s); loss, the "
                         "first 10 %.4f, the last 10 %.4f", u, n_done, dt, ms,
                         BATCHES[u - 1] * pools[u - 1][1] / (ms / 1e3),
                         summary["loss_first10_mean"][u], summary["loss_last10_mean"][u])
            save_progress(u + 1, 0)
        save_checkpoint(str(last), trainer.state_dict())

        # the EMA cascade sample (DDIM 64 both stages, cond_scale 3)
        _, test_emb = blob_videos(np.random.RandomState(7), 2, pools[0][1], pools[0][2])
        st = None if sample_steps is None else (sample_steps,) * decoder.config.num_unets
        _sync(dev)
        t0 = time.perf_counter()
        out = trainer.sample(batch_keys(SAMPLE_SEED, 2), use_ema=True,
                             video_embed=torch.from_numpy(test_emb).to(dev),
                             cond_scale=SAMPLE_COND_SCALE, sample_timesteps=st)
        out = out.float().cpu().numpy()
        summary["sample_s"] = time.perf_counter() - t0
        np.save(run / "samples.npy", out)
        summary.update(sample_shape=list(out.shape), sample_steps=list(
            st or decoder.sample_timesteps), sample_range=[float(out.min()), float(out.max())])
        log.info("cascade sample: %s in %.1f s, range (%.3f, %.3f)", out.shape,
                 summary["sample_s"], out.min(), out.max())
        (run / "summary.json").write_text(json.dumps(summary, indent=1))
    finally:
        mlog.close()
    return {**summary, "trainer": trainer}


def parse_argv(argv: Sequence[str]) -> Dict[str, Any]:
    """[steps] [run_dir=...] [train_name=...] [device=...] [resume=...]"""
    steps = [a for a in argv if "=" not in a]
    if len(steps) > 1 or (steps and not steps[0].isdigit()):
        raise SystemExit(f"usage: train_curve [steps_per_stage] [key=value ...]; got {argv}")
    cfg = apply_overrides({"steps": int(steps[0]) if steps else STEPS, "run_dir": RUN,
                           "train_name": "curve", "device": None, "resume": False},
                          [a for a in argv if "=" in a])
    unknown = set(cfg) - {"steps", "run_dir", "train_name", "device", "resume", "log_level"}
    if unknown:
        raise SystemExit(f"train_curve: unknown keys {sorted(unknown)}")
    return cfg


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    cfg = parse_argv(list(sys.argv[1:] if argv is None else argv))
    logging.basicConfig(level=cfg.get("log_level", "INFO"))
    return train_curve(Path(str(cfg["run_dir"])), int(cfg["steps"]), cfg["device"],
                       train_name=str(cfg["train_name"]))


if __name__ == "__main__":
    main()
