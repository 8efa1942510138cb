"""Latent-diffusion stage 0: train the VQGAN-VAE (counterpart of
scripts/train_vqgan.py).

    python -m dalle2_video_tpu_torch.train.train_vqgan [configs/celebv_text.yaml] [key=value ...]
    python -m dalle2_video_tpu_torch.train.train_vqgan videos.preprocessed=<store>
    python -m dalle2_video_tpu_torch.train.train_vqgan smoke=true device=cpu

The ``vqgan`` section's keys, as the JAX script reads them: the VQVAE
(``latent_dim``, ``base_dim``, ``num_down``, ``codebook_size``,
``codebook_ema``, ``codebook_ema_decay``), the discriminator
(``disc_base_dim``, ``disc_layers``), the trainer (``lr_g``, ``lr_d``,
``disc_start``, ``disc_weight``, ``perceptual_weight``), ``batch_size`` and
``epochs``. ``smoke=true`` trains the JAX script's shrunken widths on its 8
synthetic (2, 16, 16, 3) clips (``RandomState(0).rand``). Otherwise the
clips come from the store at ``videos.preprocessed`` (``CelebVTextDataset``
with the store alone; the JAX script's dataset has no such stage), each
batch sized on the device to ``vqgan.frames`` x ``vqgan.frame_size`` x
``vqgan.frame_size`` (nearest in time and space, as the decoder's loss
sizes a stage's clips), the geometry the recipe trains at. Splits by
``split_indices(len, train_ratio, seed)``; the thread loader batches
(``BatchLoader``, train shuffled by seed + epoch). The VAE's and the
discriminator's weights come from two streams of ``seed``.

Each epoch logs the mean train metrics (one host sync an epoch) and the
validation metrics, and saves the whole trainer state (VAE,
discriminator, both optimisers, step, ``vq_ema``) under
``<run_dir>/vqgan_<train_name>`` (newest ``ckpt_keep``, best 1 by
``val_loss`` = ``val/rec_l1``); ``resume=true`` carries on from the
newest. A consumer that wants the VAE alone reads ``vae_params`` out of it
(``load_vqvae``). Runs on CUDA unless ``device=cpu``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from dalle2_video_tpu_torch.data.datasets import BatchLoader, CelebVTextDataset, split_indices
from dalle2_video_tpu_torch.models.discriminator import PatchDiscriminator
from dalle2_video_tpu_torch.models.vqvae import VQVAE
from dalle2_video_tpu_torch.ops.video import resize_video, resize_video_time
from dalle2_video_tpu_torch.train.checkpoint import RollingCheckpointManager, load_latest
from dalle2_video_tpu_torch.train.common import check_single_device
from dalle2_video_tpu_torch.train.vqgan_trainer import VQGanTrainer, VQGanTrainerConfig
from dalle2_video_tpu_torch.utils.config import config_from_argv
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device
from dalle2_video_tpu_torch.utils.keys import derive_generator
from dalle2_video_tpu_torch.utils.logging import MetricsLogger

log = logging.getLogger("dalle2_video_tpu_torch.train_vqgan")

_VQGAN_STAGE = 5  # the key path's tag for the VQGAN stage

# scripts/train_vqgan.py's smoke widths
SMOKE_VQGAN = dict(batch_size=2, epochs=2, frame_size=16, frames=2, base_dim=8, latent_dim=4,
                   num_down=1, codebook_size=32, disc_start=2, disc_base_dim=8, disc_layers=1)


class SyntheticVideos:
    """scripts/train_vqgan.py's smoke set: 8 seeded (2, 16, 16, 3) clips."""

    def __init__(self):
        self.videos = np.random.RandomState(0).rand(8, 2, 16, 16, 3).astype(np.float32)

    def __len__(self) -> int:
        return len(self.videos)

    def batch_items(self, idx) -> Dict[str, np.ndarray]:
        return {"videos": self.videos[idx]}


def build_vqvae(vq: Dict[str, Any], device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> VQVAE:
    """The VQVAE of a ``vqgan`` section."""
    return VQVAE(latent_dim=int(vq.get("latent_dim", 4)), base_dim=int(vq.get("base_dim", 64)),
                 num_down=int(vq.get("num_down", 2)),
                 codebook_size=int(vq.get("codebook_size", 512)),
                 codebook_ema=bool(vq.get("codebook_ema", False)),
                 ema_decay=float(vq.get("codebook_ema_decay", 0.99)),
                 device=device, generator=generator)


def build_vqgan_trainer(cfg: Dict[str, Any], vq: Dict[str, Any],
                        device: DeviceLike = None) -> VQGanTrainer:
    """The VQVAE, the discriminator and their trainer; weights from seed's
    streams."""
    dev = resolve_device(device)
    seed = cfg["seed"]
    vae = build_vqvae(vq, dev, derive_generator(seed, _VQGAN_STAGE, 0))
    disc = PatchDiscriminator(base_dim=int(vq.get("disc_base_dim", 64)),
                              num_layers=int(vq.get("disc_layers", 3)), device=dev,
                              generator=derive_generator(seed, _VQGAN_STAGE, 1))
    return VQGanTrainer(vae, disc, VQGanTrainerConfig(
        lr_g=float(vq.get("lr_g", 1e-4)), lr_d=float(vq.get("lr_d", 1e-4)),
        disc_start=int(vq.get("disc_start", 1000)),
        disc_weight=float(vq.get("disc_weight", 0.8)),
        perceptual_weight=float(vq.get("perceptual_weight", 1.0))))


def load_vqvae(path: str, vq: Dict[str, Any], device: DeviceLike = None) -> VQVAE:
    """The VQVAE of the newest VQGAN state under ``path`` (a frozen VAE for
    a latent decoder stage: eval mode, no gradients)."""
    dev = resolve_device(device)
    vae = build_vqvae(vq, dev)
    vae.load_state_dict(load_latest(path, map_location=dev)["vae_params"], strict=True)
    return vae.eval().requires_grad_(False)


def train_vqgan(cfg: Dict[str, Any], vq: Dict[str, Any], dataset,
                splits: Dict[str, np.ndarray], device: DeviceLike = None) -> Dict[str, Any]:
    """scripts/train_vqgan.py's loop on one device. Returns the trainer and
    the last epoch's mean train and val metrics."""
    check_single_device(cfg)
    dev = resolve_device(device)
    bs = int(vq.get("batch_size", 8))
    frames, size = int(vq.get("frames", 4)), int(vq.get("frame_size", 64))
    train_loader = BatchLoader(dataset, bs, splits["train"], shuffle=True, seed=cfg["seed"])
    val_loader = BatchLoader(dataset, bs, splits["val"], shuffle=False)
    trainer = build_vqgan_trainer(cfg, vq, dev)
    name = f"vqgan_{cfg['train_name']}"
    mgr = RollingCheckpointManager(str(Path(cfg["run_dir"]) / name),
                                   max_to_keep=int(cfg.get("ckpt_keep", 3)), best_k=1,
                                   metric_key="val_loss")
    start_epoch = 0
    if bool(cfg.get("resume", False)) and mgr.latest_step() is not None:
        trainer.load_state_dict(mgr.restore_latest(map_location=dev))
        start_epoch = trainer.step // max(len(train_loader), 1)
        log.info("resumed vqgan from step %d (epoch %d)", trainer.step, start_epoch)

    def as_videos(batch):
        v = torch.as_tensor(batch["videos"]).to(dev, torch.float32, non_blocking=True)
        return resize_video_time(resize_video(v, size), frames)

    mlog = MetricsLogger(cfg["run_dir"], name, cfg["use_wandb"], cfg)
    summary: Dict[str, Any] = {"trainer": trainer}
    try:
        for epoch in range(start_epoch, int(vq.get("epochs", 10))):
            train = []
            for batch in train_loader:
                train.append(trainer.train_step(as_videos(batch)))
                mlog.heartbeat()
            if train:  # epoch-mean logging, one host sync an epoch
                summary["train"] = {k: float(torch.stack([m[k] for m in train]).mean())
                                    for k in train[0]}
                mlog.log({f"train/{k}": v for k, v in summary["train"].items()},
                         step=trainer.step)
            vals = [trainer.eval_recon(as_videos(b)) for b in val_loader]
            metrics = None
            if vals:
                summary["val"] = {k: float(np.mean([float(v[k]) for v in vals]))
                                  for k in vals[0]}
                mlog.log(summary["val"], step=trainer.step)
                metrics = {"val_loss": summary["val"]["val/rec_l1"]}
            # the newest checkpoint every epoch (the whole trainer state, so
            # resume carries on); val only gates best/
            if mgr.latest_step() != trainer.step:
                mgr.save(trainer.step, trainer.state_dict(), metrics=metrics)
            log.info("epoch %d done (val rec_l1 %.4f)", epoch,
                     summary["val"]["val/rec_l1"] if vals else float("nan"))
    finally:
        mlog.close()
    return summary


def main(argv=None) -> Dict[str, Any]:
    cfg = config_from_argv(argv)
    logging.basicConfig(level=cfg.get("log_level", "INFO"))
    vq = dict(cfg.get("vqgan", {}))
    if bool(cfg.get("smoke", False)):
        vq.update(SMOKE_VQGAN)
        dataset = SyntheticVideos()
    else:
        dataset = CelebVTextDataset(videos_path=cfg["videos"]["preprocessed"])
    splits = split_indices(len(dataset), cfg["train_ratio"], cfg["seed"])
    return train_vqgan(cfg, vq, dataset, splits, cfg.get("device"))


if __name__ == "__main__":
    main()
