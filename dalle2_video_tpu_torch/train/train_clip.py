"""Stage 1: train the video-CLIP's ViViT tower against the frozen text tower
(counterpart of scripts/train_clip.py).

    python -m dalle2_video_tpu_torch.train.train_clip [configs/celebv_text.yaml] [key=value ...]
    python -m dalle2_video_tpu_torch.train.train_clip texts.tokenized=<npy> \
        videos.preprocessed=<store>
    python -m dalle2_video_tpu_torch.train.train_clip smoke=true device=cpu

The data are ``CelebVTextDataset(texts_path=texts.tokenized,
videos_path=videos.preprocessed)`` split by ``split_indices(len,
train_ratio, seed)`` (``smoke=true``: 16 synthetic clips and a tiny tower),
read by the loader ``loader`` chooses, at ``clip.batch_size``. The towers
come from ``clip_stage_generators(seed)`` (train/clip_trainer.py), the text
tower from ``clip.openai_ckpt`` when it is set. ``total_steps = len(train
loader) * clip.epochs`` places the schedule's milestones. Each epoch logs
the mean train metrics and the validation metrics and saves a checkpoint
under ``<run_dir>/clip_<train_name>`` (newest ``ckpt_keep``, best 1 by
``val_loss``); ``resume=true`` restarts from the newest. Runs on CUDA
unless ``device=cpu``.

``torch_vivit_ckpt=<video_encoder_{last,best}.pt>`` warm-starts the ViViT
from a reference torch checkpoint (``models/torch_import.py``), with fresh
optimiser state, as scripts/train_clip.py does; ``resume=true`` still
restores the newest checkpoint over it. A ``mesh`` over more than one
device raises (not ported yet).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from dalle2_video_tpu_torch.data.datasets import CelebVTextDataset, split_indices
from dalle2_video_tpu_torch.models.clip_text import CLIPTextConfig
from dalle2_video_tpu_torch.models.torch_import import load_vivit_torch_ckpt
from dalle2_video_tpu_torch.models.vivit import ViViTConfig
from dalle2_video_tpu_torch.train.checkpoint import RollingCheckpointManager
from dalle2_video_tpu_torch.train.clip_trainer import ClipTrainer, ClipTrainerConfig
from dalle2_video_tpu_torch.train.common import check_single_device, make_loaders
from dalle2_video_tpu_torch.utils.config import config_from_argv
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device
from dalle2_video_tpu_torch.utils.logging import MetricsLogger

log = logging.getLogger("dalle2_video_tpu_torch.train_clip")

SMOKE_VIVIT = {"frame_size": 32, "patch_size": 16, "num_frames": 25, "dim": 32, "depth": 1,
               "heads": 2, "dim_head": 8}
SMOKE_TEXT = CLIPTextConfig(vocab_size=1000, width=32, heads=2, layers=1, embed_dim=32)


class SyntheticClips:
    """scripts/train_clip.py's smoke corpus: 16 seeded (25, 32, 32, 3) videos
    and (16, 77) tokens."""

    def __init__(self, n: int = 16, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.videos = rng.rand(n, 25, 32, 32, 3).astype(np.float32)
        self.tokens = rng.randint(1, 1000, (n, 77)).astype(np.int32)

    def __len__(self) -> int:
        return len(self.videos)

    def batch_items(self, idx):
        return {"videos": self.videos[idx], "texts": self.tokens[idx]}


def vivit_config(cfg: Dict[str, Any]) -> ViViTConfig:
    ve = cfg["video_encoder"]
    return ViViTConfig(frame_size=ve["frame_size"], patch_size=ve["patch_size"],
                       num_frames=ve["num_frames"], dim=ve["dim"], depth=ve["depth"],
                       heads=ve["heads"], dim_head=ve["dim_head"],
                       dropout=float(ve.get("dropout", 0.0)),
                       emb_dropout=float(ve.get("emb_dropout", 0.0)))


def text_config(cfg: Dict[str, Any]) -> CLIPTextConfig:
    """The text tower's widths: CLIP ViT-B/32's, projecting to the ViViT's dim
    (the smoke run's tiny tower under ``smoke=true``)."""
    return SMOKE_TEXT if bool(cfg.get("smoke", False)) else CLIPTextConfig(
        embed_dim=cfg["video_encoder"]["dim"])


def refuse_unported(cfg: Dict[str, Any]) -> None:
    check_single_device(cfg)


def import_torch_vivit(cfg: Dict[str, Any], trainer: ClipTrainer) -> None:
    """``torch_vivit_ckpt``, when set: the reference ViViT checkpoint's
    weights into ``trainer.vivit`` (a missing file raises
    FileNotFoundError)."""
    path = cfg.get("torch_vivit_ckpt")
    if path:
        trainer.vivit.load_state_dict(load_vivit_torch_ckpt(str(path), trainer.vivit.cfg),
                                      strict=True)
        log.info("imported the reference torch ViViT checkpoint %s", path)


def smoke_setup(cfg: Dict[str, Any]):
    cfg = dict(cfg, video_encoder=dict(SMOKE_VIVIT),
               clip=dict(cfg["clip"], batch_size=4, epochs=2))
    return cfg, SyntheticClips()


def train_clip(cfg: Dict[str, Any], dataset, splits: Dict[str, np.ndarray],
               device: DeviceLike = None) -> Dict[str, Any]:
    """scripts/train_clip.py's loop on one device. Returns the trainer and
    the last epoch's mean train and val metrics."""
    refuse_unported(cfg)
    dev = resolve_device(device)
    cc = cfg["clip"]
    train_loader, val_loader = make_loaders(cfg, dataset, splits, dev,
                                            batch_size=cc["batch_size"])
    epochs = int(cc["epochs"])
    trainer = ClipTrainer(
        vivit_config(cfg), text_config(cfg),
        ClipTrainerConfig(lr=cc["lr"], lr_scheduler=cc["lr_scheduler"],
                          lr_multistep_milestones=tuple(cc["lr_multistep_milestones"]),
                          lr_step_gamma=cc["lr_step_gamma"],
                          total_steps=max(1, len(train_loader)) * epochs,
                          init_temperature=cc["init_temperature"]),
        seed=cfg["seed"], openai_ckpt=cc.get("openai_ckpt"), device=dev)
    import_torch_vivit(cfg, trainer)  # a warm start; the optimiser state stays fresh
    if not cc.get("openai_ckpt"):
        log.warning("no OpenAI CLIP ckpt given: the text tower is randomly initialized")

    name = f"clip_{cfg['train_name']}"
    mgr = RollingCheckpointManager(str(Path(cfg["run_dir"]) / name),
                                   max_to_keep=int(cfg.get("ckpt_keep", 3)), best_k=1,
                                   metric_key="val_loss")
    start_epoch = 0
    if bool(cfg.get("resume", False)) and mgr.latest_step() is not None:
        trainer.load_state_dict(mgr.restore_latest(map_location=dev))
        start_epoch = trainer.step // max(len(train_loader), 1)
        log.info("resumed clip from step %d (epoch %d)", trainer.step, start_epoch)
    mlog = MetricsLogger(cfg["run_dir"], name, cfg["use_wandb"], cfg)
    as_dev = lambda a: torch.as_tensor(a).to(dev, non_blocking=True)  # noqa: E731
    summary: Dict[str, Any] = {"trainer": trainer}
    try:
        for epoch in range(start_epoch, epochs):
            train = []
            for batch in train_loader:
                train.append(trainer.train_step(as_dev(batch["videos"]), as_dev(batch["texts"]),
                                                trainer.dropout_generator))
                mlog.heartbeat()
            if train:  # one host sync per epoch: the metrics stay on the device
                summary["train"] = {k: float(torch.stack([m[k] for m in train]).mean())
                                    for k in train[0]}
                mlog.log({f"train/{k}": v for k, v in summary["train"].items()},
                         step=trainer.step)
            val = [trainer.eval_step(as_dev(b["videos"]), as_dev(b["texts"]))
                   for b in val_loader]
            metrics = None
            if val:
                summary["val"] = {k: float(torch.stack([m[k] for m in val]).mean())
                                  for k in val[0]}
                mlog.log({f"val/{k}": v for k, v in summary["val"].items()}, step=trainer.step)
                metrics = {"val_loss": summary["val"]["loss"]}
            # the newest checkpoint every epoch; val only gates best/
            if mgr.latest_step() != trainer.step:
                mgr.save(trainer.step, trainer.state_dict(), metrics=metrics)
            log.info("epoch %d done", epoch)
    finally:
        mlog.close()
    return summary


def main(argv=None) -> Dict[str, Any]:
    cfg = config_from_argv(argv)
    logging.basicConfig(level=cfg.get("log_level", "INFO"))
    if bool(cfg.get("smoke", False)):
        cfg, dataset = smoke_setup(cfg)
    else:
        dataset = CelebVTextDataset(texts_path=cfg["texts"]["tokenized"],
                                    videos_path=cfg["videos"]["preprocessed"])
    splits = split_indices(len(dataset), cfg["train_ratio"], cfg["seed"])
    return train_clip(cfg, dataset, splits, cfg.get("device"))


if __name__ == "__main__":
    main()
