"""Train the cascaded video decoder (counterpart of scripts/train_decoder.py).

    python -m dalle2_video_tpu_torch.train [configs/celebv_text.yaml] [key=value ...]
    python -m dalle2_video_tpu_torch.train smoke=true        # synthetic-data run
    python -m dalle2_video_tpu_torch.train smoke=true device=cpu

Without a YAML path the built-in celebv_text settings are used. Both unets
are trained on every batch, then a validation pass; a rolling checkpoint
(newest K, best 1 by summed val loss, every ``ckpt_keep_period``-th step)
is written each epoch and ``resume=true`` restarts from the newest one.
SIGTERM saves a checkpoint and exits 143. ``max_steps`` (optional) stops
after that many batches. Runs on CUDA unless ``device=cpu``. The unets'
kernel knobs train through their backward kernels:
``unetN.attention_impl=auto`` (flash), ``unetN.groupnorm_impl=pallas`` or
``fused`` (conv + GroupNorm block kernels), ``unetN.spatial_conv_impl=
pallas_small`` (conv kernel forward, plain conv backward); training keeps
``unetN.cross_attention_impl=xla`` (that kernel is forward-only).

Not ported yet (they raise): the CelebV-Text dataset reader (the data files
are not in the repository; ``smoke=true`` trains on synthetic videos), and
a ``mesh`` over more than one device (data-parallel training). The
``loader`` key is ignored: batches come from the in-process ``BatchLoader``.
So is ``decoder_trainer.steps_per_scan``, the JAX loop's fusion of K steps
into one dispatch: here each batch is one step per unet, the same updates
in the same order for each unet.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from dalle2_video_tpu_torch.data.datasets import BatchLoader
from dalle2_video_tpu_torch.engine.decoder import build_decoder
from dalle2_video_tpu_torch.train.checkpoint import (
    PreemptionGuard,
    RollingCheckpointManager,
    has_checkpoint,
    load_latest,
)
from dalle2_video_tpu_torch.train.ema import EMAConfig
from dalle2_video_tpu_torch.train.trainer import DecoderTrainer, DecoderTrainerConfig
from dalle2_video_tpu_torch.utils.config import config_from_argv
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device
from dalle2_video_tpu_torch.utils.logging import MetricsLogger

log = logging.getLogger("dalle2_video_tpu_torch.train")


def build_trainer(cfg: Dict[str, Any], decoder) -> DecoderTrainer:
    tc = cfg["decoder_trainer"]
    return DecoderTrainer(decoder, DecoderTrainerConfig(
        lr=tc["lr"], wd=tc["wd"], use_ema=tc["use_ema"],
        ema=EMAConfig(beta=tc["ema_beta"], update_after_step=tc["ema_update_after_step"],
                      update_every=tc["ema_update_every"]),
        max_grad_norm=tc["max_grad_norm"],
        bf16_compute=cfg["decoder"].get("bf16_compute", True),
        grad_accum=tc.get("grad_accum", 1),
    ), seed=cfg["seed"])


class SyntheticVideos:
    """Seeded uniform videos and normal embeds, as scripts/train_decoder.py's
    smoke set: ``batch_items`` returns {"videos", "video_embeds"}."""

    def __init__(self, n: int, frames: int, size: int, embed_dim: int, channels: int = 3,
                 seed: int = 0):
        rng = np.random.RandomState(seed)
        self.videos = rng.rand(n, frames, size, size, channels).astype(np.float32)
        self.embeds = rng.randn(n, embed_dim).astype(np.float32)

    def __len__(self) -> int:
        return len(self.videos)

    def batch_items(self, idx):
        return {"videos": self.videos[idx], "video_embeds": self.embeds[idx]}


def smoke_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """scripts/train_decoder.py's smoke widths (2 frames, tiny unets)."""
    cfg = dict(cfg)
    cfg["frame_sizes"] = [16, 32]
    cfg["frame_numbers"] = [2, 2]
    cfg["unet1"] = {"dim": 16, "dim_mults": [1, 2], "num_resnet_blocks": 1,
                    "attn_heads": 2, "attn_dim_head": 8}
    cfg["unet2"] = {"dim": 8, "dim_mults": [1, 2], "num_resnet_blocks": 1,
                    "attn_heads": 2, "attn_dim_head": 8}
    cfg["decoder"] = dict(cfg["decoder"], batch_size=1, epochs=1)
    return cfg


def _check_single_device(cfg: Dict[str, Any]) -> None:
    mesh = cfg.get("mesh") or {}
    if mesh.get("data", -1) not in (-1, 1) or mesh.get("model", 1) != 1:
        raise NotImplementedError(
            f"mesh {mesh}: data-parallel / sharded training is not ported yet "
            "(one device only)")


def train_decoder(cfg: Dict[str, Any], dataset, splits: Dict[str, np.ndarray],
                  device: DeviceLike = None, max_steps: Optional[int] = None
                  ) -> Dict[str, Any]:
    """The training loop of scripts/train_decoder.py on one device. Returns
    the trainer and the last epoch's mean train / val losses per unet."""
    _check_single_device(cfg)
    dev = resolve_device(device)
    bs = cfg["decoder"]["batch_size"]
    train_loader = BatchLoader(dataset, bs, splits["train"], shuffle=True, seed=cfg["seed"])
    val_loader = BatchLoader(dataset, bs, splits["val"], shuffle=False)
    trainer = build_trainer(cfg, build_decoder(cfg, dev))

    name = f"decoder_{cfg['train_name']}"
    ckpt_dir = Path(cfg["run_dir"]) / name
    if bool(cfg.get("resume", False)) and has_checkpoint(str(ckpt_dir)):
        trainer.load_state_dict(load_latest(str(ckpt_dir), map_location=dev))
        log.info("resumed from %s at steps %s", ckpt_dir, trainer.steps)
    mgr = RollingCheckpointManager(
        str(ckpt_dir), max_to_keep=int(cfg.get("ckpt_keep", 3)), best_k=1,
        metric_key="val_loss",
        keep_period=int(cfg["ckpt_keep_period"]) if cfg.get("ckpt_keep_period") else None)
    mlog = MetricsLogger(cfg["run_dir"], name, cfg["use_wandb"], cfg)
    guard = PreemptionGuard()
    as_dev = lambda a: torch.as_tensor(a, device=dev)
    summary: Dict[str, Any] = {"trainer": trainer}
    batches = 0
    try:
        for epoch in range(cfg["decoder"]["epochs"]):
            train = {1: [], 2: []}
            for batch in train_loader:
                if guard.preempted or (max_steps is not None and batches >= max_steps):
                    break
                vid, emb = as_dev(batch["videos"]), as_dev(batch["video_embeds"])
                for u in (1, 2):  # both unets trained on every batch
                    train[u].append(trainer.train_step(vid, video_embed=emb, unet_number=u))
                batches += 1
                mlog.heartbeat()
            if guard.preempted:
                guard.emergency_save(mgr, trainer.steps[0], trainer.state_dict())
                raise SystemExit(PreemptionGuard.EXIT_CODE)
            if train[1]:
                # one host sync per epoch: the losses stay on the device
                summary["train_loss"] = {u: float(torch.stack(train[u]).mean()) for u in (1, 2)}
                mlog.log({f"train/loss_unet{u}": summary["train_loss"][u] for u in (1, 2)},
                         step=trainer.steps[0])
            val = {1: [], 2: []}
            for batch in val_loader:
                vid, emb = as_dev(batch["videos"]), as_dev(batch["video_embeds"])
                for u in (1, 2):
                    val[u].append(trainer.eval_loss(vid, video_embed=emb, unet_number=u))
            metrics = None
            if val[1]:
                summary["val_loss"] = {u: float(torch.stack(val[u]).mean()) for u in (1, 2)}
                mlog.log({f"val/loss_unet{u}": summary["val_loss"][u] for u in (1, 2)},
                         step=trainer.steps[0])
                # the summed val loss selects the best checkpoint
                metrics = {"val_loss": summary["val_loss"][1] + summary["val_loss"][2]}
            step = trainer.steps[0]
            if mgr.latest_step() != step:  # an epoch with no batch saves nothing new
                mgr.save(step, trainer.state_dict(), metrics=metrics)
            log.info("epoch %d done", epoch)
            if max_steps is not None and batches >= max_steps:
                break
    finally:
        guard.restore_handlers()
        mlog.close()
    return summary


def main(argv=None) -> None:
    cfg = config_from_argv(argv)
    logging.basicConfig(level=cfg.get("log_level", "INFO"))
    if bool(cfg.get("smoke", False)):
        cfg = smoke_config(cfg)
        bs = cfg["decoder"]["batch_size"]
        dataset = SyntheticVideos(2 * bs, cfg["frame_numbers"][-1], cfg["frame_sizes"][-1],
                                  cfg["dim"], cfg["channels"])
        splits = {"train": np.arange(bs), "val": np.arange(bs, 2 * bs)}
    else:
        raise NotImplementedError(
            "the CelebV-Text dataset reader is not ported yet (the data files are not "
            "in the repository); run with smoke=true for synthetic videos")
    max_steps = cfg.get("max_steps")
    train_decoder(cfg, dataset, splits, cfg.get("device"),
                  None if max_steps is None else int(max_steps))
    log.info("training complete")


if __name__ == "__main__":
    main()
