"""Decoder training (port of dalle2_video_tpu/train: trainer, EMA,
checkpoints). ``python -m dalle2_video_tpu_torch.train`` is the counterpart
of scripts/train_decoder.py (see ``__main__.py``)."""

from dalle2_video_tpu_torch.train.checkpoint import (
    PreemptionGuard,
    RollingCheckpointManager,
    has_checkpoint,
    load_checkpoint,
    load_latest,
    save_checkpoint,
)
from dalle2_video_tpu_torch.train.ema import EMAConfig, EMAState, ema_init, ema_update
from dalle2_video_tpu_torch.train.trainer import DecoderTrainer, DecoderTrainerConfig

__all__ = [
    "DecoderTrainer",
    "DecoderTrainerConfig",
    "EMAConfig",
    "EMAState",
    "PreemptionGuard",
    "RollingCheckpointManager",
    "ema_init",
    "ema_update",
    "has_checkpoint",
    "load_checkpoint",
    "load_latest",
    "save_checkpoint",
]
