"""Training (port of dalle2_video_tpu/train: the decoder trainer, the CLIP
trainer, EMA, checkpoints). ``python -m dalle2_video_tpu_torch.train`` is
the counterpart of scripts/train_decoder.py (see ``__main__.py``);
``python -m dalle2_video_tpu_torch.train.train_clip``, ``.eval_clip``,
``.train_prior`` and ``.distill`` those of scripts/train_clip.py,
eval_clip.py, train_prior.py and distill_decoder.py's phase loop."""

from dalle2_video_tpu_torch.train.checkpoint import (
    PreemptionGuard,
    RollingCheckpointManager,
    has_checkpoint,
    load_best,
    load_checkpoint,
    load_decoder_sampling_params,
    load_latest,
    load_params_subtree,
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
    "load_best",
    "load_checkpoint",
    "load_decoder_sampling_params",
    "load_latest",
    "load_params_subtree",
    "save_checkpoint",
]
