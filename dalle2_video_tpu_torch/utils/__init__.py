from dalle2_video_tpu_torch.utils.config import (
    CELEBV_TEXT,
    apply_overrides,
    config_from_argv,
    load_config,
)
from dalle2_video_tpu_torch.utils.contrastive import l2_normalize
from dalle2_video_tpu_torch.utils.device import resolve_device
from dalle2_video_tpu_torch.utils.keys import RowKeys

__all__ = [
    "CELEBV_TEXT",
    "apply_overrides",
    "config_from_argv",
    "load_config",
    "l2_normalize",
    "resolve_device",
    "RowKeys",
]
