from dalle2_video_tpu_torch.engine.dalle2video import DALLE2Video
from dalle2_video_tpu_torch.engine.decoder import VideoDecoder, VideoDecoderConfig

__all__ = ["DALLE2Video", "VideoDecoder", "VideoDecoderConfig"]
