from dalle2_video_tpu_torch.data.tokenizer import tokenize

__all__ = ["tokenize"]
