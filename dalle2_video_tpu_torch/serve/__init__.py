"""Serving for text -> video generation on the GPU: the micro-batcher, the
bucketed generation engine and the HTTP JSON API (copies of the JAX
package's, which import no JAX), plus the PyTorch stack behind them
(``stack.py``) and the entry point ``python -m dalle2_video_tpu_torch.serve``.
"""

from dalle2_video_tpu_torch.serve.batcher import MicroBatcher
from dalle2_video_tpu_torch.serve.engine import GenerationEngine
from dalle2_video_tpu_torch.serve.server import make_server, serve_forever

__all__ = ["MicroBatcher", "GenerationEngine", "serve_forever", "make_server"]
