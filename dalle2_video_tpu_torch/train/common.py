"""What the training entry points share: the single-device check and the
train / val loaders (the decoder's ``python -m dalle2_video_tpu_torch.train``,
``train.train_clip`` and ``train.train_prior``), and the resumable
``results.json`` of the scoring scripts (``train.distill``,
``train.eval_quality``, ``train.demo_inpaint``)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dalle2_video_tpu_torch.data.datasets import BatchLoader
from dalle2_video_tpu_torch.data.worker_loader import make_worker_loader


def check_single_device(cfg: Dict[str, Any]) -> None:
    """Refuse a ``mesh`` over more than one device: the CLIP, prior, VQGAN
    and distill entry points train on one (as their JAX scripts build no
    data mesh); the decoder's entry point takes one."""
    mesh = cfg.get("mesh") or {}
    if mesh.get("data", -1) not in (-1, 1) or mesh.get("model", 1) != 1:
        raise NotImplementedError(
            f"mesh {mesh}: this entry point trains on one device (only the decoder's, "
            "python -m dalle2_video_tpu_torch.train, takes a mesh)")


def make_loaders(cfg: Dict[str, Any], dataset, splits: Dict[str, np.ndarray], dev,
                 batch_size: Optional[int] = None, shard_index: int = 0,
                 num_shards: int = 1):
    """The train (shuffled, seed + epoch) and val loaders at ``batch_size``
    rows a batch (the decoder's by default), this rank's shard of each
    epoch (``shard_index`` of ``num_shards``): worker processes under
    ``loader: grain`` (pinned memory on CUDA), else the thread loader; the
    smoke run's synthetic set always takes the thread loader."""
    bs = cfg["decoder"]["batch_size"] if batch_size is None else batch_size
    shard = dict(shard_index=shard_index, num_shards=num_shards)
    if str(cfg.get("loader", "thread")) == "grain" and not bool(cfg.get("smoke", False)):
        kw = dict(worker_count=int(cfg.get("loader_workers", 4)),
                  pin_memory=torch.device(dev).type == "cuda", **shard)
        return (make_worker_loader(dataset, bs, splits["train"], shuffle=True,
                                   seed=cfg["seed"], **kw),
                make_worker_loader(dataset, bs, splits["val"], shuffle=False, **kw))
    return (BatchLoader(dataset, bs, splits["train"], shuffle=True, seed=cfg["seed"], **shard),
            BatchLoader(dataset, bs, splits["val"], shuffle=False, **shard))


def results_file(out: Path, fresh: Optional[Dict[str, Any]] = None
                 ) -> Tuple[Dict[str, Any], Callable[[], None]]:
    """``<out>/results.json``'s results (empty where there is none) with
    ``fresh`` merged over them, and the flush that writes them back: a
    rerun keeps what an earlier run scored."""
    path = Path(out) / "results.json"
    results = json.loads(path.read_text()) if path.exists() else {}
    results.update(fresh or {})

    def flush():
        path.write_text(json.dumps(results, indent=1))

    return results, flush
