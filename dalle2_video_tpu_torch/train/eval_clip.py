"""The embeddings handoff: embed every clip and caption of the dataset with
the trained video-CLIP and write them for the prior and decoder stages
(counterpart of scripts/eval_clip.py).

    python -m dalle2_video_tpu_torch.train.eval_clip [configs/celebv_text.yaml] [key=value ...]

Builds the towers through ``clip_stage_generators(seed)``, the derivation
training used, so the frozen text tower is the one the ViViT was trained
against (``clip.openai_ckpt`` loads OpenAI weights into it instead), then
loads the ViViT from the *newest* checkpoint under ``<run_dir>/clip_
<train_name>`` (``eval_ckpt=best``: the best by val loss; none: the random
tower, with a warning). Every clip is embedded in order, the tail the
drop-remainder loader leaves included, and the (N, dim) f32 arrays are
written to ``videos.embed`` and ``texts.embed`` (.npy). Then the
video->text retrieval over all N pairs, similarity rows in chunks of 1,024,
is logged. ``torch_vivit_ckpt=<video_encoder_{last,best}.pt>`` embeds with a
reference torch ViViT checkpoint in place of the run's (as
scripts/eval_clip.py does). Runs on CUDA unless ``device=cpu``; a
multi-device ``mesh`` raises (not ported yet).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from dalle2_video_tpu_torch.data.datasets import BatchLoader, CelebVTextDataset
from dalle2_video_tpu_torch.train.checkpoint import has_checkpoint, load_best, load_latest
from dalle2_video_tpu_torch.train.clip_trainer import ClipTrainer
from dalle2_video_tpu_torch.train.train_clip import (
    import_torch_vivit,
    refuse_unported,
    text_config,
    vivit_config,
)
from dalle2_video_tpu_torch.utils.config import config_from_argv
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device

log = logging.getLogger("dalle2_video_tpu_torch.eval_clip")

CHUNK = 1024  # similarity rows per chunk of the full-dataset retrieval


def retrieval(video_embeds: np.ndarray, text_embeds: np.ndarray, chunk: int = CHUNK
              ) -> Dict[int, float]:
    """{k: share of clips whose caption ranks within k} for k = 1, 10 over
    all pairs; a rank counts ties against the pair."""
    v = video_embeds / np.linalg.norm(video_embeds, axis=-1, keepdims=True)
    t = text_embeds / np.linalg.norm(text_embeds, axis=-1, keepdims=True)
    n = len(v)
    hits = {1: 0, 10: 0}
    for s in range(0, n, chunk):
        sim = v[s:s + chunk] @ t.T
        own = sim[np.arange(sim.shape[0]), np.arange(s, min(s + chunk, n))]
        rank = (sim >= own[:, None]).sum(axis=1)
        for k in hits:
            hits[k] += int((rank <= k).sum())
    return {k: h / n for k, h in hits.items()}


def eval_clip(cfg: Dict[str, Any], dataset, device: DeviceLike = None) -> Dict[str, Any]:
    """Embed ``dataset`` (the CLIP stage's), write the two .npy files and
    return them with the trainer and the retrieval shares."""
    refuse_unported(cfg)
    dev = resolve_device(device)
    trainer = ClipTrainer(vivit_config(cfg), text_config(cfg), seed=cfg["seed"],
                          openai_ckpt=cfg["clip"].get("openai_ckpt"), device=dev)
    ckpt = Path(cfg["run_dir"]) / f"clip_{cfg['train_name']}"
    if has_checkpoint(str(ckpt)):
        which = str(cfg.get("eval_ckpt", "last"))
        trainer.load_state_dict((load_best if which == "best" else load_latest)(
            str(ckpt), map_location=dev))
        log.info("loaded %s (%s)", ckpt, which)
    else:
        log.warning("no checkpoint at %s: using the random encoder", ckpt)
    import_torch_vivit(cfg, trainer)

    def embed(batch):
        return (trainer.embed_video(torch.as_tensor(batch["videos"])).cpu().numpy(),
                trainer.embed_text(torch.as_tensor(batch["texts"])).cpu().numpy())

    out = [embed(b) for b in BatchLoader(dataset, cfg["clip"]["batch_size"], shuffle=False)]
    done = sum(len(v) for v, _ in out)
    if done < len(dataset):
        # the loader drops the remainder; this dump is the later stages'
        # dataset, so the tail is embedded too
        out.append(embed(dataset.batch_items(np.arange(done, len(dataset)))))
        log.info("embedded %d tail clips (drop-remainder loader)", len(dataset) - done)
    video_embeds = np.concatenate([v for v, _ in out]).astype(np.float32)
    text_embeds = np.concatenate([t for _, t in out]).astype(np.float32)
    for key, arr in (("videos", video_embeds), ("texts", text_embeds)):
        Path(cfg[key]["embed"]).parent.mkdir(parents=True, exist_ok=True)
        np.save(cfg[key]["embed"], arr)
    log.info("wrote %s %s and %s %s", cfg["videos"]["embed"], video_embeds.shape,
             cfg["texts"]["embed"], text_embeds.shape)
    hits = retrieval(video_embeds, text_embeds)
    log.info("retrieval over %d pairs: top1=%.4f top10=%.4f", len(video_embeds), hits[1],
             hits[10])
    return {"trainer": trainer, "video_embeds": video_embeds, "text_embeds": text_embeds,
            "top1": hits[1], "top10": hits[10]}


def main(argv=None) -> Dict[str, Any]:
    cfg = config_from_argv(argv)
    logging.basicConfig(level=cfg.get("log_level", "INFO"))
    dataset = CelebVTextDataset(texts_path=cfg["texts"]["tokenized"],
                                videos_path=cfg["videos"]["preprocessed"])
    return eval_clip(cfg, dataset, cfg.get("device"))


if __name__ == "__main__":
    main()
