"""Remat-policy probe: the cascade's SR unet (``configs/cascade_sr.yaml``
with ``engine/decoder.py::cascade_sr_overrides``, batch 4, bf16 compute)
trained a few steps under each remat policy, with its time per step and
peak memory.

    python -m dalle2_video_tpu_torch.probes.remat_policies [--policies conv,nothing] [--steps 6]

Each policy gets a fresh trainer on the same synthetic batch. Times are the
host clock around a synchronised ``train_step``, as ``chip_smoke.py``'s
train phase: the first step (the allocator's warm-up) apart, the rest by
their median. One ``RESULT {json}`` line per policy, appended to
``runs/torch_remat_policies.jsonl``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import time

import numpy as np
import torch

from dalle2_video_tpu_torch.engine.decoder import build_decoder, cascade_sr_overrides
from dalle2_video_tpu_torch.models.remat import POLICIES
from dalle2_video_tpu_torch.probes import card_line
from dalle2_video_tpu_torch.train.__main__ import SyntheticVideos, build_trainer
from dalle2_video_tpu_torch.utils.config import load_config

BATCH = 4


def step_times(policy: str, steps: int, device):
    """ms of each SR-unet train step under ``policy``, and the peak GiB."""
    cfg = load_config("configs/cascade_sr.yaml", [
        *cascade_sr_overrides(), f"decoder.batch_size={BATCH}", "decoder.bf16_compute=true",
        f"unet2.remat_policy={policy}"])
    data = SyntheticVideos(BATCH, cfg["frame_numbers"][-1], cfg["frame_sizes"][-1], cfg["dim"],
                           cfg["channels"], seed=0)
    batch = data.batch_items(np.arange(BATCH))
    vid, emb = (torch.as_tensor(batch[k], device=device) for k in ("videos", "video_embeds"))
    trainer = build_trainer(cfg, build_decoder(cfg, device))
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.time()
        trainer.train_step(vid, video_embed=emb, unet_number=2)
        torch.cuda.synchronize()
        ms.append((time.time() - t) * 1e3)
    return ms, torch.cuda.max_memory_allocated() / 2**30


def main() -> None:
    ap = argparse.ArgumentParser(description="remat-policy probe (cascade SR unet)")
    ap.add_argument("--policies", default=",".join(POLICIES))
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    device = torch.device("cuda")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(device)} ({card})", flush=True)
    os.makedirs("runs", exist_ok=True)
    for policy in args.policies.split(","):
        ms, peak = step_times(policy, args.steps, device)
        rec = dict(name=f"remat_{policy}", policy=policy, first_ms=ms[0],
                   ms=statistics.median(ms[1:]), steps_ms=ms, peak_gib=peak, card=card)
        print("RESULT", json.dumps(rec), flush=True)
        with open("runs/torch_remat_policies.jsonl", "a") as f:
            f.write(json.dumps(rec) + "\n")
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
