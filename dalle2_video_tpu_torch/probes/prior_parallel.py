"""Step walls of the prior's model axis over the launched ranks: the GPipe
pipeline and expert parallelism, beside the same prior on one rank.

    torchrun --nproc_per_node=4 -m dalle2_video_tpu_torch.probes.prior_parallel \\
        [--layouts pp,ep,dense1,moe1] [--steps 6] [--entry] [key=value ...]

The recipe's prior (configs/celebv_text.yaml: dim 512, depth 6, 8 x 64
heads, batch 256, f32) per layout:
  pp      ``pipeline_microbatches`` 4 over ``pipeline_stages`` 2, the other
          ranks data rows (each row the whole batch, as the entry point);
  ep      ``ff_experts`` 8 over ``expert_parallel`` = every rank;
  dense1  the dense prior on rank 0 alone (the others wait);
  moe1    the 8-expert prior on rank 0 alone.
Each takes ``--steps`` Adam steps (``train/train_prior.py::PriorTrainer``,
the mesh of ``setup_prior_mesh``) on seeded (256, 512) embeddings; the
walls are the host clock around each synchronised step, the first (the
allocator's and the collectives' warm-up) apart. Rank 0 prints one
``RESULT {json}`` line per layout: every rank's walls and its parameter and
Adam-moment bytes, the mesh, the backend, the card's name and power limit;
and appends it to ``runs/torch_prior_parallel.jsonl``. ``--entry`` then
runs the entry point (``train_prior.main``) for pp and ep on a seeded
handoff of 2,048 embeddings (4 steps an epoch), one epoch and a resume to
a second, and prints their walls. The trailing ``key=value`` overrides go
to the config (a CPU rehearsal: ``--device cpu prior.depth=2 ...``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import numpy as np
import torch
import torch.distributed as dist

from dalle2_video_tpu_torch.parallel.collectives import all_gather_list
from dalle2_video_tpu_torch.parallel.mesh import maybe_init_distributed, rank_device
from dalle2_video_tpu_torch.train import train_prior
from dalle2_video_tpu_torch.train.train_prior import build_prior_trainer, setup_prior_mesh
from dalle2_video_tpu_torch.utils.config import load_config
from dalle2_video_tpu_torch.utils.device import resolve_device

LAYOUTS = {"pp": ["prior.pipeline_microbatches=4", "prior.pipeline_stages=2"],
           "ep": ["prior.ff_experts=8"], "dense1": [], "moe1": ["prior.ff_experts=8"]}
ENTRY_ROWS = 2048


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_layout(name: str, args, overrides, dev):
    """Every rank's walls (ms) and bytes on one layout, gathered."""
    cfg = load_config(None, [*LAYOUTS[name], *overrides])
    alone = name.endswith("1")
    active = not alone or dist.get_rank() == 0
    walls, params_b, moments_b, mesh_shape = [], 0, 0, (1, 1)
    if not alone:
        _, mesh = setup_prior_mesh(cfg, dev)
        mesh_shape = (mesh.data, mesh.model)
        trainer = build_prior_trainer(cfg, dev, mesh.row())
    elif active:
        trainer = build_prior_trainer(cfg, dev)
    if active:
        g = torch.Generator(device=dev).manual_seed(2)
        b, d = int(cfg["prior"]["batch_size"]), int(cfg["dim"])
        ve, te = (torch.randn(b, d, generator=g, device=dev) for _ in range(2))
        for _ in range(args.steps):
            _sync(dev)
            t = time.time()
            trainer.train_step(ve, te)
            _sync(dev)
            walls.append((time.time() - t) * 1e3)
        params_b, moments_b = trainer.param_bytes()
        del trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    row = torch.tensor([float(active), float(params_b), float(moments_b), *walls,
                        *[0.0] * (args.steps - len(walls))], dtype=torch.float64, device=dev)
    dist.barrier()
    every = [t.cpu().tolist() for t in all_gather_list(row, dist.group.WORLD)]
    ranks = [{"walls_ms": r[3:], "param_bytes": int(r[1]), "moment_bytes": int(r[2])}
             for r in every if r[0]]
    return ranks, mesh_shape


def run_entry(name: str, overrides, dev, run_dir: str):
    """The entry point's walls for one layout: one epoch, then resume=true
    to a second (every rank; rank 0 wrote the handoff)."""
    args = [f"videos.embed={run_dir}/video.npy", f"texts.embed={run_dir}/text.npy",
            f"run_dir={run_dir}/{name}", "train_ratio=0.5", "log_level=WARNING",
            *([] if dev.type == "cuda" else ["device=cpu"]), *LAYOUTS[name], *overrides]
    walls = []
    for extra in (["prior.epochs=1"], ["prior.epochs=2", "resume=true"]):
        _sync(dev)
        t = time.time()
        s = train_prior.main(args + extra)
        _sync(dev)
        walls.append(time.time() - t)
    return {"entry_walls_s": walls, "steps": s["trainer"].step, "train_loss": s["train_loss"],
            "val_loss": s["val_loss"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layouts", default="pp,ep,dense1,moe1")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--entry", action="store_true", help="also run the entry point (pp, ep)")
    ap.add_argument("--device", default=None, help="cpu for a rehearsal (gloo)")
    args, overrides = ap.parse_known_args(argv)
    dev = resolve_device(rank_device(args.device))
    maybe_init_distributed(True, device=dev)
    backend = dist.get_backend()
    card = "cpu"
    if dev.type == "cuda":
        from dalle2_video_tpu_torch.probes import card_line

        card = card_line()
    lead = dist.get_rank() == 0
    records = []
    try:
        for name in args.layouts.split(","):
            ranks, (data, model) = run_layout(name, args, overrides, dev)
            records.append({"layout": name, "mesh": {"data": data, "model": model},
                            "backend": backend, "steady_ms_per_rank": [
                                sum(r["walls_ms"][1:]) / max(len(r["walls_ms"]) - 1, 1)
                                for r in ranks], "ranks": ranks})
        if args.entry:
            run_dir = os.path.abspath("runs/prior_parallel_entry")
            if lead:  # a fresh run directory: the first epoch resumes nothing
                shutil.rmtree(run_dir, ignore_errors=True)
                os.makedirs(run_dir)
                rng = np.random.default_rng(6)
                d = int(load_config(None, overrides)["dim"])
                for part in ("video", "text"):
                    np.save(f"{run_dir}/{part}.npy",
                            rng.standard_normal((ENTRY_ROWS, d)).astype(np.float32))
            dist.barrier()
            for name in ("pp", "ep"):
                records.append({"layout": f"entry {name}", "backend": backend,
                                **run_entry(name, overrides, dev, run_dir)})
        if lead:
            os.makedirs("runs", exist_ok=True)
            for rec in records:
                rec.update(card=card, cards=torch.cuda.device_count() if dev.type == "cuda"
                           else 0, world=dist.get_world_size(), overrides=overrides)
                line = json.dumps(rec)
                print("RESULT " + line, flush=True)
                with open("runs/torch_prior_parallel.jsonl", "a") as f:
                    f.write(line + "\n")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
