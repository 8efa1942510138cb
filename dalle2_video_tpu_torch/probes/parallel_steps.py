"""Step walls of the data and model axes over the launched ranks.

    torchrun --nproc_per_node=4 -m dalle2_video_tpu_torch.probes.parallel_steps \\
        [--meshes 4x1,2x2,1x1] [--steps 4] [--rows 1] [key=value ...]

For each mesh (data x model; the ranks beyond it wait) the train recipe's
unet 1 (the celebv_text settings at ``frame_numbers [90, 90]``, bf16
compute, ``cross_attention_impl: xla``, ``groupnorm_impl: pallas``;
``attention_impl: sp`` where the mesh has a model axis, else ``auto``)
takes ``--steps`` sharded train steps (``parallel/sharded.py``, ZeRO-1) at
``--rows`` rows a data rank on seeded synthetic videos. The walls are the
host clock around each synchronised step, the first (the allocator's and
the collectives' warm-up) apart. Rank 0 prints one ``RESULT {json}`` line
per mesh: every rank's walls, the loss, each rank's Adam-moment bytes, the
backend and the card's name and power limit, and appends it to
``runs/torch_parallel_steps.jsonl``. The trailing ``key=value`` overrides
go to the config (a tiny CPU rehearsal: ``--device cpu frame_numbers=[2,2]
...``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from dalle2_video_tpu_torch.engine.decoder import build_decoder
from dalle2_video_tpu_torch.models.layers import kernel_init_
from dalle2_video_tpu_torch.parallel.collectives import all_gather_list
from dalle2_video_tpu_torch.parallel.mesh import (
    Mesh,
    maybe_init_distributed,
    rank_device,
    shard_batch,
)
from dalle2_video_tpu_torch.parallel.sharded import make_sharded_train_step, shard_state
from dalle2_video_tpu_torch.train.__main__ import SyntheticVideos, build_trainer
from dalle2_video_tpu_torch.utils.config import load_config
from dalle2_video_tpu_torch.utils.device import resolve_device

RECIPE = ["frame_numbers=[90,90]", "decoder.bf16_compute=true",
          *(f"unet{u}.{k}" for u in (1, 2) for k in ("cross_attention_impl=xla",
                                                      "groupnorm_impl=pallas"))]


def sub_mesh(data: int, model: int, dev, backend) -> Mesh:
    """The (data, model) mesh over the first data * model ranks (every rank
    creates its groups; the others get a mesh they do not use)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n = data * model
    if n > world:
        raise ValueError(f"mesh {data}x{model} needs {n} ranks, {world} launched")
    rows = [[i * model + j for j in range(model)] for i in range(data)]
    cols = [[i * model + j for i in range(data)] for j in range(model)]
    mine = {}
    for name, sets in (("model", rows), ("data", cols), ("world", [list(range(n))])):
        for ranks in sets:
            g = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                mine[name] = g
    return Mesh(data, model, rank if rank < n else 0, dev, backend,
                data_group=mine.get("data"), model_group=mine.get("model"),
                world_group=mine.get("world"))


def run_mesh(data: int, model: int, args, overrides, dev, backend):
    """Every rank's walls (ms) and moment bytes on one mesh, gathered."""
    impl = "sp" if model > 1 else "auto"
    cfg = load_config(None, [*RECIPE, f"unet1.attention_impl={impl}", *overrides])
    mesh = sub_mesh(data, model, dev, backend)
    active = dist.get_rank() < data * model
    walls, loss, moments = [], float("nan"), 0
    if active:
        torch.manual_seed(0)
        trainer = build_trainer(cfg, build_decoder(cfg, dev))
        w = trainer.decoder.unets[0].to_out.Conv_0.weight  # redrawn: a zero
        kernel_init_(w, w[0].numel())  # output conv leaves most gradients ~0
        shard_state(trainer, mesh)
        step = make_sharded_train_step(trainer, mesh, 1)
        data_set = SyntheticVideos(data * args.rows, cfg["frame_numbers"][-1],
                                   cfg["frame_sizes"][-1], cfg["dim"], cfg["channels"])
        vid, emb = shard_batch(mesh, (torch.from_numpy(data_set.videos),
                                      torch.from_numpy(data_set.embeds)))
        for _ in range(args.steps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t = time.time()
            loss = float(step(vid, emb))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            walls.append((time.time() - t) * 1e3)
        moments = sum(v.numel() * v.element_size()
                      for st in trainer.optimizers[0].state.values()
                      for k, v in st.items() if torch.is_tensor(v) and k != "step")
        del trainer, step, vid, emb
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    row = torch.tensor([float(active), loss, float(moments), *walls,
                        *[0.0] * (args.steps - len(walls))], dtype=torch.float64, device=dev)
    dist.barrier()
    every = [t.cpu().tolist() for t in all_gather_list(row, dist.group.WORLD)]
    return [{"walls_ms": r[3:], "loss": r[1], "moment_bytes": int(r[2])}
            for r in every if r[0]]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--meshes", default="4x1,2x2,1x1")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--rows", type=int, default=1, help="rows a data rank takes a step")
    ap.add_argument("--device", default=None, help="cpu for a rehearsal (gloo)")
    args, overrides = ap.parse_known_args(argv)
    dev = resolve_device(rank_device(args.device))
    maybe_init_distributed(True, device=dev)
    backend = dist.get_backend()
    card = "cpu"
    if dev.type == "cuda":
        from dalle2_video_tpu_torch.probes import card_line

        card = card_line()
    try:
        for spec in args.meshes.split(","):
            data, model = (int(x) for x in spec.split("x"))
            ranks = run_mesh(data, model, args, overrides, dev, backend)
            if dist.get_rank() == 0:
                steady = [sum(r["walls_ms"][1:]) / max(len(r["walls_ms"]) - 1, 1) for r in ranks]
                rec = {"mesh": {"data": data, "model": model}, "backend": backend,
                       "rows_per_data_rank": args.rows, "global_batch": data * args.rows,
                       "steady_ms_per_rank": steady, "ranks": ranks, "card": card,
                       "cards": torch.cuda.device_count() if dev.type == "cuda" else 0,
                       "overrides": overrides}
                line = json.dumps(rec)
                print("RESULT " + line, flush=True)
                os.makedirs("runs", exist_ok=True)
                with open("runs/torch_parallel_steps.jsonl", "a") as f:
                    f.write(line + "\n")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
