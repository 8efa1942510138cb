"""Train the cascaded video decoder (counterpart of scripts/train_decoder.py).

    python -m dalle2_video_tpu_torch.train [configs/celebv_text.yaml] [key=value ...]
    python -m dalle2_video_tpu_torch.train videos.preprocessed=<store> videos.embed=<npy>
    python -m dalle2_video_tpu_torch.train smoke=true        # synthetic-data run
    python -m dalle2_video_tpu_torch.train smoke=true device=cpu
    torchrun --nproc_per_node=4 -m dalle2_video_tpu_torch.train [...] mesh.data=-1

Without a YAML path the built-in celebv_text settings are used. The data
are ``CelebVTextDataset(video_embeds_path=videos.embed,
videos_path=videos.preprocessed)`` (an h5 or ``.vshard`` store written by
``python -m dalle2_video_tpu_torch.data.preprocess``) split by
``split_indices(len, train_ratio, seed)``; ``smoke=true`` trains on
synthetic videos instead. ``loader: grain`` reads batches in
``loader_workers`` worker processes (``data/worker_loader.py``; pinned
host memory on CUDA), ``loader: thread`` in one background thread
(``BatchLoader``); both give the same batches, reshuffled with seed +
epoch. Batches reach the device with non-blocking copies.

Both unets are trained on every batch, then a validation pass; a rolling
checkpoint (newest K, best 1 by summed val loss, every
``ckpt_keep_period``-th step) is written each epoch and ``resume=true``
restarts from the newest one. SIGTERM saves a checkpoint and exits 143.
``max_steps`` (optional) stops after that many batches. Runs on CUDA unless
``device=cpu``. The unets' kernel knobs train through their backward
kernels: ``unetN.attention_impl=auto`` (flash), ``unetN.groupnorm_impl=
pallas`` or ``fused`` (conv + GroupNorm block kernels),
``unetN.spatial_conv_impl=pallas_small`` (conv kernel forward, plain conv
backward); training keeps ``unetN.cross_attention_impl=xla`` (that kernel
is forward-only).

Under torchrun (or ``multihost=true``) each process joins the process
group (NCCL on CUDA, gloo on the CPU) and trains on ``cuda:LOCAL_RANK`` (or ``device``) over the ``mesh`` (``data:
-1`` = every launched rank / model; a mesh that differs from the launched
world raises): each rank reads its shard of the loaders at ``batch_size /
data`` rows, the step is ``parallel/sharded.py``'s (gradients averaged over
``data``, Adam moments ZeRO-1 sharded), and rank 0 alone writes the
checkpoints (in the single-device format: they restore at any world size)
and the metrics. ``smoke=true`` sizes its batch to the data axis, as the
JAX script's ``bs = n_dev``. ``decoder_trainer.steps_per_scan``, the JAX
loop's fusion of K steps into one dispatch, is ignored: here each batch is
one step per unet, the same updates in the same order for each unet.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dalle2_video_tpu_torch.data.datasets import CelebVTextDataset, split_indices
from dalle2_video_tpu_torch.engine.decoder import build_decoder
from dalle2_video_tpu_torch.train.checkpoint import (
    PreemptionGuard,
    RollingCheckpointManager,
    has_checkpoint,
    load_latest,
)
from dalle2_video_tpu_torch.parallel.collectives import all_reduce_
from dalle2_video_tpu_torch.parallel.mesh import (
    Mesh,
    active_mesh,
    create_mesh,
    launched_world,
    maybe_init_distributed,
    rank_device,
    resolve_mesh_shape,
    shard_with,
)
from dalle2_video_tpu_torch.parallel.sharded import (
    all_reduce_mean,
    make_sharded_train_step,
    shard_state,
)
from dalle2_video_tpu_torch.train.common import make_loaders
from dalle2_video_tpu_torch.train.ema import EMAConfig
from dalle2_video_tpu_torch.train.trainer import DecoderTrainer, DecoderTrainerConfig
from dalle2_video_tpu_torch.utils.config import config_from_argv
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device
from dalle2_video_tpu_torch.utils.logging import MetricsLogger

log = logging.getLogger("dalle2_video_tpu_torch.train")


def build_trainer(cfg: Dict[str, Any], decoder) -> DecoderTrainer:
    tc = cfg["decoder_trainer"]
    return DecoderTrainer(decoder, DecoderTrainerConfig(
        lr=tc["lr"], wd=tc["wd"], use_ema=tc["use_ema"],
        ema=EMAConfig(beta=tc["ema_beta"], update_after_step=tc["ema_update_after_step"],
                      update_every=tc["ema_update_every"]),
        max_grad_norm=tc["max_grad_norm"],
        bf16_compute=cfg["decoder"].get("bf16_compute", True),
        grad_accum=tc.get("grad_accum", 1),
    ), seed=cfg["seed"])


class SyntheticVideos:
    """Seeded uniform videos and normal embeds, as scripts/train_decoder.py's
    smoke set: ``batch_items`` returns {"videos", "video_embeds"}."""

    def __init__(self, n: int, frames: int, size: int, embed_dim: int, channels: int = 3,
                 seed: int = 0):
        rng = np.random.RandomState(seed)
        self.videos = rng.rand(n, frames, size, size, channels).astype(np.float32)
        self.embeds = rng.randn(n, embed_dim).astype(np.float32)

    def __len__(self) -> int:
        return len(self.videos)

    def batch_items(self, idx):
        return {"videos": self.videos[idx], "video_embeds": self.embeds[idx]}


def smoke_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """scripts/train_decoder.py's smoke widths (2 frames, tiny unets)."""
    cfg = dict(cfg)
    cfg["frame_sizes"] = [16, 32]
    cfg["frame_numbers"] = [2, 2]
    cfg["unet1"] = {"dim": 16, "dim_mults": [1, 2], "num_resnet_blocks": 1,
                    "attn_heads": 2, "attn_dim_head": 8}
    cfg["unet2"] = {"dim": 8, "dim_mults": [1, 2], "num_resnet_blocks": 1,
                    "attn_heads": 2, "attn_dim_head": 8}
    cfg["decoder"] = dict(cfg["decoder"], batch_size=1, epochs=1)
    return cfg


def store_dataset(cfg: Dict[str, Any]):
    """The decoder-stage CelebVTextDataset of ``videos.preprocessed`` /
    ``videos.embed`` and its seeded train / val split."""
    dataset = CelebVTextDataset(video_embeds_path=cfg["videos"]["embed"],
                                videos_path=cfg["videos"]["preprocessed"])
    return dataset, split_indices(len(dataset), cfg["train_ratio"], cfg["seed"])


def setup_mesh(cfg: Dict[str, Any], device: DeviceLike = None) -> Tuple[torch.device, Mesh]:
    """This process's device and the mesh over the launched ranks. Under
    torchrun (its WORLD_SIZE in the environment) or ``multihost=true`` the
    process group is joined first: NCCL on CUDA, gloo on the CPU; a rank's device is ``cuda:LOCAL_RANK`` unless
    ``device`` names one. ``mesh`` must cover exactly the launched ranks."""
    distributed = bool(cfg.get("multihost", False)) or "WORLD_SIZE" in os.environ
    dev = resolve_device(rank_device(device) if distributed else device)
    maybe_init_distributed(distributed, device=dev)
    world = dist.get_world_size() if dist.is_initialized() else 1
    data, model = resolve_mesh_shape(cfg.get("mesh"), world)
    return dev, create_mesh(data, model, device=dev)


def _any_rank(flag: bool, mesh: Mesh) -> bool:
    """Whether any rank raised ``flag`` (all stop at one batch)."""
    if mesh.world_group is None:
        return flag
    t = torch.tensor([float(flag)], device=mesh.device)
    return bool(all_reduce_(t, mesh.world_group).item() > 0)


def train_decoder(cfg: Dict[str, Any], dataset, splits: Dict[str, np.ndarray],
                  device: DeviceLike = None, max_steps: Optional[int] = None
                  ) -> Dict[str, Any]:
    """The training loop of scripts/train_decoder.py over the mesh
    (``setup_mesh``: one device without torchrun). Returns the trainer, the
    mesh and the last epoch's mean train / val losses per unet (the global
    batch's, on every rank)."""
    dev, mesh = setup_mesh(cfg, device)
    bs = cfg["decoder"]["batch_size"]
    if bs % mesh.data:
        raise ValueError(f"batch_size {bs} is not a multiple of the data axis ({mesh.data})")
    train_loader, val_loader = make_loaders(cfg, dataset, splits, dev, bs // mesh.data,
                                            mesh.data_index, mesh.data)
    trainer = build_trainer(cfg, build_decoder(cfg, dev))
    lead = mesh.rank == 0

    name = f"decoder_{cfg['train_name']}"
    ckpt_dir = Path(cfg["run_dir"]) / name
    if bool(cfg.get("resume", False)) and has_checkpoint(str(ckpt_dir)):
        trainer.load_state_dict(load_latest(str(ckpt_dir), map_location=dev))
        log.info("resumed from %s at steps %s", ckpt_dir, trainer.steps)
    shard_state(trainer, mesh)
    steps = {u: make_sharded_train_step(trainer, mesh, u) for u in (1, 2)}
    log.info("mesh data=%d model=%d (rank %d of %d, %s, process group backend %s), "
             "%d rows a batch per rank", mesh.data, mesh.model, mesh.rank, mesh.world, dev,
             dist.get_backend() if dist.is_initialized() else "none", bs // mesh.data)
    mgr = RollingCheckpointManager(
        str(ckpt_dir), max_to_keep=int(cfg.get("ckpt_keep", 3)), best_k=1,
        metric_key="val_loss",
        keep_period=int(cfg["ckpt_keep_period"]) if cfg.get("ckpt_keep_period") else None)
    mlog = MetricsLogger(cfg["run_dir"], name, cfg["use_wandb"], cfg) if lead else None
    guard = PreemptionGuard()
    summary: Dict[str, Any] = {"trainer": trainer, "mesh": mesh}
    batches = 0

    def save(step, metrics=None):
        state = trainer.state_dict()  # every rank: the moments are gathered
        if lead:
            mgr.save(step, state, metrics=metrics)

    try:
        for epoch in range(cfg["decoder"]["epochs"]):
            train = {1: [], 2: []}
            for batch in train_loader:
                if _any_rank(guard.preempted, mesh) or (
                        max_steps is not None and batches >= max_steps):
                    break
                vid, emb = shard_with(mesh, (batch["videos"], batch["video_embeds"]))
                for u in (1, 2):  # both unets trained on every batch
                    train[u].append(steps[u](vid, emb))
                batches += 1
                if lead:
                    mlog.heartbeat()
            if _any_rank(guard.preempted, mesh):
                state = trainer.state_dict()  # every rank: the moments are gathered
                if lead:
                    guard.emergency_save(mgr, trainer.steps[0], state)
                raise SystemExit(PreemptionGuard.EXIT_CODE)
            if train[1]:
                # one host sync per epoch: the losses stay on the device
                summary["train_loss"] = {u: float(torch.stack(train[u]).mean()) for u in (1, 2)}
                if lead:
                    mlog.log({f"train/loss_unet{u}": summary["train_loss"][u] for u in (1, 2)},
                             step=trainer.steps[0])
            val = {1: [], 2: []}
            for batch in val_loader:
                vid, emb = shard_with(mesh, (batch["videos"], batch["video_embeds"]))
                with active_mesh(mesh):  # the global batch's draws, this rank's rows
                    for u in (1, 2):
                        val[u].append(all_reduce_mean(
                            trainer.eval_loss(vid, video_embed=emb, unet_number=u),
                            mesh.data_group))
            metrics = None
            if val[1]:
                summary["val_loss"] = {u: float(torch.stack(val[u]).mean()) for u in (1, 2)}
                if lead:
                    mlog.log({f"val/loss_unet{u}": summary["val_loss"][u] for u in (1, 2)},
                             step=trainer.steps[0])
                # the summed val loss selects the best checkpoint
                metrics = {"val_loss": summary["val_loss"][1] + summary["val_loss"][2]}
            step = trainer.steps[0]
            if mgr.latest_step() != step:  # an epoch with no batch saves nothing new
                save(step, metrics)
            log.info("epoch %d done", epoch)
            if max_steps is not None and batches >= max_steps:
                break
    finally:
        guard.restore_handlers()
        if lead:
            mlog.close()
    return summary


def main(argv=None) -> None:
    cfg = config_from_argv(argv)
    logging.basicConfig(level=cfg.get("log_level", "INFO"))
    if bool(cfg.get("smoke", False)):
        cfg = smoke_config(cfg)
        # one row per rank of the data axis (the JAX script's bs = n_dev)
        bs = resolve_mesh_shape(cfg.get("mesh"), launched_world())[0]
        cfg["decoder"]["batch_size"] = bs
        dataset = SyntheticVideos(2 * bs, cfg["frame_numbers"][-1], cfg["frame_sizes"][-1],
                                  cfg["dim"], cfg["channels"])
        splits = {"train": np.arange(bs), "val": np.arange(bs, 2 * bs)}
    else:
        dataset, splits = store_dataset(cfg)
    max_steps = cfg.get("max_steps")
    try:
        train_decoder(cfg, dataset, splits, cfg.get("device"),
                      None if max_steps is None else int(max_steps))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    log.info("training complete")


if __name__ == "__main__":
    main()
