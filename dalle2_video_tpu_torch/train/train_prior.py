"""Stage 2: train the diffusion prior (text embed -> video embed) on the
embeddings handoff (counterpart of scripts/train_prior.py).

    python -m dalle2_video_tpu_torch.train.train_prior [configs/celebv_text.yaml] [key=value ...]
    python -m dalle2_video_tpu_torch.train.train_prior texts.embed=<npy> videos.embed=<npy>

The data are the prior stage of ``CelebVTextDataset(text_embeds_path=
texts.embed, video_embeds_path=videos.embed)`` (what ``train.eval_clip``
writes), split by ``split_indices(len, train_ratio, seed)`` and batched at
``prior.batch_size`` by the thread loader. ``PriorTrainer`` takes Adam
steps at ``prior.lr`` (optax ``adam``'s defaults) on ``DiffusionPrior.
loss``, with an opt-in EMA shadow (``prior.use_ema``, ``ema_beta`` 0.99,
``ema_update_after_step`` 100, ``ema_update_every`` 10). The network's
weights come from one stream of ``seed``, the loss's draws from another.
Each epoch logs the mean train loss and the val loss and saves the full
state ``{params, opt_state[, ema]}`` under ``<run_dir>/prior_<train_name>``
(newest ``ckpt_keep``, best 1 by ``val_loss``); ``resume=true`` restarts
from the newest. Serving reads the params out of it (EMA preferred,
``train/checkpoint.py::load_params_subtree``). Runs on CUDA unless
``device=cpu``. The network's options come from ``models/prior.py::
prior_from_config`` (the stacked layout ``scan_layers``, the experts
``ff_experts`` / ``moe_capacity_factor`` / ``moe_aux_weight``). What needs
more than one device raises: a multi-device ``mesh``, expert parallelism
(``prior.expert_parallel`` > 1) and the pipeline (``pipeline_microbatches``).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dalle2_video_tpu_torch.data.datasets import BatchLoader, CelebVTextDataset, split_indices
from dalle2_video_tpu_torch.models.prior import DiffusionPrior, prior_from_config
from dalle2_video_tpu_torch.parallel.mesh import (
    Mesh,
    active_mesh,
    create_mesh,
    maybe_init_distributed,
    rank_device,
)
from dalle2_video_tpu_torch.parallel.sharded import gather_whole, local_block, whole_shape
from dalle2_video_tpu_torch.train.checkpoint import RollingCheckpointManager
from dalle2_video_tpu_torch.train.common import check_single_device
from dalle2_video_tpu_torch.train.ema import EMAConfig, ema_init, ema_update
from dalle2_video_tpu_torch.utils.config import config_from_argv
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device
from dalle2_video_tpu_torch.utils.keys import derive_generator, init_from
from dalle2_video_tpu_torch.utils.logging import MetricsLogger

log = logging.getLogger("dalle2_video_tpu_torch.train_prior")

_PRIOR_STAGE = 4  # the key path's tag for the prior stage


class PriorTrainer:
    """Adam (and an optional EMA shadow) over ``prior.network``'s params;
    ``generator`` (on the prior's device) feeds the loss's draws. On a
    placed prior (``prior.mesh``, ``prior.specs``) the moments and the
    shadow are of this rank's blocks, the steps run under the prior's mesh,
    and the state dicts are the single-device format (gathered on save,
    cut to this rank's blocks on load)."""

    def __init__(self, prior: DiffusionPrior, lr: float, *, use_ema: bool = False,
                 ema: EMAConfig = EMAConfig(update_after_step=100),
                 generator: Optional[torch.Generator] = None):
        self.prior = prior
        net = prior.network
        self.optimizer = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.ema_cfg = ema
        self.ema = ema_init(dict(net.named_parameters())) if use_ema else None
        self.generator = generator if generator is not None else torch.Generator(
            device=prior.device)
        self.step = 0
        self.mesh, self.specs = prior.mesh, prior.specs

    def whole_shape(self, name: str, t: torch.Tensor) -> Tuple[int, ...]:
        """The single-device shape of parameter ``name`` (``t`` its block)."""
        return whole_shape(t, self.specs.get(name, ()), self.mesh) if self.specs else t.shape

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a single-device tensor of parameter ``name``."""
        return local_block(t, self.specs[name], self.mesh).clone() if self.specs.get(name) else t

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The single-device tensor of parameter ``name`` from every rank's
        block ``t`` (collective for a split parameter)."""
        return gather_whole(t, self.specs[name], self.mesh) if self.specs.get(name) else t

    def param_bytes(self) -> Tuple[int, int]:
        """Bytes of parameters and of Adam moments this rank holds."""
        params = sum(p.numel() * p.element_size() for p in self.prior.network.parameters())
        moments = sum(v.numel() * v.element_size() for st in self.optimizer.state.values()
                      for k, v in st.items() if torch.is_tensor(v) and k != "step")
        return params, moments

    def train_step(self, video_embed: torch.Tensor, text_embed: torch.Tensor,
                   draws: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """One Adam update (then the EMA's); returns the loss (0-dim, on the
        device)."""
        net = self.prior.network.train()
        self.optimizer.zero_grad(set_to_none=True)
        with active_mesh(self.mesh):
            loss = self.prior.loss(video_embed, text_embed, generator=self.generator,
                                   draws=draws)
            loss.backward()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.ema is not None:
            ema_update(self.ema, dict(net.named_parameters()), self.ema_cfg)
        self.step += 1
        return loss.detach()

    @torch.no_grad()
    def eval_loss(self, video_embed: torch.Tensor, text_embed: torch.Tensor,
                  draws: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        with active_mesh(self.mesh):
            return self.prior.loss(video_embed, text_embed, generator=self.generator,
                                   draws=draws)

    def _moments(self, opt_state, fn) -> Dict[str, Any]:
        """An optimiser state dict with ``fn(name, moment)`` applied to each
        moment of a split parameter."""
        if not self.specs:
            return opt_state
        names = [k for k, _ in self.prior.network.named_parameters()]
        return {"state": {i: {k: (fn(names[int(i)], v) if torch.is_tensor(v) and k != "step"
                                  else v) for k, v in st.items()}
                          for i, st in opt_state["state"].items()},
                "param_groups": opt_state["param_groups"]}

    def state_dict(self) -> Dict[str, Any]:
        """``{params, opt_state[, ema]}`` as the JAX prior's checkpoint, with
        the step and the draw generator's state, in the single-device format
        (a placed trainer gathers every rank's blocks: call it on every
        rank)."""
        state = {"params": {k: self.whole(k, v)
                            for k, v in self.prior.network.state_dict().items()},
                 "opt_state": self._moments(self.optimizer.state_dict(), self.whole),
                 "step": self.step, "generator": self.generator.get_state()}
        if self.ema is not None:
            state["ema"] = {"params": {k: self.whole(k, v) for k, v in self.ema.params.items()},
                            "step": self.ema.step}
        return state

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """From the single-device format (on a placed trainer, each rank
        keeps its blocks)."""
        if ("ema" in state) != (self.ema is not None):
            raise ValueError("EMA present in one of state and trainer only")
        self.prior.network.load_state_dict(
            {k: self.local(k, v) for k, v in state["params"].items()}, strict=True)
        self.optimizer.load_state_dict(self._moments(state["opt_state"], self.local))
        if self.ema is not None:
            if set(state["ema"]["params"]) != set(self.ema.params):
                raise ValueError("EMA parameter names differ")
            for k, v in state["ema"]["params"].items():
                self.ema.params[k].copy_(self.local(k, v))
            self.ema.step = int(state["ema"]["step"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"].cpu())


def build_prior_trainer(cfg: Dict[str, Any], device: DeviceLike = None,
                        mesh: Optional[Mesh] = None) -> PriorTrainer:
    """The prior of ``cfg`` with its weights from seed's init stream (placed
    on ``mesh`` when given: the whole init is drawn on the host, so every
    rank's blocks are the one-process weights), and its trainer with the
    draw stream."""
    dev = resolve_device(device)
    pc = cfg["prior"]
    with init_from(derive_generator(cfg["seed"], _PRIOR_STAGE, 0)):
        prior = prior_from_config(cfg, dev, mesh=mesh)
    return PriorTrainer(
        prior, float(pc["lr"]), use_ema=bool(pc.get("use_ema", False)),
        ema=EMAConfig(beta=float(pc.get("ema_beta", 0.99)),
                      update_after_step=int(pc.get("ema_update_after_step", 100)),
                      update_every=int(pc.get("ema_update_every", 10))),
        generator=derive_generator(cfg["seed"], _PRIOR_STAGE, 1, device=dev))


def setup_prior_mesh(cfg: Dict[str, Any], device: DeviceLike = None
                     ) -> Tuple[torch.device, Mesh]:
    """This process's device and the mesh of scripts/train_prior.py:47-113
    over the launched ranks (the process group joined first under torchrun
    or ``multihost=true``): a model axis of ``pipeline_stages`` ranks for
    the pipeline, of ``expert_parallel`` for the experts (each defaulting
    to every rank), of 1 otherwise."""
    check_single_device(cfg)
    pc = cfg["prior"]
    pipe_mb, experts = int(pc.get("pipeline_microbatches", 0)), int(pc.get("ff_experts", 0))
    if pipe_mb > 0 and experts > 0:
        raise ValueError("pipeline and expert parallelism both take the mesh's 'model' axis: "
                         "enable one per run (prior.pipeline_microbatches or prior.ff_experts)")
    distributed = bool(cfg.get("multihost", False)) or "WORLD_SIZE" in os.environ
    if not distributed and int(pc.get("expert_parallel", 1)) > 1:
        raise NotImplementedError(
            f"prior.expert_parallel {pc['expert_parallel']} in one process: no ranks hold the "
            "experts (launch under torchrun; one device runs them all)")
    dev = resolve_device(rank_device(device) if distributed else device)
    maybe_init_distributed(distributed, device=dev)
    world = dist.get_world_size() if dist.is_initialized() else 1
    model = 1
    if pipe_mb > 0:
        model = int(pc.get("pipeline_stages", world))
    elif experts > 0:
        model = int(pc.get("expert_parallel", world))
    return dev, create_mesh(None, model, device=dev)


def train_prior(cfg: Dict[str, Any], dataset, splits: Dict[str, np.ndarray],
                device: DeviceLike = None) -> Dict[str, Any]:
    """scripts/train_prior.py's loop, on one device or over the mesh of
    ``setup_prior_mesh``. Returns the trainer, the mesh and the last
    epoch's mean train and val losses."""
    dev, mesh = setup_prior_mesh(cfg, device)
    pc = cfg["prior"]
    bs = int(pc["batch_size"])
    train_loader = BatchLoader(dataset, bs, splits["train"], shuffle=True, seed=cfg["seed"])
    val_loader = BatchLoader(dataset, bs, splits["val"], shuffle=False)
    trainer = build_prior_trainer(cfg, dev, mesh.row() if mesh.world > 1 else None)
    lead = mesh.rank == 0
    params_b, _ = trainer.param_bytes()
    log.info("mesh data=%d model=%d (rank %d of %d, %s, process group backend %s), %d "
             "parameter bytes on this rank", mesh.data, mesh.model, mesh.rank, mesh.world, dev,
             dist.get_backend() if dist.is_initialized() else "none", params_b)
    name = f"prior_{cfg['train_name']}"
    mgr = RollingCheckpointManager(str(Path(cfg["run_dir"]) / name),
                                   max_to_keep=int(cfg.get("ckpt_keep", 3)), best_k=1,
                                   metric_key="val_loss")
    saved = mgr.latest_step()  # read by every rank before rank 0 writes
    start_epoch = 0
    if bool(cfg.get("resume", False)) and saved is not None:
        # onto the host, then each rank's blocks onto its device
        trainer.load_state_dict(mgr.restore_latest(map_location="cpu"))
        start_epoch = trainer.step // max(len(splits["train"]) // bs, 1)
        log.info("resumed prior from step %d (epoch %d)", trainer.step, start_epoch)
    mlog = MetricsLogger(cfg["run_dir"], name, cfg["use_wandb"], cfg) if lead else None
    as_dev = lambda a: torch.as_tensor(a).to(dev, non_blocking=True)  # noqa: E731
    summary: Dict[str, Any] = {"trainer": trainer, "mesh": mesh}
    try:
        for epoch in range(start_epoch, int(pc["epochs"])):
            losses = [trainer.train_step(as_dev(b["video_embeds"]), as_dev(b["text_embeds"]))
                      for b in train_loader]
            if losses:  # one host sync per epoch
                summary["train_loss"] = float(torch.stack(losses).mean())
                if lead:
                    mlog.log({"train/loss": summary["train_loss"]}, step=trainer.step)
            vals = [float(trainer.eval_loss(as_dev(b["video_embeds"]), as_dev(b["text_embeds"])))
                    for b in val_loader]
            metrics = None
            if vals:
                summary["val_loss"] = float(np.mean(vals))
                if lead:
                    mlog.log({"val/loss": summary["val_loss"]}, step=trainer.step)
                metrics = {"val_loss": summary["val_loss"]}
            if saved != trainer.step:
                state = trainer.state_dict()  # every rank: the blocks are gathered
                if lead:
                    mgr.save(trainer.step, state, metrics=metrics)
                saved = trainer.step
            if lead:
                mlog.heartbeat()
            log.info("epoch %d done", epoch)
    finally:
        if lead:
            mlog.close()
    return summary


def main(argv=None) -> Dict[str, Any]:
    cfg = config_from_argv(argv)
    logging.basicConfig(level=cfg.get("log_level", "INFO"))
    dataset = CelebVTextDataset(text_embeds_path=cfg["texts"]["embed"],
                                video_embeds_path=cfg["videos"]["embed"])
    splits = split_indices(len(dataset), cfg["train_ratio"], cfg["seed"])
    joined_here = not dist.is_initialized()
    try:
        return train_prior(cfg, dataset, splits, cfg.get("device"))
    finally:
        if joined_here and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
