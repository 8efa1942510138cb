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
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from dalle2_video_tpu_torch.data.datasets import BatchLoader, CelebVTextDataset, split_indices
from dalle2_video_tpu_torch.models.prior import DiffusionPrior, prior_from_config
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
    ``generator`` (on the prior's device) feeds the loss's draws."""

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

    def train_step(self, video_embed: torch.Tensor, text_embed: torch.Tensor,
                   draws: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """One Adam update (then the EMA's); returns the loss (0-dim, on the
        device)."""
        net = self.prior.network.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.prior.loss(video_embed, text_embed, generator=self.generator, draws=draws)
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
        return self.prior.loss(video_embed, text_embed, generator=self.generator, draws=draws)

    def state_dict(self) -> Dict[str, Any]:
        """``{params, opt_state[, ema]}`` as the JAX prior's checkpoint, with
        the step and the draw generator's state."""
        state = {"params": self.prior.network.state_dict(),
                 "opt_state": self.optimizer.state_dict(),
                 "step": self.step, "generator": self.generator.get_state()}
        if self.ema is not None:
            state["ema"] = {"params": dict(self.ema.params), "step": self.ema.step}
        return state

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if ("ema" in state) != (self.ema is not None):
            raise ValueError("EMA present in one of state and trainer only")
        self.prior.network.load_state_dict(state["params"], strict=True)
        self.optimizer.load_state_dict(state["opt_state"])
        if self.ema is not None:
            if set(state["ema"]["params"]) != set(self.ema.params):
                raise ValueError("EMA parameter names differ")
            for k, v in state["ema"]["params"].items():
                self.ema.params[k].copy_(v)
            self.ema.step = int(state["ema"]["step"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"].cpu())


def build_prior_trainer(cfg: Dict[str, Any], device: DeviceLike = None) -> PriorTrainer:
    """The prior of ``cfg`` with its weights from seed's init stream, and its
    trainer with the draw stream."""
    dev = resolve_device(device)
    pc = cfg["prior"]
    with init_from(derive_generator(cfg["seed"], _PRIOR_STAGE, 0)):
        prior = prior_from_config(cfg, dev)
    return PriorTrainer(
        prior, float(pc["lr"]), use_ema=bool(pc.get("use_ema", False)),
        ema=EMAConfig(beta=float(pc.get("ema_beta", 0.99)),
                      update_after_step=int(pc.get("ema_update_after_step", 100)),
                      update_every=int(pc.get("ema_update_every", 10))),
        generator=derive_generator(cfg["seed"], _PRIOR_STAGE, 1, device=dev))


def train_prior(cfg: Dict[str, Any], dataset, splits: Dict[str, np.ndarray],
                device: DeviceLike = None) -> Dict[str, Any]:
    """scripts/train_prior.py's loop on one device. Returns the trainer and
    the last epoch's mean train and val losses."""
    check_single_device(cfg)
    dev = resolve_device(device)
    pc = cfg["prior"]
    if int(pc.get("expert_parallel", 1)) > 1:
        raise NotImplementedError(
            f"prior.expert_parallel {pc['expert_parallel']}: expert parallelism needs a mesh "
            "(not ported yet; the experts run on one device)")
    bs = int(pc["batch_size"])
    train_loader = BatchLoader(dataset, bs, splits["train"], shuffle=True, seed=cfg["seed"])
    val_loader = BatchLoader(dataset, bs, splits["val"], shuffle=False)
    trainer = build_prior_trainer(cfg, dev)
    name = f"prior_{cfg['train_name']}"
    mgr = RollingCheckpointManager(str(Path(cfg["run_dir"]) / name),
                                   max_to_keep=int(cfg.get("ckpt_keep", 3)), best_k=1,
                                   metric_key="val_loss")
    start_epoch = 0
    if bool(cfg.get("resume", False)) and mgr.latest_step() is not None:
        trainer.load_state_dict(mgr.restore_latest(map_location=dev))
        start_epoch = trainer.step // max(len(splits["train"]) // bs, 1)
        log.info("resumed prior from step %d (epoch %d)", trainer.step, start_epoch)
    mlog = MetricsLogger(cfg["run_dir"], name, cfg["use_wandb"], cfg)
    as_dev = lambda a: torch.as_tensor(a).to(dev, non_blocking=True)  # noqa: E731
    summary: Dict[str, Any] = {"trainer": trainer}
    try:
        for epoch in range(start_epoch, int(pc["epochs"])):
            losses = [trainer.train_step(as_dev(b["video_embeds"]), as_dev(b["text_embeds"]))
                      for b in train_loader]
            if losses:  # one host sync per epoch
                summary["train_loss"] = float(torch.stack(losses).mean())
                mlog.log({"train/loss": summary["train_loss"]}, step=trainer.step)
            vals = [float(trainer.eval_loss(as_dev(b["video_embeds"]), as_dev(b["text_embeds"])))
                    for b in val_loader]
            metrics = None
            if vals:
                summary["val_loss"] = float(np.mean(vals))
                mlog.log({"val/loss": summary["val_loss"]}, step=trainer.step)
                metrics = {"val_loss": summary["val_loss"]}
            if mgr.latest_step() != trainer.step:
                mgr.save(trainer.step, trainer.state_dict(), metrics=metrics)
            mlog.heartbeat()
            log.info("epoch %d done", epoch)
    finally:
        mlog.close()
    return summary


def main(argv=None) -> Dict[str, Any]:
    cfg = config_from_argv(argv)
    logging.basicConfig(level=cfg.get("log_level", "INFO"))
    dataset = CelebVTextDataset(text_embeds_path=cfg["texts"]["embed"],
                                video_embeds_path=cfg["videos"]["embed"])
    splits = split_indices(len(dataset), cfg["train_ratio"], cfg["seed"])
    return train_prior(cfg, dataset, splits, cfg.get("device"))


if __name__ == "__main__":
    main()
