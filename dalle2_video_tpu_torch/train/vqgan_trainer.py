"""The VQGAN-VAE adversarial trainer (port of
dalle2_video_tpu/train/vqgan_trainer.py): the latent-diffusion stage that
trains ``models/vqvae.py`` against ``models/discriminator.py``.

The taming-transformers recipe, as the JAX trainer runs it:

  G: L1 recon + perceptual (``gradient_l1``) + codebook/commit + lambda * hinge-G
  D: hinge(real, recon.detach()), gated to 0 until ``disc_start`` steps
  lambda = ||grad_dec(L_rec)|| / (||grad_dec(L_adv)|| + 1e-4), clipped to
           [0, 1e4], times ``disc_weight`` and the gate step >= disc_start

with the norms over the decoder subtree's gradients. The generator's two
gradients come from one forward: ``torch.autograd.grad`` of the
reconstruction loss (graph kept) and of the hinge-G loss, both with respect
to the VAE's parameters only, so the discriminator collects no gradient
from the G pass (the JAX pass holds its parameters under stop_gradient).

Each side's optimiser is the optax chain clip_by_global_norm(grad_clip) ->
scale_by_adam(0.5, 0.9) -> scale_by_learning_rate: ``clip_by_global_norm_``
(optax's rule: g / ||g|| * max only where ||g|| > max) then
``torch.optim.Adam``. Before ``disc_start`` the D loss is 0: its gradients
are zero, its Adam count still advances and its moments stay zero. With
``codebook_ema`` the codebook is a buffer that ``ema_codebook_update``
replaces after the G update, from the step's pre-quantisation latents and
codes; its statistics are ``vq_ema``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from dalle2_video_tpu_torch.models.discriminator import (
    PatchDiscriminator,
    hinge_d_loss,
    hinge_g_loss,
)
from dalle2_video_tpu_torch.models.vqvae import VQVAE, ema_codebook_update
from dalle2_video_tpu_torch.ops.video import resize_video


def gradient_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Multi-scale image-gradient L1, the handcrafted perceptual proxy: at
    scales 1, 1/2 and 1/4 (``jax.image.resize`` "linear", antialiased),
    the mean |d_x a - d_x b| + mean |d_y a - d_y b|, averaged."""
    total = 0.0
    for s in (1, 2, 4):
        if s > 1:
            aa = resize_video(a, a.shape[2] // s, method="linear")
            bb = resize_video(b, b.shape[2] // s, method="linear")
        else:
            aa, bb = a, b
        dxa, dxb = aa[:, :, :, 1:] - aa[:, :, :, :-1], bb[:, :, :, 1:] - bb[:, :, :, :-1]
        dya, dyb = aa[:, :, 1:] - aa[:, :, :-1], bb[:, :, 1:] - bb[:, :, :-1]
        total = total + (dxa - dxb).abs().mean() + (dya - dyb).abs().mean()
    return total / 3.0


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every tensor's sum of squares."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: each g becomes g / ||g|| * max
    where ||g|| > max (no epsilon), and stays as it is otherwise."""
    norm = global_norm(grads)
    keep = norm < max_norm  # on the device: no host sync
    clipped = torch._foreach_mul(torch._foreach_div(list(grads), norm), max_norm)
    for g, c in zip(grads, clipped):
        g.copy_(torch.where(keep, g, c))


@dataclasses.dataclass(frozen=True)
class VQGanTrainerConfig:
    """Same fields and defaults as the JAX VQGanTrainerConfig."""

    lr_g: float = 1e-4
    lr_d: float = 1e-4
    betas: Tuple[float, float] = (0.5, 0.9)
    disc_start: int = 1000
    disc_weight: float = 0.8
    perceptual_weight: float = 1.0
    grad_clip: float = 1.0


class VQGanTrainer:
    """Trains ``vae`` and ``disc`` in place (see the module docstring); the
    state is the two modules, the two optimisers, ``step`` and ``vq_ema``
    (``{"cluster_size": (K,), "embed_avg": (K, d)}`` with
    ``codebook_ema``, else None)."""

    def __init__(self, vae: VQVAE, disc: Optional[PatchDiscriminator] = None,
                 cfg: VQGanTrainerConfig = VQGanTrainerConfig(),
                 perceptual_fn: Optional[Callable] = None):
        self.vae = vae
        dev = next(vae.parameters()).device
        self.device = dev
        self.disc = disc if disc is not None else PatchDiscriminator(device=dev)
        self.cfg = cfg
        self.perceptual_fn = perceptual_fn or gradient_l1
        adam = lambda params, lr: torch.optim.Adam(  # noqa: E731
            params, lr=lr, betas=tuple(cfg.betas), eps=1e-8)
        self.opt_g = adam(list(self.vae.parameters()), cfg.lr_g)
        self.opt_d = adam(list(self.disc.parameters()), cfg.lr_d)
        self.step = 0
        self.vq_ema: Optional[Dict[str, torch.Tensor]] = None
        if vae.codebook_ema:
            cb = vae.vq.codebook
            self.vq_ema = {"cluster_size": torch.zeros(cb.shape[0], device=dev),
                           "embed_avg": cb.detach().float().clone()}

    def _recon(self, video: torch.Tensor):
        z = self.vae.encoder(video)
        quant, idx, vq_loss = self.vae.vq(z)
        return self.vae.decoder(quant), vq_loss, z, idx

    @staticmethod
    def _step(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor],
              grads: Sequence[Optional[torch.Tensor]], max_norm: float) -> None:
        """optax's clip -> Adam -> learning rate on ``grads`` (None: a zero
        gradient, as JAX's for a parameter the loss does not read)."""
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        clip_by_global_norm_(grads, max_norm)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)

    def train_step(self, video: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One G and one D update on ``video`` (b, t, h, w, c) in [0, 1];
        returns the JAX trainer's metrics as 0-dim tensors on the device."""
        cfg = self.cfg
        video = video.to(self.device, torch.float32)
        gate = float(self.step >= cfg.disc_start)
        params = list(self.vae.parameters())
        dec_ids = {id(p) for p in self.vae.decoder.parameters()}

        recon, vq_loss, z, idx = self._recon(video)
        rec = (recon - video).abs().mean() + cfg.perceptual_weight * self.perceptual_fn(
            recon, video)
        g_rec = torch.autograd.grad(rec + vq_loss, params, retain_graph=True,
                                    allow_unused=True)
        g_adv_val = hinge_g_loss(self.disc(recon))
        g_adv = torch.autograd.grad(g_adv_val, params, allow_unused=True)

        def dec_norm(grads):
            return global_norm([g for p, g in zip(params, grads)
                                if id(p) in dec_ids and g is not None])

        lam = dec_norm(g_rec) / (dec_norm(g_adv) + 1e-4)
        lam = lam.clamp(0.0, 1e4) * cfg.disc_weight * gate
        grads = []
        for p, a, b in zip(params, g_rec, g_adv):
            if a is None and b is None:
                grads.append(None)
                continue
            a = torch.zeros_like(p) if a is None else a
            grads.append(a if b is None else a + lam * b)
        self._step(self.opt_g, params, grads, cfg.grad_clip)

        if self.vq_ema is not None:
            vq = self.vae.vq
            cb, cs, ea = ema_codebook_update(
                vq.codebook, self.vq_ema["cluster_size"], self.vq_ema["embed_avg"],
                z.detach(), idx, decay=self.vae.ema_decay)
            vq.codebook.copy_(cb)
            self.vq_ema = {"cluster_size": cs, "embed_avg": ea}

        fake = recon.detach()
        logits_real, logits_fake = self.disc(video), self.disc(fake)
        d_loss = gate * hinge_d_loss(logits_real, logits_fake)
        d_params = list(self.disc.parameters())
        self._step(self.opt_d, d_params, torch.autograd.grad(d_loss, d_params), cfg.grad_clip)
        self.step += 1
        return {
            "loss/rec": rec.detach(),
            "loss/vq": vq_loss.detach(),
            "loss/g_adv": g_adv_val.detach(),
            "loss/d": d_loss.detach(),
            "lambda_adapt": lam.detach(),
            "logits/real": logits_real.detach().mean(),
            "logits/fake": logits_fake.detach().mean(),
        }

    @torch.no_grad()
    def eval_recon(self, video: torch.Tensor) -> Dict[str, torch.Tensor]:
        video = video.to(self.device, torch.float32)
        recon, vq_loss, _, _ = self._recon(video)
        return {
            "val/rec_l1": (recon - video).abs().mean(),
            "val/psnr": -10.0 * torch.log10(((recon - video) ** 2).mean() + 1e-10),
            "val/vq": vq_loss,
        }

    # ------------------------------------------------------------------ #
    def state_dict(self) -> Dict[str, Any]:
        """The JAX VQGanTrainState's fields."""
        return {"vae_params": self.vae.state_dict(),
                "disc_params": self.disc.state_dict(),
                "opt_g": self.opt_g.state_dict(), "opt_d": self.opt_d.state_dict(),
                "step": self.step,
                "vq_ema": None if self.vq_ema is None else dict(self.vq_ema)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if (state["vq_ema"] is None) != (self.vq_ema is None):
            raise ValueError("vq_ema present in one of state and trainer only")
        self.vae.load_state_dict(state["vae_params"], strict=True)
        self.disc.load_state_dict(state["disc_params"], strict=True)
        self.opt_g.load_state_dict(state["opt_g"])
        self.opt_d.load_state_dict(state["opt_d"])
        self.step = int(state["step"])
        if self.vq_ema is not None:
            self.vq_ema = {k: v.to(self.device) for k, v in state["vq_ema"].items()}
