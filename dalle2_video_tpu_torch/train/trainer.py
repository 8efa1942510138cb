"""DecoderTrainer (port of dalle2_video_tpu/train/trainer.py): per-unet
AdamW with weight-decay groups, global-norm clipping (0.5), warmup / cosine
learning-rate schedules, per-unet EMA shadows and step counters, bf16
compute over f32 masters, ``grad_accum`` and ``skip_nonfinite``.

The optimiser is ``torch.optim.AdamW`` per unet (weight decay on parameters
with >= 2 dims, 0 on the rest), fed gradients clipped to a global norm
first: p <- p (1 - lr wd) - lr adam(g) equals optax's clip ->
scale_by_adam -> add_decayed_weights -> scale_by_learning_rate, whose
schedule count is the number of applied updates (the optimiser's own step).

bf16 compute: the unet runs through ``torch.func.functional_call`` on bf16
casts of the f32 masters, so gradients flow back to the masters in f32 --
the JAX package's policy (not ``torch.autocast``, which keeps norms and
softmax in f32 and would give different numbers).

The train state lives in the decoder's unets (params), the optimisers, the
EMA shadows and ``steps``; ``state_dict`` / ``load_state_dict`` carry all
of it (plus the draw generator) through ``train/checkpoint.py``. A latent
stage's VAE (the JAX ``vae_{i}``) is frozen: no gradient, in no optimiser
group and no EMA; it is saved and restored with the unets (``vaes``) and
rides to the server in the sampling params (keys ``vae.<name>``). The JAX
package's ``train_steps_scan`` (K steps in one compiled program) becomes
the caller's plain loop over ``train_step``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from dalle2_video_tpu_torch.engine.decoder import VideoDecoder
from dalle2_video_tpu_torch.train.ema import EMAConfig, EMAState, ema_init, ema_update
from dalle2_video_tpu_torch.utils.keys import RowKeys

Draws = Optional[Dict[str, Any]]


def _cast_tuple(v, length: int) -> Tuple:
    if isinstance(v, (tuple, list)):
        if len(v) != length:
            raise ValueError(f"expected {length} entries, got {v}")
        return tuple(v)
    return (v,) * length


@dataclasses.dataclass(frozen=True)
class DecoderTrainerConfig:
    """Same fields and defaults as the JAX DecoderTrainerConfig."""

    lr: Union[float, Tuple[float, ...]] = 1e-4
    wd: Union[float, Tuple[float, ...]] = 1e-2
    eps: Union[float, Tuple[float, ...]] = 1e-8
    warmup_steps: Union[None, int, Tuple[Optional[int], ...]] = None
    cosine_decay_max_steps: Union[None, int, Tuple[Optional[int], ...]] = None
    max_grad_norm: Optional[float] = 0.5
    use_ema: bool = True
    ema: EMAConfig = EMAConfig()
    group_wd_params: bool = True
    # bf16 activations/compute; params and optimizer state stay fp32
    bf16_compute: bool = False
    grad_accum: int = 1
    # skip the update when the loss / gradients are non-finite
    skip_nonfinite: bool = True


def lr_at(count: int, base: float, warmup: Optional[int],
          cosine: Optional[int]) -> float:
    """optax cosine_decay_schedule (or constant) times the multiplicative
    linear warmup min(1, (count + 1) / warmup)."""
    lr = base
    if cosine is not None:
        lr = base * 0.5 * (1.0 + math.cos(math.pi * min(count, cosine) / cosine))
    if warmup:
        lr *= min(1.0, (count + 1.0) / warmup)
    return lr


class DecoderTrainer:
    """Trains the decoder's unets in place (see module docstring). ``seed``
    seeds the generator the loss draws from."""

    def __init__(self, decoder: VideoDecoder,
                 cfg: DecoderTrainerConfig = DecoderTrainerConfig(), seed: int = 0):
        self.decoder = decoder
        self.cfg = cfg
        n = self.num_unets = decoder.config.num_unets
        self.lr = _cast_tuple(cfg.lr, n)
        if any(lr > 1e-2 for lr in self.lr):
            raise ValueError("learning rate too high; recommend <= 5e-4")
        wd = _cast_tuple(cfg.wd, n)
        eps = _cast_tuple(cfg.eps, n)
        self.warmup = _cast_tuple(cfg.warmup_steps, n)
        self.cosine = _cast_tuple(cfg.cosine_decay_max_steps, n)
        if cfg.grad_accum < 1:
            raise ValueError("grad_accum must be >= 1")
        self.optimizers: List[torch.optim.AdamW] = []
        for i, unet in enumerate(decoder.unets):
            params = list(unet.parameters())
            if cfg.group_wd_params:
                groups = [{"params": [p for p in params if p.ndim >= 2], "weight_decay": wd[i]},
                          {"params": [p for p in params if p.ndim < 2], "weight_decay": 0.0}]
                groups = [g for g in groups if g["params"]]
            else:
                groups = [{"params": params, "weight_decay": wd[i]}]
            self.optimizers.append(torch.optim.AdamW(
                groups, lr=self.lr[i], betas=(0.9, 0.999), eps=eps[i]))
        self.ema: List[Optional[EMAState]] = [
            ema_init(self.params(i)) if cfg.use_ema else None for i in range(n)]
        self.steps = [0] * n
        self.generator = torch.Generator(device=decoder.device)
        self.generator.manual_seed(seed)

    # ------------------------------------------------------------------ #
    def params(self, i: int) -> Dict[str, torch.Tensor]:
        return dict(self.decoder.unets[i].named_parameters())

    def update_count(self, i: int) -> int:
        """Updates applied to unet i (the Adam / schedule count; a skipped
        non-finite step does not advance it)."""
        for group in self.optimizers[i].param_groups:
            for p in group["params"]:
                st = self.optimizers[i].state.get(p)
                return int(st["step"]) if st else 0
        return 0

    def _network(self, i: int):
        """The unet, or (bf16_compute) a functional call of it on bf16 casts
        of its f32 masters; gradients reach the masters through the casts."""
        unet = self.decoder.unets[i]
        if not self.cfg.bf16_compute:
            return unet
        cast = {k: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
                for k, p in unet.named_parameters()}
        return lambda *a, **kw: torch.func.functional_call(unet, cast, a, kw)

    def _loss(self, i: int, video, video_embed, text_encodings, draws: Draws) -> torch.Tensor:
        return self.decoder.loss(
            video, video_embed=video_embed, text_encodings=text_encodings, unet_number=i + 1,
            compute_dtype=torch.bfloat16 if self.cfg.bf16_compute else None,
            unet=self._network(i), generator=self.generator, draws=draws)

    # ------------------------------------------------------------------ #
    def train_step(self, video: torch.Tensor, *, video_embed: Optional[torch.Tensor] = None,
                   text_encodings: Optional[torch.Tensor] = None,
                   unet_number: int = 1,
                   draws: Union[Draws, Sequence[Draws]] = None) -> torch.Tensor:
        """One forward + backward + update of one unet; returns the loss
        (0-dim f32, on the device). With grad_accum = a the batch (the
        video, its embeds and text encodings) is cut into a microbatches
        (``draws`` then a list of a dicts or None), gradients and loss
        averaged over them. The two halves are ``backward`` and
        ``apply_update`` (the data-parallel step reduces the gradients
        between them: ``parallel/sharded.py``)."""
        loss = self.backward(video, video_embed=video_embed, text_encodings=text_encodings,
                             unet_number=unet_number, draws=draws)
        return self.apply_update(unet_number, loss)

    def backward(self, video: torch.Tensor, *, video_embed: Optional[torch.Tensor] = None,
                 text_encodings: Optional[torch.Tensor] = None, unet_number: int = 1,
                 draws: Union[Draws, Sequence[Draws]] = None) -> torch.Tensor:
        """The loss of unet ``unet_number`` on the batch and its gradient in
        every parameter's ``grad`` (zero where the step does not reach it);
        returns the loss. Arguments as ``train_step``."""
        i = unet_number - 1
        a = self.cfg.grad_accum
        b = video.shape[0]
        if b % a:
            raise ValueError(f"batch {b} not divisible by grad_accum {a}")
        micro = list(draws) if isinstance(draws, (list, tuple)) else [draws] * a
        if len(micro) != a:
            raise ValueError(f"{len(micro)} draw sets for grad_accum {a}")
        opt = self.optimizers[i]
        opt.zero_grad(set_to_none=True)
        mb = b // a
        total = None
        for j in range(a):
            sl = slice(j * mb, (j + 1) * mb)
            take = lambda a: None if a is None else a[sl]  # noqa: E731
            loss = self._loss(i, video[sl], take(video_embed), take(text_encodings), micro[j])
            (loss / a).backward()
            total = loss.detach() if total is None else total + loss.detach()
        for p in self.decoder.unets[i].parameters():
            if p.grad is None:  # unused on this step: a zero gradient, as in JAX
                p.grad = torch.zeros_like(p)
        return total / a

    def apply_update(self, unet_number: int, loss: torch.Tensor) -> torch.Tensor:
        """The update from the gradients ``backward`` left: clip to the
        global norm, skip where the loss or the norm is not finite, AdamW at
        the schedule's lr, then the EMA and the step count; returns loss."""
        i = unet_number - 1
        cfg = self.cfg
        opt = self.optimizers[i]
        grads = [p.grad for p in self.decoder.unets[i].parameters()]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
        if cfg.max_grad_norm is not None:
            scale = (cfg.max_grad_norm / norm).clamp(max=1.0)
            torch._foreach_mul_(grads, scale)
        if not cfg.skip_nonfinite or bool(torch.isfinite(loss) & torch.isfinite(norm)):
            lr = lr_at(self.update_count(i), self.lr[i], self.warmup[i], self.cosine[i])
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
        opt.zero_grad(set_to_none=True)
        if cfg.use_ema:
            ema_update(self.ema[i], self.params(i), cfg.ema)
        self.steps[i] += 1
        return loss

    @torch.no_grad()
    def eval_loss(self, video: torch.Tensor, *, video_embed: Optional[torch.Tensor] = None,
                  text_encodings: Optional[torch.Tensor] = None,
                  unet_number: int = 1, draws: Draws = None) -> torch.Tensor:
        """Validation loss under the same precision policy as training."""
        return self._loss(unet_number - 1, video, video_embed, text_encodings, draws)

    # ------------------------------------------------------------------ #
    def sampling_params(self, use_ema: bool = True) -> List[Dict[str, torch.Tensor]]:
        """Per stage, the parameters sampling uses: the unet's EMA shadows
        when ``use_ema`` (and EMA is on), else the online ones, and its
        frozen VAE's under ``vae.<name>`` (``VideoDecoder.
        load_sampling_params`` loads them)."""
        if use_ema and self.cfg.use_ema:
            unets = [dict(e.params) for e in self.ema]
        else:
            unets = [self.params(i) for i in range(self.num_unets)]
        return [dict(sd, **{f"vae.{k}": v for k, v in vae.state_dict().items()})
                for sd, vae in zip(unets, self.decoder.vaes)]

    @torch.no_grad()
    def sample(self, keys: RowKeys, use_ema: bool = True, **kwargs) -> torch.Tensor:
        """decoder.sample with the sampling params swapped into the unets
        for the call (the online params are restored after)."""
        dec = self.decoder
        swap = self.sampling_params(use_ema)
        online = [{k: p.detach().clone() for k, p in self.params(i).items()}
                  for i in range(self.num_unets)]

        def load(trees):
            for i, tree in enumerate(trees):
                for k, p in self.params(i).items():
                    p.copy_(tree[k])
            dec._sampling_unets.clear()  # bf16 / flash copies are rebuilt

        load(swap)
        try:
            return dec.sample(keys, **kwargs)
        finally:
            load(online)

    # ------------------------------------------------------------------ #
    def state_dict(self) -> Dict[str, Any]:
        return {
            "params": [u.state_dict() for u in self.decoder.unets],
            "vaes": [v.state_dict() for v in self.decoder.vaes],
            "opt_states": [o.state_dict() for o in self.optimizers],
            "ema": [None if e is None else {"params": dict(e.params), "step": e.step}
                    for e in self.ema],
            "steps": list(self.steps),
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if len(state["params"]) != self.num_unets:
            raise ValueError(f"state holds {len(state['params'])} unets, "
                             f"trainer {self.num_unets}")
        for unet, sd in zip(self.decoder.unets, state["params"]):
            unet.load_state_dict(sd, strict=True)
        for vae, sd in zip(self.decoder.vaes, state.get("vaes") or [{}] * self.num_unets):
            vae.load_state_dict(sd, strict=True)
        for opt, sd in zip(self.optimizers, state["opt_states"]):
            opt.load_state_dict(sd)
        for i, e in enumerate(state["ema"]):
            if (e is None) != (self.ema[i] is None):
                raise ValueError("EMA present in one of state and trainer only")
            if e is not None:
                if set(e["params"]) != set(self.ema[i].params):
                    raise ValueError("EMA parameter names differ")
                for k, v in e["params"].items():
                    self.ema[i].params[k].copy_(v)
                self.ema[i].step = int(e["step"])
        self.steps = [int(s) for s in state["steps"]]
        if state.get("generator") is not None:
            self.generator.set_state(state["generator"].cpu())
        self.decoder._sampling_unets.clear()
