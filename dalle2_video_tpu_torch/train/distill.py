"""Progressive (and guided) distillation of a trained decoder stage (port of
dalle2_video_tpu/train/distill.py), and its entry point, the counterpart of
scripts/distill_decoder.py's phase loop:

    python -m dalle2_video_tpu_torch.train.distill [configs/celebv_text.yaml] \
        [--run runs/distill] [--steps 400] [key=value ...]

The student learns to make in ONE DDIM step what the teacher makes in two
(Salimans & Ho), the teacher evaluated under classifier-free guidance at
``teacher_cond_scale`` so that the student folds the guidance into a single
unguided forward (Meng et al., the fixed-w variant). With alpha_t =
sqrt(a-bar[t + 1]), sigma_t = sqrt(1 - a-bar[t + 1]) (a-bar[0] = 1):

  z_t ~ q(z_t | x0) at a segment start t of the student's DDIM grid,
  teacher: z_t -> z_mid -> z_end (two eta-0 DDIM steps of the doubled grid),
  target   x~ = (z_end - (sigma_end / sigma_t) z_t)
                / (alpha_end - (sigma_end / sigma_t) alpha_t),
  loss     w(t) * ||x_hat_student(z_t, t) - x~||^2, w = max(SNR(t), 1)
           ("truncated_snr") or 1 ("none").

Both predictions are dynamic-thresholded as the sampler does, and the
gradient runs through the quantile and the clip. SR stages take the
sampling-time conditioning (``_lowres_cond_kwargs``: nearest down to the
previous stage and up again, noise at the fixed
``lowres_noise_sample_level``, no blur).

Where the port differs in form: the teacher and the student are parameter
dicts (name -> f32 tensor) run through the decoder's sampling unet by
``torch.func.functional_call`` (``VideoDecoder._unet_apply(params=...)``:
bf16 casts of the f32 masters under ``sample_compute_dtype``, so the
student's gradient reaches its masters); the teacher runs under
``torch.no_grad`` and never changes. The optimiser is
``torch.optim.Adam(lr, eps=1e-8)`` (optax ``adam``: no clipping, no decay),
the EMA the plain d * e + (1 - d) * p of every step. Draws come from a
``torch.Generator`` (the segment, the noise, the low-res noise), each
injectable (``draws``) so tests can hand in the JAX draws. The trainer
holds its state (student, EMA, Adam, step, generator; ``state_dict`` /
``load_state_dict``) where the JAX package passes a ``DistillState``.

Refused at construction, as in the JAX package: a self-conditioned stage,
and ``teacher_cond_scale`` != 1 on a decoder trained without conditional
dropout. Also refused here: a stage with ``cross_attention_impl: flash``,
whose kernel has no backward (JAX's gradient through it fails to
linearise); build the decoder with ``cross_attention_impl: xla``.

The entry point distills unet 1 of the decoder checkpoint that serving
resolves (``<run_dir>/decoder_<train_name>``, its sampling parameters:
the EMA shadows where kept) in halving phases ``PHASES``, the first at
``COND_SCALE`` 2.0 and the later at 1, each phase's EMA student the next
phase's teacher, on the decoder's data path (``videos.preprocessed`` /
``videos.embed``, the ``loader`` of the config, ``decoder.batch_size``).
Each phase writes ``<run>/student_<steps>/state`` and a ``done`` marker;
a rerun reloads the finished phases. ``results.json`` holds each phase's
losses and ms per step. Serve a student with ``serve_distill: {ckpt:
<run>/student_4/state, steps: 4, unet: 1}`` (``serve/stack.py``) at
cond_scale 1.

Then the students are scored (``score_students``, the script's scoring):
the FVD (``utils/fvd.py``, its fixed-seed ViViT extractor) of each
phase's EMA student, sampled alone at its own step count and cond_scale 1
(``stop_at_unet_number`` 1, one request seed ``SEED_BASE`` + i per
sample), against min(``N_EVAL``, held-out) clips of the data path's
held-out split, embedded once, with a split-half real-vs-real anchor.
The space the reals are scored in: the stores hold CLIP-normalised
values, which the decoder maps by x 2 - 1 as if they were [0, 1]
pictures, so a sample is the store's values clamped to [0, 1]; the reals
are the store's clips at the stage's geometry (nearest, as the loss
resizes them), clamped to [0, 1] (``results.json``'s ``score_space``).
The students sample through the serve recipe's cross-attention kernel
(``cross_attention_impl: flash``, which the trainer cannot take). A rerun
scores only the phases without a score. ``results.json`` gains
``extractor``, ``fvd_real_vs_real_splithalf``, ``fvd_student<n>`` and
``sample_s_student<n>``.

The JAX script's own data source is the curve teacher (``--curve
runs/r2_curve``, ``distill_curve``): unet 1 of ``train/train_curve.py``'s
EMA cascade, fresh blob batches from RandomState(0) fed to the decoder as
the [0, 1] pictures they are, and the scoring on ``N_EVAL`` held-out blob
clips (RandomState(123), ``train/eval_quality.py``'s reals), sampled
through the curve's own decoder (bf16, xla cross-attention):

    python -m dalle2_video_tpu_torch.train.distill --curve runs/r2_curve \
        [--run runs/distill] [--steps 400] [device=cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np
import torch

from dalle2_video_tpu_torch.engine.conditioner import noise_video
from dalle2_video_tpu_torch.engine.decoder import VideoDecoder, build_decoder, ddim_time_pairs
from dalle2_video_tpu_torch.models.layers import CrossAttention
from dalle2_video_tpu_torch.ops.video import resize_video, resize_video_time
from dalle2_video_tpu_torch.train.checkpoint import (
    has_checkpoint,
    load_checkpoint,
    load_decoder_sampling_params,
    save_checkpoint,
)
from dalle2_video_tpu_torch.train.common import check_single_device, make_loaders, results_file
from dalle2_video_tpu_torch.utils.config import config_from_argv
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device
from dalle2_video_tpu_torch.utils.fvd import embed_all, fvd_from_features, vivit_embed_fn
from dalle2_video_tpu_torch.utils.keys import RowKeys, batch_draw
from dalle2_video_tpu_torch.utils.profiling import StepTimer

log = logging.getLogger("dalle2_video_tpu_torch.distill")

Params = Dict[str, torch.Tensor]
WEIGHTS = ("truncated_snr", "none")


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Same fields and defaults as the JAX DistillConfig."""

    student_steps: int = 8  # the grid the student will sample with
    teacher_cond_scale: float = 1.0  # > 1 folds CFG into the student
    unet_number: int = 1  # 1-indexed cascade stage
    lr: float = 1e-4
    weight: str = "truncated_snr"  # "truncated_snr" | "none"
    ema_decay: float = 0.999


def distill_grid(total: int, student_steps: int):
    """(starts, mids, ends): the student's DDIM segments and the teacher's
    midpoints, from the doubled grid, whose even entries must be the
    student grid; a grid whose doubled steps collapse raises."""
    fine = ddim_time_pairs(total, 2 * student_steps)
    coarse = ddim_time_pairs(total, student_steps)
    if len(fine) != 2 * len(coarse):
        raise ValueError(f"degenerate grid: {2 * student_steps} teacher steps collapse to "
                         f"{len(fine)}; student_steps too large for T={total}")
    starts, mids = [f[0] for f in fine[0::2]], [f[1] for f in fine[0::2]]
    ends = [f[1] for f in fine[1::2]]
    if list(zip(starts, ends)) != coarse:
        raise AssertionError("doubled DDIM grid does not refine the student grid")
    return starts, mids, ends


class DistillTrainer:
    """Distills unet ``cfg.unet_number`` of ``decoder``; ``seed`` seeds the
    generator the loss draws from. Call ``init_state`` before a step."""

    def __init__(self, decoder: VideoDecoder, cfg: DistillConfig = DistillConfig(),
                 seed: int = 0):
        self.decoder, self.cfg = decoder, cfg
        i = self.i = cfg.unet_number - 1
        if decoder.unet_configs[i].self_cond:
            raise NotImplementedError(
                "distillation with self-conditioning is not supported: the teacher's "
                "two steps would need chained self-cond state")
        if cfg.teacher_cond_scale != 1.0 and not decoder.can_classifier_guidance:
            raise ValueError("teacher_cond_scale > 1 needs a teacher trained with "
                             "conditional dropout (cond_drop_prob > 0)")
        if cfg.weight not in WEIGHTS:
            raise ValueError(f"weight {cfg.weight!r} not in {WEIGHTS}")
        if any(isinstance(m, CrossAttention) and m.impl == "flash"
               for m in decoder.unets[i].modules()):
            raise ValueError(
                f"distillation differentiates unet {i + 1}, whose cross_attention_impl "
                "'flash' is forward-only (no backward, as in the JAX package); build the "
                "decoder with cross_attention_impl: xla")
        starts, mids, ends = distill_grid(decoder.schedules[i].num_timesteps, cfg.student_steps)
        dev = decoder.device
        as_t = lambda v: torch.tensor(v, dtype=torch.long, device=dev)  # noqa: E731
        self.t_starts, self.t_mids, self.t_ends = as_t(starts), as_t(mids), as_t(ends)
        self.acp_pad = torch.cat([torch.ones(1, device=dev),
                                  decoder.schedules[i].alphas_cumprod])
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        self.teacher: Optional[Params] = None
        self.student: Optional[Params] = None
        self.ema: Optional[Params] = None
        self.optimizer: Optional[torch.optim.Adam] = None
        self.step = 0

    # ------------------------------------------------------------------ #
    def init_state(self, teacher: Optional[Mapping[str, torch.Tensor]] = None,
                   student: Optional[Mapping[str, torch.Tensor]] = None) -> None:
        """The teacher's parameters (by name; default the decoder's unet),
        copied and frozen; the student a copy of the teacher's (the paper's
        init: the loss is then ~0 at teacher_cond_scale 1) unless
        ``student`` is given; the EMA a copy of the student; fresh Adam
        moments; step 0."""
        dev = self.decoder.device
        if teacher is None:
            teacher = dict(self.decoder.unets[self.i].named_parameters())
        copy = lambda tree: {k: v.detach().to(dev, torch.float32).clone()  # noqa: E731
                             for k, v in tree.items()}
        self.teacher = copy(teacher)
        self.student = {k: v.requires_grad_(True)
                        for k, v in copy(teacher if student is None else student).items()}
        self.ema = copy(self.student)
        self.optimizer = torch.optim.Adam(list(self.student.values()), lr=self.cfg.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.step = 0

    def student_decoder_params(self, params: Sequence[Mapping[str, torch.Tensor]],
                               use_ema: bool = True) -> List[Params]:
        """Per-unet parameter dicts (e.g. the decoder's sampling params) with
        the distilled student in its slot: sample at cond_scale 1 with the
        stage's DDIM grid at ``student_steps``."""
        out = [dict(p) for p in params]
        out[self.i] = {k: v.detach() for k, v in (self.ema if use_ema else self.student).items()}
        return out

    # ------------------------------------------------------------------ #
    def _alpha_sigma(self, t: torch.Tensor, nd: int):
        """alpha, sigma at (possibly -1) timesteps t, broadcast to nd dims."""
        acp = self.acp_pad[t + 1].reshape((-1,) + (1,) * (nd - 1))
        return torch.sqrt(acp), torch.sqrt(1.0 - acp)

    def _xstart(self, params: Params, z, t, *, cond_scale: float, cond: Dict[str, Any]):
        """One forward's x-prediction, dynamic-thresholded as the sampler's
        (a pixel stage only: latents are not clipped)."""
        dec, i = self.decoder, self.i
        out = dec._unet_apply(i, z, t, cond_scale=cond_scale, params=params, **cond)
        x0 = dec._predict_x_start(i, z, t, dec._split_output(i, out)[0])
        clip = dec.config.clip_denoised and not dec.vaes[i].is_latent
        return dec.dynamic_threshold(x0) if clip else x0

    def _ddim_to(self, z, x0, t_from, t_to, nd: int):
        """One eta-0 DDIM step given the x-prediction."""
        a_f, s_f = self._alpha_sigma(t_from, nd)
        a_t, s_t = self._alpha_sigma(t_to, nd)
        eps = (z - a_f * x0) / s_f.clamp_min(1e-20)
        return a_t * x0 + s_t * eps

    def _lowres_cond_kwargs(self, video01: torch.Tensor,
                            noise: Optional[torch.Tensor]) -> Dict[str, Any]:
        """An SR stage's conditioning as sample() builds it: the [0, 1] clip
        nearest-resized to the previous stage's geometry and back up to
        this stage's, noised at the fixed ``lowres_noise_sample_level`` (no
        blur, no random level), VAE-encoded on a latent stage, normalised
        otherwise. ``noise`` replaces the draw."""
        dec, i = self.decoder, self.i
        dcfg = dec.config
        prev = resize_video(video01, dcfg.frame_sizes[i - 1], clamp_range=(0.0, 1.0))
        prev = resize_video_time(prev, dcfg.frame_numbers[i - 1])
        lowres = resize_video(prev, dcfg.frame_sizes[i], clamp_range=(0.0, 1.0))
        lowres = resize_video_time(lowres, dcfg.frame_numbers[i])
        out: Dict[str, Any] = {}
        if dec.use_noise_for_lowres[i]:
            level = torch.full((video01.shape[0],), int(dcfg.lowres_noise_sample_level * 1000),
                               dtype=torch.long, device=video01.device)
            if noise is None:
                noise = batch_draw(lambda s: torch.randn(s, generator=self.generator,
                                                         device=lowres.device), lowres.shape)
            lowres, _ = noise_video(None, lowres, dec.lowres_noise_schedule,
                                    dec.lowres_configs[i], level, noise=noise.to(lowres))
            out["lowres_noise_level"] = level
        vae = dec.vaes[i]
        if vae.is_latent:
            with torch.no_grad():
                out["lowres_cond_video"] = vae.encode(lowres)
        else:
            out["lowres_cond_video"] = dec._normalize(lowres)
        return out

    def loss(self, video: torch.Tensor, *, video_embed: Optional[torch.Tensor] = None,
             text_encodings: Optional[torch.Tensor] = None,
             draws: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """The distillation loss of a [0, 1] video batch (b, T, H, W, C), a
        0-dim f32 tensor, differentiable in the student's parameters.
        ``draws`` injects any of "segments" (b,), "noise" (the stage's video
        shape) and "lowres_noise"; the rest come from the generator."""
        dec, i, cfg = self.decoder, self.i, self.cfg
        dcfg, ucfg, sched = dec.config, dec.unet_configs[i], dec.schedules[i]
        dev, g = dec.device, self.generator
        draws = draws or {}
        video = video.to(dev, torch.float32)
        b = video.shape[0]

        cond: Dict[str, Any] = {}
        if ucfg.cond_on_video_embeds:
            cond["video_embed"] = None if video_embed is None else video_embed.to(dev)
        if ucfg.cond_on_text_encodings:
            cond["text_encodings"] = None if text_encodings is None else text_encodings.to(dev)
        if ucfg.lowres_cond:
            cond.update(self._lowres_cond_kwargs(video, draws.get("lowres_noise")))

        video = resize_video_time(resize_video(video, dcfg.frame_sizes[i]),
                                  dcfg.frame_numbers[i])
        vae = dec.vaes[i]
        if vae.is_latent:  # the student's target lives in the VAE's latent space
            with torch.no_grad():
                x0 = vae.encode(video)
        else:
            x0 = dec._normalize(video)
        nd = x0.ndim
        seg = draws.get("segments")
        seg = (batch_draw(lambda s: torch.randint(0, len(self.t_starts), s, generator=g,
                                                  device=dev), (b,))
               if seg is None else torch.as_tensor(seg).to(dev, torch.long))
        t, t_mid, t_end = self.t_starts[seg], self.t_mids[seg], self.t_ends[seg]
        noise = draws.get("noise")
        noise = (batch_draw(lambda s: torch.randn(s, generator=g, device=dev), x0.shape)
                 if noise is None else torch.as_tensor(noise).to(dev, torch.float32))
        z_t = sched.q_sample(x0, t, noise)

        with torch.no_grad():  # the teacher: two guided DDIM steps
            w = cfg.teacher_cond_scale
            x0_a = self._xstart(self.teacher, z_t, t, cond_scale=w, cond=cond)
            z_mid = self._ddim_to(z_t, x0_a, t, t_mid, nd)
            x0_b = self._xstart(self.teacher, z_mid, t_mid, cond_scale=w, cond=cond)
            z_end = self._ddim_to(z_mid, x0_b, t_mid, t_end, nd)
            a_t, s_t = self._alpha_sigma(t, nd)
            a_e, s_e = self._alpha_sigma(t_end, nd)
            ratio = s_e / s_t.clamp_min(1e-20)
            target = (z_end - ratio * z_t) / (a_e - ratio * a_t)

        x0_s = self._xstart(self.student, z_t, t, cond_scale=1.0, cond=cond)
        err = torch.mean(torch.square(x0_s - target), dim=tuple(range(1, nd)))
        if cfg.weight == "truncated_snr":
            snr = (a_t * a_t) / (s_t * s_t).clamp_min(1e-20)
            err = err * snr.reshape(-1).clamp_min(1.0)
        return err.mean()

    def distill_step(self, video: torch.Tensor, *, video_embed: Optional[torch.Tensor] = None,
                     text_encodings: Optional[torch.Tensor] = None,
                     draws: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """One Adam update of the student, then the EMA d * e + (1 - d) * p;
        returns the loss (0-dim, on the device). The two halves are
        ``backward`` and ``apply_update`` (the data-parallel step reduces the
        gradients between them: ``parallel/sharded.py``)."""
        loss = self.backward(video, video_embed=video_embed, text_encodings=text_encodings,
                             draws=draws)
        return self.apply_update(loss)

    def backward(self, video: torch.Tensor, *, video_embed: Optional[torch.Tensor] = None,
                 text_encodings: Optional[torch.Tensor] = None,
                 draws: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """The loss and its gradient in every student parameter's ``grad``
        (zero where the stage does not reach it); returns the loss."""
        if self.student is None:
            raise RuntimeError("init_state first")
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(video, video_embed=video_embed, text_encodings=text_encodings,
                         draws=draws)
        loss.backward()
        for p in self.student.values():
            if p.grad is None:  # unused on this stage: a zero gradient, as in JAX
                p.grad = torch.zeros_like(p)
        return loss.detach()

    def apply_update(self, loss: torch.Tensor) -> torch.Tensor:
        """The Adam update from the gradients ``backward`` left, the EMA and
        the step count; returns loss."""
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        d = self.cfg.ema_decay
        with torch.no_grad():
            names = list(self.ema)
            ema = [self.ema[k] for k in names]
            scaled = torch._foreach_mul([self.student[k] for k in names], 1.0 - d)
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, scaled)
        self.step += 1
        return loss

    # ------------------------------------------------------------------ #
    def state_dict(self) -> Dict[str, Any]:
        return {"student": {k: v.detach() for k, v in self.student.items()},
                "ema": dict(self.ema), "opt_state": self.optimizer.state_dict(),
                "step": self.step, "generator": self.generator.get_state()}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Into the template ``init_state`` made (strict by name and shape)."""
        if self.student is None:
            raise RuntimeError("init_state first: the state loads into its template")
        for key, own in (("student", self.student), ("ema", self.ema)):
            if set(state[key]) != set(own):
                raise ValueError(f"{key} parameter names differ from the template's")
            for k, v in state[key].items():
                own[k].copy_(v)
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"].cpu())


@torch.no_grad()
def serve_student(decoder: VideoDecoder, path: str, steps: int, unet_number: int = 1) -> None:
    """``serve_distill`` (JAX scripts/serve.py:84-106): the EMA student of
    the distill checkpoint at ``path`` swapped into cascade slot
    ``unet_number``, and only that slot's ``sample_timesteps`` pinned to
    ``steps``. The state is checked against a template of the slot's own
    parameters (student and EMA, names and shapes); serve at cond_scale 1.
    (No trainer is built: a serving stack's flash cross-attention is one a
    trainer refuses.)"""
    i = unet_number - 1
    if decoder.unet_configs[i].self_cond:
        raise NotImplementedError("a self-conditioned stage has no distilled student")
    distill_grid(decoder.schedules[i].num_timesteps, steps)
    state = load_checkpoint(path, map_location=decoder.device)
    own = dict(decoder.unets[i].named_parameters())
    for key in ("student", "ema"):
        tree = state[key]
        if set(tree) != set(own) or any(tuple(tree[k].shape) != tuple(p.shape)
                                        for k, p in own.items()):
            raise ValueError(f"{path}: the {key} does not match unet {unet_number}'s parameters")
    for k, p in own.items():
        p.copy_(state["ema"][k])
    decoder._sampling_unets.clear()  # the bf16 / flash copies are rebuilt
    decoder.sample_timesteps = tuple(steps if j == i else s
                                     for j, s in enumerate(decoder.sample_timesteps))


# ---------------------------------------------------------------------- #
# the entry point (scripts/distill_decoder.py's phases)
# ---------------------------------------------------------------------- #
PHASES = (32, 16, 8, 4)  # student_steps per halving phase
COND_SCALE = 2.0  # folded into the student in the first phase
LR = 1e-4
LOG_EVERY = 50
N_EVAL = 64  # held-out clips scored (at most the split's)
EVAL_BATCH = 16
SEED_BASE = 1000  # sample i's request seed: SEED_BASE + i (the script's PRNGKey(1000 + s))
CURVE_BATCH = 8  # blob clips a distill step of the curve teacher
SCORE_SPACE = ("the store's values (CLIP-normalised) at the stage's geometry (nearest), "
               "clamped to [0, 1]; samples as the decoder returns them, clamped to [0, 1]")


def load_teacher(cfg: Dict[str, Any], decoder: VideoDecoder) -> None:
    """Load the decoder checkpoint serving resolves into ``decoder``'s
    unets (its sampling parameters); refuse to distill without one."""
    path = Path(cfg["run_dir"]) / f"decoder_{cfg['train_name']}"
    if not has_checkpoint(str(path)):
        raise FileNotFoundError(f"no decoder checkpoint at {path} to distill")
    decoder.load_sampling_params(load_decoder_sampling_params(
        str(path), map_location=decoder.device))
    log.info("teacher: %s", path)


def _batches(loader) -> Iterator[Dict[str, Any]]:
    """The loader's batches, epoch after epoch."""
    while True:
        empty = True
        for batch in loader:
            empty = False
            yield batch
        if empty:
            raise ValueError("the training split holds no whole batch")


def held_out_reals(dataset, indices, decoder: VideoDecoder):
    """(videos, video embeds) of the clips at ``indices``: the store's clips
    at unet 1's geometry (nearest, as the loss resizes them), clamped to
    [0, 1], on the decoder's device."""
    dcfg, dev = decoder.config, decoder.device
    videos, embeds = [], []
    for s in range(0, len(indices), EVAL_BATCH):
        batch = dataset.batch_items(indices[s:s + EVAL_BATCH])
        v = resize_video(torch.as_tensor(batch["videos"]).to(dev), dcfg.frame_sizes[0])
        videos.append(resize_video_time(v, dcfg.frame_numbers[0]).clamp(0.0, 1.0))
        embeds.append(torch.as_tensor(batch["video_embeds"]).to(dev, torch.float32))
    return torch.cat(videos), torch.cat(embeds)


def score_students(cfg: Dict[str, Any], dataset, splits: Dict[str, Any],
                   emas: Dict[int, Params], results: Dict[str, Any], flush,
                   device: DeviceLike = None) -> None:
    """scripts/distill_decoder.py's scoring (see the module docstring) into
    ``results``, ``flush()`` after the anchor and after each student."""
    dev = resolve_device(device)
    n = min(N_EVAL, len(splits["val"]))
    if n < 4:
        raise ValueError(f"scoring needs at least 4 held-out clips (each half of the "
                         f"real-vs-real anchor more than one); the split holds "
                         f"{len(splits['val'])}")
    decoder = build_decoder({**cfg, **{u: dict(cfg[u], cross_attention_impl="flash")
                                       for u in ("unet1", "unet2")}}, dev)
    reals, embeds = held_out_reals(dataset, np.asarray(splits["val"][:n]), decoder)
    results["score_space"] = SCORE_SPACE
    score_phases(decoder, reals, embeds, emas, results, flush)


def score_phases(decoder: VideoDecoder, reals, embeds, emas: Dict[int, Params],
                 results: Dict[str, Any], flush) -> Optional[torch.Tensor]:
    """The FVD of each phase's EMA student (loaded into ``decoder``'s unet
    1, sampled unguided at its own step count, one request seed
    ``SEED_BASE`` + i per sample) against ``reals`` (n, T, H, W, C) in [0,
    1], beside the split-half anchor, into ``results``; ``flush()`` after
    the anchor and after each student. A phase already scored is skipped.
    Returns the last phase's samples where it was scored here."""
    n = len(reals)
    embed_fn, provenance = vivit_embed_fn(device=decoder.device)
    results.setdefault("extractor", provenance)
    feats_real = embed_all(reals, embed_fn, EVAL_BATCH)  # embedded once
    half = n // 2
    results["fvd_real_vs_real_splithalf"] = fvd_from_features(feats_real[:half],
                                                              feats_real[half:])
    log.info("anchor (real vs real, split half): %.4f", results["fvd_real_vs_real_splithalf"])
    flush()
    own = dict(decoder.unets[0].named_parameters())
    last = None
    for steps in PHASES:
        tag = f"student{steps}"
        if f"fvd_{tag}" in results:
            continue
        with torch.no_grad():
            for k, p in own.items():
                p.copy_(emas[steps][k])
        decoder._sampling_unets.clear()  # the bf16 copy is rebuilt
        decoder.sample_timesteps = (steps, *decoder.sample_timesteps[1:])
        timer = StepTimer()
        timer.start()
        fakes = torch.cat([decoder.sample(
            RowKeys.from_request_seeds(range(SEED_BASE + s, SEED_BASE + s + len(e))),
            video_embed=e, cond_scale=1.0, stop_at_unet_number=1)
            for s, e in ((s, embeds[s:s + EVAL_BATCH]) for s in range(0, n, EVAL_BATCH))])
        results[f"sample_s_{tag}"] = timer.stop(fakes)
        results[f"fvd_{tag}"] = fvd_from_features(feats_real,
                                                  embed_all(fakes, embed_fn, EVAL_BATCH))
        log.info("%s: FVD %.4f (%.1f s to sample %d)", tag, results[f"fvd_{tag}"],
                 results[f"sample_s_{tag}"], n)
        flush()
        if steps == PHASES[-1]:
            last = fakes
    return last


def run_phases(decoder: VideoDecoder, teacher: Params, run: Path, steps_per_phase: int,
               next_batch, results: Dict[str, Any], flush):
    """The halving phases (``PHASES``; the first at ``COND_SCALE``, each
    phase's EMA student the next one's teacher) of unet 1 from
    ``teacher``, each ``steps_per_phase`` distill steps on ``next_batch()``
    (videos [0, 1], video embeds) and its checkpoint
    ``<run>/student_<steps>``; a finished phase is reloaded. Returns
    (the EMA student of each phase by step count, the last trainer)."""
    dev = decoder.device
    tr = None
    emas: Dict[int, Params] = {}
    for phase, steps in enumerate(PHASES):
        w = COND_SCALE if phase == 0 else 1.0
        tr = DistillTrainer(decoder, DistillConfig(student_steps=steps,
                                                   teacher_cond_scale=w, lr=LR),
                            seed=100 + phase)
        tr.init_state(teacher)
        ck = run / f"student_{steps}"
        if (ck / "done").exists():
            tr.load_state_dict(load_checkpoint(str(ck / "state"), map_location=dev))
            log.info("phase %d: reloaded its finished checkpoint", steps)
        else:
            losses = []
            t0 = time.time()
            for it in range(steps_per_phase):
                videos, video_embed = next_batch()
                loss = tr.distill_step(videos, video_embed=video_embed)
                if (it + 1) % LOG_EVERY == 0 or it + 1 == steps_per_phase:
                    losses.append(float(loss))  # one host sync per interval
                    log.info("phase %d (w=%s) step %d: loss %.4f (%.0f ms/step)", steps, w,
                             it + 1, losses[-1], (time.time() - t0) / (it + 1) * 1e3)
            save_checkpoint(str(ck / "state"), tr.state_dict())
            (ck / "done").write_text("ok")
            results[f"phase{steps}_losses"] = losses
            results[f"phase{steps}_ms_per_step"] = (
                (time.time() - t0) / max(steps_per_phase, 1) * 1e3)
            flush()
        teacher = emas[steps] = tr.ema  # the EMA student teaches the next phase
    return emas, tr


def distill(cfg: Dict[str, Any], run: Path, steps_per_phase: int,
            device: DeviceLike = None) -> Dict[str, Any]:
    """The phase loop on one device, then the scoring. Returns the results
    dict (also written to ``<run>/results.json``) and, under "trainer", the
    last phase's trainer."""
    from dalle2_video_tpu_torch.train.__main__ import store_dataset

    check_single_device(cfg)
    dev = resolve_device(device)
    run.mkdir(parents=True, exist_ok=True)
    decoder = build_decoder(cfg, dev)
    load_teacher(cfg, decoder)
    teacher = dict(decoder.unets[0].named_parameters())
    dataset, splits = store_dataset(cfg)
    loader, _ = make_loaders(cfg, dataset, splits, dev)
    results, flush = results_file(run)
    as_dev = lambda a: torch.as_tensor(a).to(dev, non_blocking=True)  # noqa: E731
    batches = None

    def next_batch():
        nonlocal batches
        batches = _batches(loader) if batches is None else batches
        batch = next(batches)
        return as_dev(batch["videos"]), as_dev(batch["video_embeds"])

    try:
        emas, tr = run_phases(decoder, teacher, run, steps_per_phase, next_batch, results,
                              flush)
    finally:
        if batches is not None:
            batches.close()
    score_students(cfg, dataset, splits, emas, results, flush, dev)
    return {**results, "trainer": tr}


def distill_curve(curve_run: Path, run: Path, steps_per_phase: int,
                  device: DeviceLike = None) -> Dict[str, Any]:
    """scripts/distill_decoder.py on the curve teacher: unet 1 of
    ``<curve_run>/last``'s EMA cascade (``train/train_curve.py``, sampled in
    bf16 as ``train/eval_quality.py::build``) distilled through the phases
    on fresh blob batches (``CURVE_BATCH`` clips of 16 x 64^2 a step from
    RandomState(0): [0, 1] pictures, which the decoder maps by x 2 - 1
    itself), then scored against ``N_EVAL`` held-out blob clips
    (RandomState(123), eval_quality's reals) with the same extractor and
    anchor, so a student's row compares with the teacher's ladder point of
    its step count. Writes ``grid_student<last>.png`` beside
    ``results.json``."""
    from dalle2_video_tpu_torch.train.eval_quality import build, held_out, load_teacher
    from dalle2_video_tpu_torch.train.train_curve import blob_videos
    from dalle2_video_tpu_torch.utils.grid import save_grid

    dev = resolve_device(device)
    run.mkdir(parents=True, exist_ok=True)
    _, decoder = build(dev)
    load_teacher(decoder, curve_run)
    teacher = {k: v.detach().clone() for k, v in decoder.unets[0].named_parameters()}
    data_rng = np.random.RandomState(0)  # the training pool's stream
    results, flush = results_file(run)
    as_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731

    frames, size = decoder.config.frame_numbers[0], decoder.config.frame_sizes[0]

    def next_batch():
        vids, embs = blob_videos(data_rng, CURVE_BATCH, frames, size)
        return as_dev(vids), as_dev(embs)

    emas, tr = run_phases(decoder, teacher, run, steps_per_phase, next_batch, results, flush)
    reals, embeds = held_out(N_EVAL, frames=frames, size=size)
    results["score_space"] = "blob clips in [0, 1]; samples as the decoder returns them"
    fakes = score_phases(decoder, torch.from_numpy(reals), torch.from_numpy(embeds).to(dev),
                         emas, results, flush)
    if fakes is not None:
        save_grid(run / f"grid_student{PHASES[-1]}.png", fakes)
    return {**results, "trainer": tr}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run", default="runs/distill", help="the phases' checkpoint directory")
    ap.add_argument("--steps", type=int, default=400, help="distill steps per phase")
    ap.add_argument("--curve", default=None,
                    help="distill the curve teacher of this run directory on blob clips "
                         "(train/train_curve.py) in place of the decoder checkpoint and store")
    args, rest = ap.parse_known_args(argv)
    cfg = config_from_argv(rest)
    logging.basicConfig(level=cfg.get("log_level", "INFO"))
    if args.curve:
        return distill_curve(Path(args.curve), Path(args.run), args.steps, cfg.get("device"))
    return distill(cfg, Path(args.run), args.steps, cfg.get("device"))


if __name__ == "__main__":
    main()
