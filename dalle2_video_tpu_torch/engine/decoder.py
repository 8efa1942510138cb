"""VideoDecoder, the cascaded video diffusion model (port of
dalle2_video_tpu/engine/decoder.py): the training loss and the samplers.

Classifier-free guidance runs as ONE 2x-batched unet forward, as in the JAX
package. With ``sample_compute_dtype="bfloat16"`` the unets run in bf16 (a
bf16 copy of each unet is made at first use) while the diffusion math stays
float32. The loops are Python loops over the static DDIM/DDPM time grid.

Three samplers, as in the JAX package: DDPM (ancestral, every timestep),
DDIM and DPM-Solver++(2M) over the static DDIM time grid (``sampler``).
Each takes the conditioning of the JAX loops -- the video embed (per-frame
(b, k, d) embeds on a decoder built with ``per_frame_embeds=True``) and, on
a unet with ``cond_on_text_encodings``, the text encodings -- and their
request options: a negative video embed and negative text encodings as the
CFG baseline of their stream (``_unet_apply``), and inpainting
(``inpaint_video`` / ``inpaint_mask``, 1 = known) by replacement -- the
known region re-noised to q(x_t | x0) after every step, so the last step
returns it exactly -- or by reconstruction guidance (VDM eq. 7: the gradient of the known region's
x0 error through the unet, taken with ``torch.autograd.grad`` w.r.t. x
only). ``sample`` re-applies the constraint at every cascade stage at its
geometry and chunks the batch (``max_batch_size``) keeping each row's key.

Sampling randomness comes from ``RowKeys`` (one generator per row, see
utils/keys.py). Every loop also takes injected draws -- the initial noise
``init_noise``, for DDPM (and DDIM at eta > 0) the per-step noises
``step_noises``, and for inpainting the known region's noises
``known_noises`` -- so tests can feed the port and the JAX package the same
numbers. The training loss draws from a ``torch.Generator`` and takes every
draw injected the same way (``draws``: times, noise, video and text keep
masks, self-cond coin, blur coin, lowres noise levels and noise, the random
crop's offsets).

A stage runs in the latent space of its VAE (``VideoDecoder(config,
vaes=...)``, models/vae.py, models/vqvae.py) where the VAE ``is_latent``:
its unet's channels follow ``vae.encoded_dim``, the loss encodes the [0, 1]
video and the low-res conditioning after the resize and crop and does not
map them to [-1, 1], the samplers neither clip x0 nor unnormalise and end
with ``vae.decode``, sampling encodes the low-res conditioning, and
inpainting encodes the known video and min-pools the pixel mask to the
latent grid. ``predict_x_start_for_latent_diffusion`` predicts x0 on the
latent stages. The VAEs are frozen (no gradient; the trainer never
updates them) and run in float32.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from dalle2_video_tpu_torch.diffusion import (
    NAT,
    DiffusionSchedule,
    discretized_gaussian_log_likelihood,
    extract,
    normal_kl,
)
from dalle2_video_tpu_torch.engine.conditioner import (
    LowresConditionerConfig,
    lowres_condition,
    make_noise_schedule,
    noise_video,
)
from dalle2_video_tpu_torch.models.layers import CrossAttention, JointSpaceTimeAttention
from dalle2_video_tpu_torch.models.unet3d import UNet3D, UNet3DConfig
from dalle2_video_tpu_torch.models.unet_temporal import UnetTemporalConv
from dalle2_video_tpu_torch.models.vae import NullVAE
from dalle2_video_tpu_torch.ops.video import (
    paired_random_crop,
    resize_video,
    resize_video_time,
)
from dalle2_video_tpu_torch.utils.chunked import split_batch
from dalle2_video_tpu_torch.utils.device import DeviceLike, dtype_from_name, resolve_device
from dalle2_video_tpu_torch.utils.keys import RowKeys, batch_draw

SAMPLERS = ("ddim", "dpmpp")
INPAINT_METHODS = ("replace", "guided")


def ddim_time_pairs(total: int, timesteps: int):
    """Static descending DDIM (t_now, t_next) grid ending at t_next = -1."""
    times = np.linspace(-1, total - 1, timesteps + 1).astype(int)
    times = list(reversed(times.tolist()))
    return [(a, b) for a, b in zip(times[:-1], times[1:]) if a > b]


def dpmpp_coefficients(alphas_cumprod: np.ndarray, pairs) -> np.ndarray:
    """DPM-Solver++(2M)'s per-step coefficients over the (t_now, t_next)
    grid, on the host in float64 as the JAX loop computes them
    (decoder.py:1018-1034), then rounded to f32: rows (coef_x, coef_d, c2,
    a-bar at t_now, a-bar at t_next). First order (c2 = 0) on the first and
    the last step; at the terminal step lambda = +inf, so coef_x = 0 and
    coef_d = a_t = 1: the step returns its data prediction."""
    acp = np.concatenate([[1.0], np.asarray(alphas_cumprod, np.float64)])
    t_now = np.array([p[0] for p in pairs], np.int64)
    t_next = np.array([p[1] for p in pairs], np.int64)
    a_s, s_s = np.sqrt(acp[t_now + 1]), np.sqrt(1.0 - acp[t_now + 1])
    a_t, s_t = np.sqrt(acp[t_next + 1]), np.sqrt(1.0 - acp[t_next + 1])
    with np.errstate(divide="ignore", invalid="ignore"):
        lam_s = np.log(a_s / s_s)
        lam_t = np.log(a_t / s_t)
        h = lam_t - lam_s
        r = np.concatenate([[np.nan], h[:-1]]) / h
    first = np.zeros(len(pairs), bool)
    first[0] = first[-1] = True
    first |= ~np.isfinite(r)
    coef_x = np.where(np.isfinite(s_t / s_s), s_t / s_s, 0.0)
    coef_d = -a_t * np.expm1(-h)
    c2 = np.where(first, 0.0, 1.0 / (2.0 * np.where(first, 1.0, r)))
    return np.stack([coef_x, coef_d, c2, acp[t_now + 1], acp[t_next + 1]], 1).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Inpaint:
    """A stage's inpainting constraint in model space: the known video
    ``x0k`` (normalised), ``mask`` (f32, 1 = known, broadcastable to the
    sample), the method and the guidance weight."""

    x0k: torch.Tensor
    mask: torch.Tensor
    method: str = "replace"
    weight: float = 10.0

    def replace(self, x_next: torch.Tensor, acp_next: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        """The replacement step (VDM section 4, RePaint eq. 8): the known
        region overwritten with q(x_t | x0) = sqrt(a-bar) x0 + sqrt(1 -
        a-bar) eps at the level the sampler just produced; at the terminal
        step a-bar = 1 and it is the known video exactly."""
        known = self.x0k * torch.sqrt(acp_next) + torch.sqrt(1.0 - acp_next) * noise
        return self.mask * known + (1.0 - self.mask) * x_next


def build_unet(cfg: UNet3DConfig, per_frame_embeds: bool = False) -> nn.Module:
    """The denoiser a cascade slot's ``arch`` names (JAX decoder.py:248-253);
    ``per_frame_embeds`` as UNet3D's."""
    if cfg.arch == "temporal_conv":
        return UnetTemporalConv(cfg, per_frame_embeds)
    # the flag only where it is set: a stand-in for UNet3D that takes the
    # config alone (the meta-tensor site counts) builds a global decoder
    return UNet3D(cfg, per_frame_embeds=True) if per_frame_embeds else UNet3D(cfg)


def _cast_tuple(v, length: int):
    if isinstance(v, (tuple, list)):
        out = tuple(v)
        if len(out) != length:
            raise ValueError(f"expected {length} entries, got {v}")
        return out
    return (v,) * length


def _lowres_flag_tuple(v, n: int) -> Tuple:
    if isinstance(v, (tuple, list)):
        v = tuple(v)
        if len(v) == n:
            if v[0]:
                raise ValueError("lowres conditioning applies to SR unets only")
            v = v[1:]
        if len(v) != n - 1:
            raise ValueError(f"expected {n - 1} (or {n}) entries, got {v}")
        return v
    return (v,) * (n - 1)


@dataclasses.dataclass(frozen=True)
class VideoDecoderConfig:
    """Same fields and defaults as the JAX VideoDecoderConfig."""

    unets: Tuple[UNet3DConfig, ...]
    frame_sizes: Tuple[int, ...]
    frame_numbers: Tuple[int, ...]
    channels: int = 3
    timesteps: int = 1000
    sample_timesteps: Union[None, int, Tuple[Optional[int], ...]] = None
    video_cond_drop_prob: float = 0.1
    text_cond_drop_prob: float = 0.5
    loss_type: str = "l2"
    beta_schedule: Union[None, str, Tuple[str, ...]] = None
    predict_x_start: Union[bool, Tuple[bool, ...]] = False
    predict_x_start_for_latent_diffusion: bool = False
    predict_v: Union[bool, Tuple[bool, ...]] = False
    learned_variance: Union[bool, Tuple[bool, ...]] = True
    learned_variance_constrain_frac: bool = False
    vb_loss_weight: float = 0.001
    unconditional: bool = False
    auto_normalize_video: bool = True
    use_dynamic_thres: bool = False
    dynamic_thres_percentile: float = 0.95
    p2_loss_weight_gamma: Union[float, Tuple[float, ...]] = 0.0
    p2_loss_weight_k: float = 1.0
    ddim_sampling_eta: float = 0.0
    use_noise_for_lowres_cond: Union[bool, Tuple[bool, ...]] = False
    use_blur_for_lowres_cond: Union[bool, Tuple[bool, ...]] = True
    lowres_downsample_first: bool = True
    blur_prob: float = 0.5
    blur_sigma: float = 0.6
    blur_kernel_size: int = 3
    lowres_noise_sample_level: float = 0.2
    clip_denoised: bool = True
    random_crop_sizes: Union[None, int, Tuple[Optional[int], ...]] = None
    # sampling unets run their joint attention through the flash kernel
    flash_attention_sampling: bool = False
    # "bfloat16": bf16 denoiser at sample time; None = float32
    sample_compute_dtype: Optional[str] = None
    sampler: str = "ddim"
    cfg_rescale: float = 0.0

    @property
    def num_unets(self) -> int:
        return len(self.unets)


class VideoDecoder(nn.Module):
    """Holds the cascade's unets (float32 master weights), schedules and
    resolved per-stage knobs; samples on ``device`` (CUDA by default).
    ``per_frame_embeds`` builds the unets that take the video embed for
    per-frame (b, k, d) embeds, as the JAX ``init_params(per_frame_embeds=
    True)`` initialises them (DALLE2Video's temporal_emb mode). ``vaes``
    (one per stage; ``NullVAE`` by default) are held frozen beside the
    unets: a stage whose VAE ``is_latent`` runs in its latent space."""

    def __init__(self, config: VideoDecoderConfig, device: DeviceLike = None,
                 per_frame_embeds: bool = False, vaes: Optional[Sequence[nn.Module]] = None):
        super().__init__()
        cfg = config
        n = cfg.num_unets
        if not (n == len(cfg.frame_sizes) == len(cfg.frame_numbers)):
            raise ValueError("unets, frame_sizes and frame_numbers must align")
        if tuple(cfg.frame_sizes) != tuple(sorted(cfg.frame_sizes)):
            raise ValueError("frame_sizes must be ascending")
        if cfg.sampler not in SAMPLERS:
            raise ValueError(f"sampler {cfg.sampler!r} not in {SAMPLERS}")
        self.config = cfg
        self.device = resolve_device(device)
        self.compute_dtype = dtype_from_name(cfg.sample_compute_dtype)

        lv = cfg.learned_variance
        lv = (lv,) if isinstance(lv, bool) else tuple(lv)
        self.learned_variance = lv + (False,) * (n - len(lv))
        vaes = [NullVAE(cfg.channels) for _ in range(n)] if vaes is None else list(vaes)
        if len(vaes) != n:
            raise ValueError(f"{len(vaes)} VAEs for {n} unets")
        self.vaes = nn.ModuleList(vaes)
        self.vaes.to(self.device).eval().requires_grad_(False)
        if cfg.predict_x_start_for_latent_diffusion:
            self.predict_x_start = tuple(v.is_latent for v in self.vaes)
        else:
            self.predict_x_start = _cast_tuple(cfg.predict_x_start, n)
        self.predict_v = _cast_tuple(cfg.predict_v, n)
        self.sample_timesteps = _cast_tuple(cfg.sample_timesteps, n)

        unoise = _lowres_flag_tuple(cfg.use_noise_for_lowres_cond, n) if n > 1 else ()
        ublur = _lowres_flag_tuple(cfg.use_blur_for_lowres_cond, n) if n > 1 else ()
        self.use_noise_for_lowres = (False, *unoise)
        self.use_blur_for_lowres = (False, *ublur)

        self.random_crop_sizes = _cast_tuple(cfg.random_crop_sizes, n)
        if self.random_crop_sizes[0] is not None:
            raise ValueError("no random crop for the base unet")

        bs = cfg.beta_schedule
        if bs is None:
            bs = ("cosine", *("cosine",) * max(n - 2, 0), *("linear",) * int(n > 1))
        self.schedules = tuple(
            DiffusionSchedule.create(b, cfg.timesteps, device=self.device,
                                     loss_type=cfg.loss_type, p2_loss_weight_gamma=g,
                                     p2_loss_weight_k=cfg.p2_loss_weight_k)
            for b, g in zip(_cast_tuple(bs, n), _cast_tuple(cfg.p2_loss_weight_gamma, n))
        )

        self.unet_configs = tuple(
            ucfg.cast_for_cascade(
                lowres_cond=i > 0,
                lowres_noise_cond=self.use_noise_for_lowres[i],
                channels=self.vaes[i].encoded_dim,
                channels_out=self.vaes[i].encoded_dim * (2 if self.learned_variance[i] else 1),
                cond_on_video_embeds=not cfg.unconditional and i == 0,
                cond_on_text_encodings=not cfg.unconditional and ucfg.cond_on_text_encodings,
            )
            for i, ucfg in enumerate(cfg.unets)
        )
        self.per_frame_embeds = per_frame_embeds
        self.unets = nn.ModuleList(build_unet(c, per_frame_embeds) for c in self.unet_configs)
        self.unets.to(self.device).eval()
        self._sampling_unets: Dict[int, nn.Module] = {}

        self.lowres_configs = tuple(
            None if i == 0 else LowresConditionerConfig(
                downsample_first=cfg.lowres_downsample_first,
                use_blur=self.use_blur_for_lowres[i],
                blur_prob=cfg.blur_prob, blur_sigma=cfg.blur_sigma,
                blur_kernel_size=cfg.blur_kernel_size,
                use_noise=self.use_noise_for_lowres[i],
                input_video_range=(0.0, 1.0) if cfg.auto_normalize_video else (-1.0, 1.0),
                auto_normalize=cfg.auto_normalize_video,
            )
            for i in range(n)
        )
        self.lowres_noise_schedule = make_noise_schedule(self.device)
        self.can_classifier_guidance = (
            cfg.video_cond_drop_prob > 0.0 or cfg.text_cond_drop_prob > 0.0)
        self.condition_on_text_encodings = any(
            c.cond_on_text_encodings for c in self.unet_configs)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def load_sampling_params(self, stages: Sequence[Dict[str, torch.Tensor]]) -> None:
        """Load one state dict per stage (``DecoderTrainer.sampling_params``,
        ``load_decoder_sampling_params``): the unet's entries, and the VAE's
        under ``vae.<name>``; both strict."""
        if len(stages) != len(self.unets):
            raise ValueError(f"{len(stages)} stage states for {len(self.unets)} unets")
        for unet, vae, sd in zip(self.unets, self.vaes, stages):
            unet.load_state_dict({k: v for k, v in sd.items() if not k.startswith("vae.")},
                                 strict=True)
            vae.load_state_dict({k[4:]: v for k, v in sd.items() if k.startswith("vae.")},
                                strict=True)
        self._sampling_unets.clear()

    def sampling_unet(self, i: int) -> nn.Module:
        """The unet sampling runs: the master unet, or (bf16 compute and/or
        flash_attention_sampling) a copy of it made at the first sample --
        load weights before sampling."""
        unet = self._sampling_unets.get(i)
        if unet is None:
            unet = self.unets[i]
            if self.compute_dtype is not None or self.config.flash_attention_sampling:
                unet = copy.deepcopy(unet)
                if self.compute_dtype is not None:
                    unet.to(self.compute_dtype)
                if self.config.flash_attention_sampling:
                    for m in unet.modules():
                        if isinstance(m, JointSpaceTimeAttention):
                            m.impl = "flash"
            self._sampling_unets[i] = unet
        return unet

    def _normalize(self, x):
        return x * 2.0 - 1.0 if self.config.auto_normalize_video else x

    def _unnormalize(self, x):
        return (x + 1.0) * 0.5 if self.config.auto_normalize_video else x

    def dynamic_threshold(self, x: torch.Tensor) -> torch.Tensor:
        """Static clamp, or Imagen dynamic thresholding."""
        if not self.config.use_dynamic_thres:
            return x.clamp(-1.0, 1.0)
        b = x.shape[0]
        s = torch.quantile(x.reshape(b, -1).abs(), self.config.dynamic_thres_percentile, dim=-1)
        s = s.clamp_min(1.0).reshape((b,) + (1,) * (x.ndim - 1))
        return torch.maximum(torch.minimum(x, s), -s) / s

    def _unet_apply(self, i: int, x, t, *, cond_scale: float = 1.0,
                    video_embed=None, text_encodings=None, lowres_cond_video=None,
                    lowres_noise_level=None, self_cond=None,
                    negative_video_embed=None, negative_text_encodings=None,
                    params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """forward_with_cond_scale as ONE 2x-batched forward; returns f32.
        Under CFG the baseline half of each stream is its learned null
        embedding, or the ``negative_video_embed`` / ``negative_text_encodings``
        (broadcast from e.g. a leading dim of 1, kept) when one is given with
        its stream's conditioning: guided = neg + (cond - neg) * scale.
        ``params`` (the unet's parameters by name, as the JAX ``unet_params``)
        run through the sampling unet in place of its own, cast to the
        compute dtype (``torch.func.functional_call``: gradients reach them)."""
        unet = self.sampling_unet(i)
        cdt = self.compute_dtype
        castf = lambda a: None if a is None else a.to(cdt)
        if params is not None:
            own = unet
            cast = {k: castf(p) if cdt is not None and p.is_floating_point() else p
                    for k, p in params.items()}
            unet = lambda *a, **kw: torch.func.functional_call(own, cast, a, kw)  # noqa: E731
        if cdt is not None:
            x, video_embed = castf(x), castf(video_embed)
            lowres_cond_video, self_cond = castf(lowres_cond_video), castf(self_cond)
            negative_video_embed = castf(negative_video_embed)
            text_encodings = castf(text_encodings)
            negative_text_encodings = castf(negative_text_encodings)
        kw = dict(video_embed=video_embed, text_encodings=text_encodings,
                  lowres_cond_video=lowres_cond_video,
                  lowres_noise_level=lowres_noise_level, self_cond=self_cond)
        if cond_scale == 1.0:
            return unet(x, t, **kw).float()
        if not self.can_classifier_guidance:
            raise ValueError("decoder was not trained with conditional dropout: no CFG")
        b = x.shape[0]
        dup = lambda a: None if a is None else torch.cat([a, a], dim=0)
        kw2 = {k: dup(v) for k, v in kw.items()}
        keep = torch.cat([torch.ones(b, dtype=torch.bool, device=x.device),
                          torch.zeros(b, dtype=torch.bool, device=x.device)])
        keep_all = torch.ones(2 * b, dtype=torch.bool, device=x.device)
        keeps = {}
        for name, negative in (("video_embed", negative_video_embed),
                               ("text_encodings", negative_text_encodings)):
            keeps[name] = keep
            if negative is not None and kw[name] is not None:
                pos = kw[name]
                kw2[name] = torch.cat([pos, negative.to(pos.dtype).expand_as(pos)], dim=0)
                keeps[name] = keep_all
        out2 = unet(dup(x), dup(t), video_keep_mask=keeps["video_embed"],
                    text_keep_mask=keeps["text_encodings"], **kw2).float()
        logits, null_logits = out2[:b], out2[b:]
        guided = null_logits + (logits - null_logits) * cond_scale
        phi = self.config.cfg_rescale
        if phi > 0.0:
            c = x.shape[-1]
            pred_g, rest = guided[..., :c], guided[..., c:]
            axes = tuple(range(1, pred_g.ndim))
            std_c = logits[..., :c].std(dim=axes, keepdim=True, unbiased=False)
            std_g = pred_g.std(dim=axes, keepdim=True, unbiased=False)
            pred_out = phi * pred_g * (std_c / std_g.clamp_min(1e-8)) + (1.0 - phi) * pred_g
            guided = torch.cat([pred_out, rest], dim=-1) if rest.shape[-1] else pred_out
        return guided

    def _check_text(self, text_encodings) -> None:
        """Text encodings are required by a decoder with a unet that takes
        them, and refused by one without (JAX decoder.py:526-531)."""
        if self.condition_on_text_encodings and text_encodings is None:
            raise ValueError("text encodings must be passed in for text-conditioned decoder")
        if not self.condition_on_text_encodings and text_encodings is not None:
            raise ValueError("decoder not conditioned on text, but encodings were given")

    def _predict_x_start(self, i: int, x, t, pred):
        sched = self.schedules[i]
        if self.predict_v[i]:
            return sched.predict_start_from_v(x, t, pred)
        if self.predict_x_start[i]:
            return pred
        return sched.predict_start_from_noise(x, t, pred)

    def _split_output(self, i: int, out):
        if not self.learned_variance[i]:
            return out, None
        return out.chunk(2, dim=-1)

    def _p_mean_variance(self, i: int, x, t, *, clip_denoised: bool = True,
                         cond_scale: float = 1.0, model_output=None,
                         x_start_adjust: Optional[Callable] = None, **cond):
        sched = self.schedules[i]
        out = (self._unet_apply(i, x, t, cond_scale=cond_scale, **cond)
               if model_output is None else model_output)
        pred, var_frac = self._split_output(i, out)
        x_start = self._predict_x_start(i, x, t, pred)
        if x_start_adjust is not None:
            # reconstruction guidance's shift, before the clip
            x_start = x_start_adjust(x_start)
        if clip_denoised:
            x_start = self.dynamic_threshold(x_start)
        mean, var, log_var = sched.q_posterior(x_start, x, t)
        if self.learned_variance[i]:
            min_log = extract(sched.posterior_log_variance_clipped, t, x.ndim)
            max_log = extract(torch.log(sched.betas), t, x.ndim)
            frac = (var_frac + 1.0) * 0.5
            if self.config.learned_variance_constrain_frac:
                frac = torch.sigmoid(frac)
            log_var = frac * max_log + (1.0 - frac) * min_log
            var = torch.exp(log_var)
        return mean, var, log_var, x_start

    # ------------------------------------------------------------------ #
    # training loss (JAX decoder.py loss / _p_losses)
    # ------------------------------------------------------------------ #
    def loss(self, video: torch.Tensor, *, video_embed: Optional[torch.Tensor] = None,
             text_encodings: Optional[torch.Tensor] = None,
             unet_number: int = 1, compute_dtype: Optional[torch.dtype] = None,
             unet: Optional[Callable] = None,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """One denoising-loss evaluation for one cascade stage (1-indexed
        ``unet_number``), a 0-dim f32 tensor. ``video`` (b, T, H, W, C) in
        [0, 1] at least the stage's frame size. ``compute_dtype`` (bf16)
        runs the network in that dtype; the diffusion math stays f32.
        ``unet`` replaces the stage's module as the network to call (the
        trainer passes its bf16 functional call). ``text_encodings`` (b, n,
        d) are required where a unet conditions on them, refused where none
        does, and reach only a unet that does. ``draws`` injects any of
        "times", "noise", "video_keep", "text_keep", "self_cond", "blur",
        "lowres_noise_levels", "lowres_noise", "crop_offsets" (oh, ow); the
        rest come from ``generator``."""
        cfg = self.config
        i = unet_number - 1
        draws = draws or {}
        self._check_text(text_encodings)
        if video.shape[-1] != cfg.channels:
            raise ValueError(f"video has {video.shape[-1]} channels, not {cfg.channels}")
        size, frames = cfg.frame_sizes[i], cfg.frame_numbers[i]
        if video.shape[2] < size or video.shape[3] < size:
            raise ValueError(f"video {tuple(video.shape)} smaller than frame size {size}")
        video = video.to(self.device, torch.float32)
        b = video.shape[0]
        times = draws.get("times")
        if times is None:
            times = self.schedules[i].sample_random_times(b, generator)
        times = times.to(self.device, torch.long)

        lowres_video = lowres_level = None
        if self.lowres_configs[i] is not None:
            lowres_video, lowres_level = lowres_condition(
                video, self.lowres_configs[i], target_frame_size=size,
                downsample_frame_size=cfg.frame_sizes[i - 1],
                target_frame_number=frames,
                downsample_frame_number=cfg.frame_numbers[i - 1],
                noise_schedule=self.lowres_noise_schedule, generator=generator,
                blur=draws.get("blur"), noise_levels=draws.get("lowres_noise_levels"),
                noise=draws.get("lowres_noise"))

        video = resize_video_time(resize_video(video, size), frames)
        crop = self.random_crop_sizes[i]
        if crop is not None:
            # one window per sample, shared by the video and its low-res
            # conditioning video (JAX decoder.py loss)
            video, lowres_video = paired_random_crop(
                video, crop, lowres_video, generator=generator,
                offsets=draws.get("crop_offsets"))
        vae = self.vaes[i]
        if vae.is_latent:
            with torch.no_grad():
                video = vae.encode(video)
                if lowres_video is not None:
                    lowres_video = vae.encode(lowres_video)
        return self._p_losses(
            i, self.unets[i] if unet is None else unet, video, times,
            video_embed=video_embed,
            text_encodings=(text_encodings if self.unet_configs[i].cond_on_text_encodings
                            else None),
            lowres_cond_video=lowres_video,
            lowres_noise_level=lowres_level, is_latent=vae.is_latent,
            compute_dtype=compute_dtype, generator=generator, draws=draws)

    def _p_losses(self, i: int, unet: Callable, x_start, times, *, video_embed=None,
                  text_encodings=None, lowres_cond_video=None, lowres_noise_level=None,
                  is_latent: bool = False, compute_dtype=None, generator=None,
                  draws=None) -> torch.Tensor:
        cfg = self.config
        sched = self.schedules[i]
        b = x_start.shape[0]
        dev = x_start.device
        draws = draws or {}

        def draw(name, fn):
            v = draws.get(name)
            return fn() if v is None else torch.as_tensor(v).to(dev)

        noise = draw("noise", lambda: batch_draw(
            lambda s: torch.randn(s, generator=generator, device=dev), x_start.shape))
        if not is_latent:  # latents are already in model space
            x_start = self._normalize(x_start)
            if lowres_cond_video is not None:
                lowres_cond_video = self._normalize(lowres_cond_video)
        x_noisy = sched.q_sample(x_start, times, noise)
        keep = lambda prob: batch_draw(lambda s: torch.rand(  # noqa: E731
            s, generator=generator, device=dev), (b,)) < 1.0 - prob
        video_keep = draw("video_keep", lambda: keep(cfg.video_cond_drop_prob))
        # drawn only for a unet that takes text: a text-free unet's stream of
        # draws is the same with or without text elsewhere in the cascade
        text_keep = None if text_encodings is None else draw(
            "text_keep", lambda: keep(cfg.text_cond_drop_prob))

        # the network runs in compute_dtype; the diffusion math stays f32
        cast = (lambda a: a) if compute_dtype is None else (
            lambda a: None if a is None else a.to(compute_dtype))
        x_in = cast(x_noisy)
        kw = dict(video_embed=None if video_embed is None else cast(video_embed.to(dev)),
                  text_encodings=None if text_encodings is None else cast(text_encodings.to(dev)),
                  lowres_cond_video=cast(lowres_cond_video),
                  lowres_noise_level=lowres_noise_level)

        # self-conditioning: half of the steps condition on a detached x0
        # (or eps / v) estimate from an extra forward
        self_cond = None
        if self.unet_configs[i].self_cond:
            coin = draw("self_cond", lambda: torch.rand(
                (), generator=generator, device=dev) < 0.5)
            if bool(coin):
                with torch.no_grad():
                    ones = torch.ones(b, dtype=torch.bool, device=dev)
                    out = unet(x_in, times, video_keep_mask=ones, text_keep_mask=ones, **kw)
                self_cond = self._split_output(i, out.float())[0].detach()
            else:
                self_cond = torch.zeros_like(x_noisy)
            self_cond = cast(self_cond)

        out = unet(x_in, times, video_keep_mask=video_keep.bool(),
                   text_keep_mask=None if text_keep is None else text_keep.bool(),
                   self_cond=self_cond,
                   enable_checkpoint=True, **kw).float()
        pred, _ = self._split_output(i, out)
        if self.predict_v[i]:
            target = sched.calculate_v(x_start, times, noise)
        elif self.predict_x_start[i]:
            target = x_start
        else:
            target = noise
        loss = sched.loss_fn(pred, target).reshape(b, -1).mean(-1)
        loss = sched.p2_reweigh_loss(loss, times).mean()
        if not self.learned_variance[i]:
            return loss

        # Improved-DDPM VLB term with the model mean detached
        true_mean, _, true_log_var = sched.q_posterior(x_start, x_noisy, times)
        model_mean, _, model_log_var, _ = self._p_mean_variance(
            i, x_noisy, times, clip_denoised=False, model_output=out)
        mean_d = model_mean.detach()
        kl = normal_kl(true_mean, true_log_var, mean_d, model_log_var)
        kl = kl.reshape(b, -1).mean(-1) * NAT
        nll = -discretized_gaussian_log_likelihood(x_start, means=mean_d,
                                                   log_scales=0.5 * model_log_var)
        nll = nll.reshape(b, -1).mean(-1) * NAT
        vb = torch.where(times == 0, nll, kl)
        return loss + vb.mean() * cfg.vb_loss_weight

    # ------------------------------------------------------------------ #
    def _x0_of(self, i: int, x, t, *, cond_scale: float, self_cond, cond):
        """The unet's data prediction at x: (x0, the unet output)."""
        out = self._unet_apply(i, x, t, cond_scale=cond_scale, self_cond=self_cond, **cond)
        pred, _ = self._split_output(i, out)
        return self._predict_x_start(i, x, t, pred), out

    def _recon_grad(self, i: int, x, t, inpaint: Inpaint, **kw):
        """value_and_grad of sum(mask (x0 - x0k)^2) through the unet, w.r.t.
        x only (no parameter gradient, no graph kept past the step):
        (x0, the unet output, the gradient)."""
        with torch.enable_grad():
            xin = x.detach().requires_grad_(True)
            x0, out = self._x0_of(i, xin, t, **kw)
            err = (inpaint.mask * (x0 - inpaint.x0k) ** 2).sum()
            (g,) = torch.autograd.grad(err, xin)
        return x0.detach(), out.detach(), g

    def check_inpaint(self, inpaint_method: str, start_at_unet_number: int = 1,
                      stop_at_unet_number: Optional[int] = None) -> None:
        """Refuse an inpainting request before anything is sampled: an
        unknown method, or 'guided' where a stage that will run has
        cross_attention_impl 'flash'. Reconstruction guidance differentiates
        the sampling unet, and the tiny-context cross-attention kernel has no
        backward, as in the JAX package, whose grad through it fails; on the
        CPU its plain version would differentiate silently."""
        if inpaint_method not in INPAINT_METHODS:
            raise ValueError(f"inpaint_method {inpaint_method!r} not in {INPAINT_METHODS}")
        if inpaint_method != "guided":
            return
        for i in range(start_at_unet_number - 1, stop_at_unet_number or self.config.num_unets):
            if any(isinstance(m, CrossAttention) and m.impl == "flash"
                   for m in self.sampling_unet(i).modules()):
                raise ValueError(
                    f"inpaint_method 'guided' differentiates unet {i + 1}, whose "
                    "cross_attention_impl 'flash' is forward-only (no backward, as in "
                    "the JAX package); build the stack with cross_attention_impl: xla")

    def _draw(self, keys: RowKeys, k: int, shape, given):
        """Step k's noise: ``given[k]`` when injected, else from its key."""
        if given is None:
            return keys.fold_in(k).normal(shape, self.device)
        return given[k].to(self.device, torch.float32)

    def _start(self, keys: RowKeys, shape, init_noise, cond, is_latent: bool):
        """x_T and the conditioning (its low-res video normalised, but on a
        latent stage)."""
        x = (keys.normal(shape, self.device) if init_noise is None
             else init_noise.to(self.device, torch.float32))
        if cond.get("lowres_cond_video") is not None and not is_latent:
            cond["lowres_cond_video"] = self._normalize(cond["lowres_cond_video"])
        return x

    @torch.no_grad()
    def p_sample_loop_ddpm(self, i: int, keys: RowKeys, shape, *,
                           cond_scale: float = 1.0,
                           init_noise: Optional[torch.Tensor] = None,
                           step_noises: Optional[Sequence[torch.Tensor]] = None,
                           inpaint: Optional[Inpaint] = None,
                           known_noises: Optional[Sequence[torch.Tensor]] = None,
                           is_latent: bool = False, **cond) -> torch.Tensor:
        """Ancestral sampling over all timesteps. ``step_noises[k]`` and
        ``known_noises[k]`` are the k-th step's (t = T-1-k) noises."""
        sched = self.schedules[i]
        ucfg = self.unet_configs[i]
        b = shape[0]
        k_init, k_loop, k_known = keys.split(3)
        x = self._start(k_init, shape, init_noise, cond, is_latent)
        clip = self.config.clip_denoised and not is_latent
        acp_pad = torch.cat([torch.ones(1, device=self.device), sched.alphas_cumprod])
        x_start = torch.zeros_like(x)
        for k, ts in enumerate(range(sched.num_timesteps - 1, -1, -1)):
            t = torch.full((b,), ts, dtype=torch.long, device=self.device)
            kw = dict(cond_scale=cond_scale, self_cond=x_start if ucfg.self_cond else None)
            out = adjust = None
            if inpaint is not None and inpaint.method == "guided":
                _, out, g = self._recon_grad(i, x, t, inpaint, cond=cond, **kw)
                w = 0.5 * inpaint.weight * torch.sqrt(acp_pad[ts + 1])
                adjust = lambda xs: xs - w * g
            mean, _, log_var, x_start = self._p_mean_variance(
                i, x, t, clip_denoised=clip, model_output=out,
                x_start_adjust=adjust, **kw, **cond)
            if ts > 0:
                x = mean + torch.exp(0.5 * log_var) * self._draw(k_loop, k, shape, step_noises)
            else:
                x = mean
            if inpaint is not None:
                x = inpaint.replace(x, acp_pad[ts], self._draw(k_known, k, shape, known_noises))
        return x if is_latent else self._unnormalize(x)

    @torch.no_grad()
    def p_sample_loop_ddim(self, i: int, keys: RowKeys, shape, *, timesteps: int,
                           cond_scale: float = 1.0,
                           init_noise: Optional[torch.Tensor] = None,
                           step_noises: Optional[Sequence[torch.Tensor]] = None,
                           inpaint: Optional[Inpaint] = None,
                           known_noises: Optional[Sequence[torch.Tensor]] = None,
                           is_latent: bool = False, **cond) -> torch.Tensor:
        """DDIM over ddim_time_pairs; eta = config.ddim_sampling_eta (at
        eta 0 the loop is deterministic once x_T is fixed, inpainting by
        replacement apart)."""
        sched = self.schedules[i]
        ucfg = self.unet_configs[i]
        eta = self.config.ddim_sampling_eta
        b = shape[0]
        k_init, k_loop, k_known = keys.split(3)
        x = self._start(k_init, shape, init_noise, cond, is_latent)
        clip = self.config.clip_denoised and not is_latent
        acp_pad = torch.cat([torch.ones(1, device=self.device), sched.alphas_cumprod])
        x_start = torch.zeros_like(x)
        for k, (t_now, t_next) in enumerate(ddim_time_pairs(sched.num_timesteps, timesteps)):
            t = torch.full((b,), t_now, dtype=torch.long, device=self.device)
            kw = dict(cond_scale=cond_scale, self_cond=x_start if ucfg.self_cond else None)
            if inpaint is not None and inpaint.method == "guided":
                x_start, _, g = self._recon_grad(i, x, t, inpaint, cond=cond, **kw)
                x_start = x_start - (0.5 * inpaint.weight * torch.sqrt(acp_pad[t_now + 1])) * g
            else:
                x_start, _ = self._x0_of(i, x, t, cond=cond, **kw)
            if clip:
                x_start = self.dynamic_threshold(x_start)
            pred_noise = sched.predict_noise_from_start(x, t, x_start)
            alpha, alpha_next = acp_pad[t_now + 1], acp_pad[t_next + 1]
            c1 = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
            c2 = torch.sqrt(torch.clamp((1 - alpha_next) - c1**2, min=0.0))
            x = x_start * torch.sqrt(alpha_next) + c2 * pred_noise
            if eta > 0 and t_next >= 0:
                x = x + c1 * self._draw(k_loop, k, shape, step_noises)
            if inpaint is not None:
                x = inpaint.replace(x, alpha_next, self._draw(k_known, k, shape, known_noises))
        return x if is_latent else self._unnormalize(x)

    @torch.no_grad()
    def p_sample_loop_dpmpp(self, i: int, keys: RowKeys, shape, *, timesteps: int,
                            cond_scale: float = 1.0,
                            init_noise: Optional[torch.Tensor] = None,
                            inpaint: Optional[Inpaint] = None,
                            known_noises: Optional[Sequence[torch.Tensor]] = None,
                            is_latent: bool = False, **cond) -> torch.Tensor:
        """DPM-Solver++(2M) over ddim_time_pairs (JAX decoder.py:981-1095):
        per step s -> t, with lambda = log(alpha / sigma), h = lambda_t -
        lambda_s, r = h_prev / h and x0 the data prediction,
        D = (1 + 1/(2r)) x0_s - 1/(2r) x0_prev and x_t = (sigma_t / sigma_s)
        x_s - alpha_t expm1(-h) D; coefficients from ``dpmpp_coefficients``.
        Deterministic once x_T is fixed (inpainting by replacement apart)."""
        sched = self.schedules[i]
        ucfg = self.unet_configs[i]
        b = shape[0]
        pairs = ddim_time_pairs(sched.num_timesteps, timesteps)
        coefs = torch.from_numpy(dpmpp_coefficients(
            sched.alphas_cumprod.cpu().numpy(), pairs)).to(self.device)
        k_init, _, k_known = keys.split(3)
        x = self._start(k_init, shape, init_noise, cond, is_latent)
        clip = self.config.clip_denoised and not is_latent
        x0_prev = torch.zeros_like(x)
        for k, (t_now, _) in enumerate(pairs):
            cx, cd, c2, acp_now, acp_next = coefs[k]
            t = torch.full((b,), t_now, dtype=torch.long, device=self.device)
            kw = dict(cond_scale=cond_scale, self_cond=x0_prev if ucfg.self_cond else None)
            if inpaint is not None and inpaint.method == "guided":
                x0, _, g = self._recon_grad(i, x, t, inpaint, cond=cond, **kw)
                x0 = x0 - (0.5 * inpaint.weight * torch.sqrt(acp_now)) * g
            else:
                x0, _ = self._x0_of(i, x, t, cond=cond, **kw)
            if clip:
                x0 = self.dynamic_threshold(x0)
            d = (1.0 + c2) * x0 - c2 * x0_prev
            x = cx * x + cd * d
            if inpaint is not None:
                x = inpaint.replace(x, acp_next, self._draw(k_known, k, shape, known_noises))
            x0_prev = x0
        return x if is_latent else self._unnormalize(x)

    # ------------------------------------------------------------------ #
    def sample_stage(self, i: int, keys: RowKeys, *, batch_size: int,
                     prev_video: Optional[torch.Tensor] = None,
                     video_embed: Optional[torch.Tensor] = None,
                     text_encodings: Optional[torch.Tensor] = None,
                     cond_scale: float = 1.0,
                     sample_timesteps: Optional[int] = None,
                     inpaint_video: Optional[torch.Tensor] = None,
                     inpaint_mask: Optional[torch.Tensor] = None,
                     inpaint_method: str = "replace",
                     inpaint_guidance_weight: float = 10.0,
                     negative_video_embed: Optional[torch.Tensor] = None,
                     negative_text_encodings: Optional[torch.Tensor] = None,
                     init_noise: Optional[torch.Tensor] = None,
                     step_noises: Optional[Sequence[torch.Tensor]] = None,
                     known_noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """One cascade stage -> video in [0, 1], (b, T_i, S_i, S_i, C).
        ``sample_timesteps`` overrides the configured step count: below the
        training timesteps the few-step sampler (``config.sampler``: DDIM or
        DPM++), else DDPM. ``inpaint_video`` ([0, 1], any (b, T, H, W, C))
        and ``inpaint_mask`` (1 = known, broadcastable over (b, T, H, W, 1))
        are resized nearest to this stage's geometry; ``negative_video_embed``
        replaces the CFG baseline of a stage conditioned on the embed, and
        ``negative_text_encodings`` that of a stage conditioned on the text
        encodings (``text_encodings`` reach only such a stage). A latent
        stage samples its VAE's latents and returns their decoding."""
        cfg = self.config
        ucfg = self.unet_configs[i]
        vae = self.vaes[i]
        size, frames = cfg.frame_sizes[i], cfg.frame_numbers[i]
        k_lowres, k_loop = keys.split()
        cond: Dict[str, torch.Tensor] = {}
        if ucfg.cond_on_video_embeds:
            cond["video_embed"] = video_embed
            if negative_video_embed is not None:
                cond["negative_video_embed"] = negative_video_embed
        if ucfg.cond_on_text_encodings:
            cond["text_encodings"] = text_encodings
            if negative_text_encodings is not None:
                cond["negative_text_encodings"] = negative_text_encodings
        if ucfg.lowres_cond:
            if prev_video is None:
                raise ValueError("an SR stage needs the previous stage's video")
            lowres = resize_video(prev_video, size, clamp_range=(0.0, 1.0))
            lowres = resize_video_time(lowres, frames)
            if self.use_noise_for_lowres[i]:
                level = torch.full((batch_size,), int(cfg.lowres_noise_sample_level * 1000),
                                   dtype=torch.long, device=self.device)
                lowres, _ = noise_video(k_lowres, lowres, self.lowres_noise_schedule,
                                        self.lowres_configs[i], level)
                cond["lowres_noise_level"] = level
            cond["lowres_cond_video"] = lowres
        latent = vae.get_encoded_fmap_size(size)
        shape = (batch_size, frames, latent, latent, vae.encoded_dim)
        if vae.is_latent and cond.get("lowres_cond_video") is not None:
            cond["lowres_cond_video"] = vae.encode(cond["lowres_cond_video"])
        loop_kw: Dict[str, Any] = dict(cond_scale=cond_scale, init_noise=init_noise,
                                       is_latent=vae.is_latent)
        if inpaint_video is not None:
            if inpaint_mask is None:
                raise ValueError("inpaint_video requires inpaint_mask")
            self.check_inpaint(inpaint_method, i + 1, i + 1)
            inpaint_video = inpaint_video.to(self.device, torch.float32)
            known = resize_video_time(
                resize_video(inpaint_video, size, clamp_range=(0.0, 1.0)), frames)
            mask = torch.as_tensor(inpaint_mask, dtype=torch.float32, device=self.device)
            mask = mask.expand(*inpaint_video.shape[:4], 1)
            mask = resize_video_time(resize_video(mask, size), frames)
            if vae.is_latent:
                # model space is the latent grid: the known video encoded, and
                # a latent cell known only where its whole f x f pixel patch
                # is (a spatial min-pool); latents are not normalised again
                f = size // latent
                if f * latent != size:
                    raise ValueError(f"frame size {size} is not a multiple of latent {latent}")
                known = vae.encode(known)
                b_, t_ = mask.shape[:2]
                mask = mask.reshape(b_, t_, latent, f, latent, f, 1).amin(dim=(3, 5))
            else:
                known = self._normalize(known)
            loop_kw.update(inpaint=Inpaint(known, mask, inpaint_method,
                                           float(inpaint_guidance_weight)),
                           known_noises=known_noises)
        st = self.sample_timesteps[i] if sample_timesteps is None else sample_timesteps
        if st is not None and st < cfg.timesteps:
            if cfg.sampler == "dpmpp":
                vid = self.p_sample_loop_dpmpp(i, k_loop, shape, timesteps=st,
                                               **loop_kw, **cond)
            else:
                vid = self.p_sample_loop_ddim(i, k_loop, shape, timesteps=st,
                                              step_noises=step_noises, **loop_kw, **cond)
        else:
            vid = self.p_sample_loop_ddpm(i, k_loop, shape, step_noises=step_noises,
                                          **loop_kw, **cond)
        return vae.decode(vid)

    @torch.no_grad()
    def sample(self, keys: RowKeys, *, video_embed: Optional[torch.Tensor] = None,
               text_encodings: Optional[torch.Tensor] = None,
               batch_size: int = 1,
               cond_scale: Union[float, Tuple[float, ...]] = 1.0,
               start_at_unet_number: int = 1,
               stop_at_unet_number: Optional[int] = None,
               video: Optional[torch.Tensor] = None,
               max_batch_size: Optional[int] = None,
               sample_timesteps: Union[None, int, Tuple[Optional[int], ...]] = None,
               inpaint_video: Optional[torch.Tensor] = None,
               inpaint_mask: Optional[torch.Tensor] = None,
               inpaint_method: str = "replace",
               inpaint_guidance_weight: float = 10.0,
               negative_video_embed: Optional[torch.Tensor] = None,
               negative_text_encodings: Optional[torch.Tensor] = None,
               init_noises: Optional[Sequence[Optional[torch.Tensor]]] = None,
               known_noises: Optional[Sequence[Optional[Sequence[torch.Tensor]]]] = None
               ) -> torch.Tensor:
        """Full cascade. ``keys`` holds one key per row, so each row's video
        depends on its own key only, whatever the batch or chunking.
        The inpainting constraint is re-applied at every stage at its
        geometry; a mask, a negative embed or negative text encodings of
        leading dim 1 are shared by every row and every chunk.
        ``init_noises[i]`` / ``known_noises[i]`` (optional) are stage i's x_T
        and known-region noises."""
        cfg = self.config
        n = cfg.num_unets
        if not cfg.unconditional:
            if video_embed is None:
                raise ValueError("a conditional decoder needs video_embed")
            batch_size = video_embed.shape[0]
        if len(keys) != batch_size:
            raise ValueError(f"{len(keys)} row keys for a batch of {batch_size}")
        if inpaint_video is not None:
            self.check_inpaint(inpaint_method, start_at_unet_number, stop_at_unet_number)
        if max_batch_size is not None and batch_size > max_batch_size:
            outs = []
            for s, sz in split_batch(batch_size, max_batch_size):
                take = lambda a: None if a is None else a[s:s + sz]
                # a broadcastable mask or negative (leading dim 1) is shared
                take_shared = lambda a: (a if a is None or a.ndim == 0 or a.shape[0] == 1
                                         else a[s:s + sz])
                outs.append(self.sample(
                    keys.take(s, sz), video_embed=take(video_embed),
                    text_encodings=take(text_encodings), batch_size=sz,
                    cond_scale=cond_scale, start_at_unet_number=start_at_unet_number,
                    stop_at_unet_number=stop_at_unet_number, video=take(video),
                    sample_timesteps=sample_timesteps,
                    inpaint_video=take(inpaint_video),
                    inpaint_mask=take_shared(inpaint_mask), inpaint_method=inpaint_method,
                    inpaint_guidance_weight=inpaint_guidance_weight,
                    negative_video_embed=take_shared(negative_video_embed),
                    negative_text_encodings=take_shared(negative_text_encodings),
                    init_noises=None if init_noises is None
                    else [take(z) for z in init_noises],
                    known_noises=None if known_noises is None
                    else [None if zs is None else [take(z) for z in zs]
                          for zs in known_noises],
                ))
            return torch.cat(outs, dim=0)

        self._check_text(text_encodings)
        cond_scales = _cast_tuple(cond_scale, n)
        steps = _cast_tuple(sample_timesteps, n)
        on_device = lambda a: None if a is None else a.to(self.device, torch.float32)
        video_embed, negative_video_embed = on_device(video_embed), on_device(negative_video_embed)
        text_encodings = on_device(text_encodings)
        negative_text_encodings = on_device(negative_text_encodings)
        vid = None
        if start_at_unet_number > 1:
            if video is None:
                raise ValueError("video required when starting mid-cascade")
            vid = resize_video(video.to(self.device), cfg.frame_sizes[start_at_unet_number - 2])
        stage_keys = keys.split(n)
        for i in range(n):
            if (i + 1) < start_at_unet_number:
                continue
            vid = self.sample_stage(
                i, stage_keys[i], batch_size=batch_size, prev_video=vid,
                video_embed=video_embed, text_encodings=text_encodings,
                cond_scale=cond_scales[i], sample_timesteps=steps[i],
                inpaint_video=inpaint_video, inpaint_mask=inpaint_mask,
                inpaint_method=inpaint_method,
                inpaint_guidance_weight=inpaint_guidance_weight,
                negative_video_embed=negative_video_embed,
                negative_text_encodings=negative_text_encodings,
                init_noise=None if init_noises is None else init_noises[i],
                known_noises=None if known_noises is None else known_noises[i],
            )
            if stop_at_unet_number is not None and stop_at_unet_number == i + 1:
                break
        return vid


def cascade_sr_overrides() -> List[str]:
    """The overrides laid over configs/cascade_sr.yaml to give the JAX
    package's cascade recipe (scripts/bench_all.py::_cascade_decoder): flash
    attention in the SR unet (``auto``: from 4096 joint tokens), DDIM 64 on
    both stages, flash attention and bf16 unets when sampling.
    ``load_config("configs/cascade_sr.yaml", cascade_sr_overrides())``."""
    return ["unet2.attention_impl=auto", "sample_timesteps=[64,64]",
            "flash_attention_sampling=true", "sample_compute_dtype=bfloat16"]


# scripts/train_latent90.py's recipe: a frozen VQGAN-VAE (f 4, latent 4)
# encodes 90 x 128^2 x 3 pixels to 90 x 32^2 x 4 latents, and this unet
# denoises them (its joint bottleneck 90 x 8 x 8 = 5,760 tokens)
LATENT90_UNET = dict(dim=64, dim_mults=(1, 2, 4), video_embed_dim=512, num_resnet_blocks=2,
                     attn_heads=8, attn_dim_head=32)
LATENT90_FRAMES, LATENT90_SIZE = 90, 128


def latent90_decoder(vae: nn.Module, device: DeviceLike = None, **unet_knobs) -> VideoDecoder:
    """scripts/train_latent90.py's decoder: one stage of 90 frames at 128
    px in the latent space of ``vae``, ``predict_x_start_for_latent_
    diffusion``, 1000 timesteps, DDIM 64, bf16 sampling; ``unet_knobs``
    are the unet's kernel settings (``attention_impl``, ``groupnorm_impl``,
    ``cross_attention_impl``)."""
    return VideoDecoder(
        VideoDecoderConfig(
            unets=(UNet3DConfig(**LATENT90_UNET, **unet_knobs),),
            frame_sizes=(LATENT90_SIZE,), frame_numbers=(LATENT90_FRAMES,),
            timesteps=1000, sample_timesteps=64, learned_variance=False,
            predict_x_start_for_latent_diffusion=True, sample_compute_dtype="bfloat16"),
        device=device, vaes=(vae,))


def build_decoder(cfg: Dict, device: DeviceLike = None) -> VideoDecoder:
    """The cascade from the single-plane config (same keys as
    scripts/train_decoder.py's build_decoder, including the training knobs
    ``memory_efficient``, ``checkpoint_during_training`` and
    ``remat_policy``), the sampling knobs ``sampler`` (``ddim`` |
    ``dpmpp``), ``cfg_rescale`` and ``sample_compute_dtype``, plus the
    kernel knobs ``unetN.groupnorm_impl`` (``pallas`` | ``fused``, or the
    plain ``xla`` | ``skip``), ``unetN.spatial_conv_impl``
    (``pallas_small``), ``unetN.cross_attention_impl`` (``flash``, or the
    plain ``xla`` | ``broadcast``) and ``flash_attention_sampling``."""

    def unet_cfg(section):
        return UNet3DConfig(
            dim=section["dim"],
            dim_mults=tuple(section["dim_mults"]),
            num_resnet_blocks=section.get("num_resnet_blocks", 2),
            attn_heads=section.get("attn_heads", 16),
            attn_dim_head=section.get("attn_dim_head", 32),
            attention_impl=section.get("attention_impl", "xla"),
            groupnorm_impl=section.get("groupnorm_impl", "xla"),
            spatial_conv_impl=section.get("spatial_conv_impl", "xla"),
            cross_attention_impl=section.get("cross_attention_impl", "xla"),
            memory_efficient=section.get("memory_efficient", False),
            checkpoint_during_training=section.get("checkpoint_during_training", False),
            remat_policy=section.get("remat_policy", "nothing"),
            video_embed_dim=cfg["dim"],
            channels=cfg["channels"],
        )

    return VideoDecoder(
        VideoDecoderConfig(
            unets=(unet_cfg(cfg["unet1"]), unet_cfg(cfg["unet2"])),
            frame_sizes=tuple(cfg["frame_sizes"]),
            frame_numbers=tuple(cfg["frame_numbers"]),
            channels=cfg["channels"],
            timesteps=cfg["timesteps"],
            sample_timesteps=cfg.get("sample_timesteps"),
            learned_variance=cfg.get("learned_variance", False),
            sample_compute_dtype=cfg.get("sample_compute_dtype"),
            sampler=cfg.get("sampler", "ddim"),
            cfg_rescale=float(cfg.get("cfg_rescale", 0.0)),
            flash_attention_sampling=bool(cfg.get("flash_attention_sampling", False)),
        ),
        device=device,
    )
