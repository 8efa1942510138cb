"""VideoDecoder, the cascaded video diffusion model (port of
dalle2_video_tpu/engine/decoder.py): the training loss and the samplers.

Classifier-free guidance runs as ONE 2x-batched unet forward, as in the JAX
package. With ``sample_compute_dtype="bfloat16"`` the unets run in bf16 (a
bf16 copy of each unet is made at first use) while the diffusion math stays
float32. The loops are Python loops over the static DDIM/DDPM time grid.

Sampling randomness comes from ``RowKeys`` (one generator per row, see
utils/keys.py). Every loop also takes injected draws -- the initial noise
``init_noise`` and, for DDPM, the per-step noises -- so tests can feed the
port and the JAX package the same numbers. The training loss draws from a
``torch.Generator`` and takes every draw injected the same way (``draws``:
times, noise, video keep mask, self-cond coin, blur coin, lowres noise
levels and noise).

Not ported yet: DPM++, inpainting, negative prompts, latent (VAE) stages,
random crops, text-encoding conditioning (so no text keep mask) and long
video.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

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
from dalle2_video_tpu_torch.models.layers import JointSpaceTimeAttention
from dalle2_video_tpu_torch.models.unet3d import UNet3D, UNet3DConfig
from dalle2_video_tpu_torch.ops.video import resize_video, resize_video_time
from dalle2_video_tpu_torch.utils.device import DeviceLike, dtype_from_name, resolve_device
from dalle2_video_tpu_torch.utils.keys import RowKeys


def ddim_time_pairs(total: int, timesteps: int):
    """Static descending DDIM (t_now, t_next) grid ending at t_next = -1."""
    times = np.linspace(-1, total - 1, timesteps + 1).astype(int)
    times = list(reversed(times.tolist()))
    return [(a, b) for a, b in zip(times[:-1], times[1:]) if a > b]


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
    resolved per-stage knobs; samples on ``device`` (CUDA by default)."""

    def __init__(self, config: VideoDecoderConfig, device: DeviceLike = None):
        super().__init__()
        cfg = config
        n = cfg.num_unets
        if not (n == len(cfg.frame_sizes) == len(cfg.frame_numbers)):
            raise ValueError("unets, frame_sizes and frame_numbers must align")
        if tuple(cfg.frame_sizes) != tuple(sorted(cfg.frame_sizes)):
            raise ValueError("frame_sizes must be ascending")
        if cfg.sampler != "ddim":
            raise NotImplementedError(f"sampler {cfg.sampler!r} is not ported yet")
        self.config = cfg
        self.device = resolve_device(device)
        self.compute_dtype = dtype_from_name(cfg.sample_compute_dtype)

        lv = cfg.learned_variance
        lv = (lv,) if isinstance(lv, bool) else tuple(lv)
        self.learned_variance = lv + (False,) * (n - len(lv))
        if cfg.predict_x_start_for_latent_diffusion:
            raise NotImplementedError("latent diffusion stages are not ported yet")
        self.predict_x_start = _cast_tuple(cfg.predict_x_start, n)
        self.predict_v = _cast_tuple(cfg.predict_v, n)
        self.sample_timesteps = _cast_tuple(cfg.sample_timesteps, n)

        unoise = _lowres_flag_tuple(cfg.use_noise_for_lowres_cond, n) if n > 1 else ()
        ublur = _lowres_flag_tuple(cfg.use_blur_for_lowres_cond, n) if n > 1 else ()
        self.use_noise_for_lowres = (False, *unoise)
        self.use_blur_for_lowres = (False, *ublur)

        self.random_crop_sizes = _cast_tuple(cfg.random_crop_sizes, n)

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
                channels=cfg.channels,
                channels_out=cfg.channels * (2 if self.learned_variance[i] else 1),
                cond_on_video_embeds=not cfg.unconditional and i == 0,
                cond_on_text_encodings=not cfg.unconditional and ucfg.cond_on_text_encodings,
            )
            for i, ucfg in enumerate(cfg.unets)
        )
        self.unets = nn.ModuleList(UNet3D(c) for c in self.unet_configs)
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

    # ------------------------------------------------------------------ #
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
                    video_embed=None, lowres_cond_video=None,
                    lowres_noise_level=None, self_cond=None) -> torch.Tensor:
        """forward_with_cond_scale as ONE 2x-batched forward; returns f32."""
        unet = self.sampling_unet(i)
        cdt = self.compute_dtype
        castf = lambda a: None if a is None else a.to(cdt)
        if cdt is not None:
            x, video_embed = castf(x), castf(video_embed)
            lowres_cond_video, self_cond = castf(lowres_cond_video), castf(self_cond)
        kw = dict(video_embed=video_embed, lowres_cond_video=lowres_cond_video,
                  lowres_noise_level=lowres_noise_level, self_cond=self_cond)
        if cond_scale == 1.0:
            return unet(x, t, **kw).float()
        if not self.can_classifier_guidance:
            raise ValueError("decoder was not trained with conditional dropout: no CFG")
        b = x.shape[0]
        dup = lambda a: None if a is None else torch.cat([a, a], dim=0)
        keep = torch.cat([torch.ones(b, dtype=torch.bool, device=x.device),
                          torch.zeros(b, dtype=torch.bool, device=x.device)])
        out2 = unet(dup(x), dup(t), video_keep_mask=keep,
                    **{k: dup(v) for k, v in kw.items()}).float()
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
                         cond_scale: float = 1.0, model_output=None, **cond):
        sched = self.schedules[i]
        out = (self._unet_apply(i, x, t, cond_scale=cond_scale, **cond)
               if model_output is None else model_output)
        pred, var_frac = self._split_output(i, out)
        x_start = self._predict_x_start(i, x, t, pred)
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
             unet_number: int = 1, compute_dtype: Optional[torch.dtype] = None,
             unet: Optional[Callable] = None,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """One denoising-loss evaluation for one cascade stage (1-indexed
        ``unet_number``), a 0-dim f32 tensor. ``video`` (b, T, H, W, C) in
        [0, 1] at least the stage's frame size. ``compute_dtype`` (bf16)
        runs the network in that dtype; the diffusion math stays f32.
        ``unet`` replaces the stage's module as the network to call (the
        trainer passes its bf16 functional call). ``draws`` injects any of
        "times", "noise", "video_keep", "self_cond", "blur",
        "lowres_noise_levels", "lowres_noise"; the rest come from
        ``generator``."""
        cfg = self.config
        i = unet_number - 1
        draws = draws or {}
        if video.shape[-1] != cfg.channels:
            raise ValueError(f"video has {video.shape[-1]} channels, not {cfg.channels}")
        size, frames = cfg.frame_sizes[i], cfg.frame_numbers[i]
        if video.shape[2] < size or video.shape[3] < size:
            raise ValueError(f"video {tuple(video.shape)} smaller than frame size {size}")
        if self.random_crop_sizes[i] is not None:
            raise NotImplementedError("random crops are not ported yet")
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
        return self._p_losses(
            i, self.unets[i] if unet is None else unet, video, times,
            video_embed=video_embed, lowres_cond_video=lowres_video,
            lowres_noise_level=lowres_level, compute_dtype=compute_dtype,
            generator=generator, draws=draws)

    def _p_losses(self, i: int, unet: Callable, x_start, times, *, video_embed=None,
                  lowres_cond_video=None, lowres_noise_level=None, compute_dtype=None,
                  generator=None, draws=None) -> torch.Tensor:
        cfg = self.config
        sched = self.schedules[i]
        b = x_start.shape[0]
        dev = x_start.device
        draws = draws or {}

        def draw(name, fn):
            v = draws.get(name)
            return fn() if v is None else torch.as_tensor(v).to(dev)

        noise = draw("noise", lambda: torch.randn(x_start.shape, generator=generator,
                                                  device=dev))
        x_start = self._normalize(x_start)
        if lowres_cond_video is not None:
            lowres_cond_video = self._normalize(lowres_cond_video)
        x_noisy = sched.q_sample(x_start, times, noise)
        video_keep = draw("video_keep", lambda: torch.rand(
            b, generator=generator, device=dev) < 1.0 - cfg.video_cond_drop_prob)

        # the network runs in compute_dtype; the diffusion math stays f32
        cast = (lambda a: a) if compute_dtype is None else (
            lambda a: None if a is None else a.to(compute_dtype))
        x_in = cast(x_noisy)
        kw = dict(video_embed=None if video_embed is None else cast(video_embed.to(dev)),
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
                    out = unet(x_in, times, video_keep_mask=torch.ones(
                        b, dtype=torch.bool, device=dev), **kw)
                self_cond = self._split_output(i, out.float())[0].detach()
            else:
                self_cond = torch.zeros_like(x_noisy)
            self_cond = cast(self_cond)

        out = unet(x_in, times, video_keep_mask=video_keep.bool(), self_cond=self_cond,
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
    @torch.no_grad()
    def p_sample_loop_ddpm(self, i: int, keys: RowKeys, shape, *,
                           cond_scale: float = 1.0,
                           init_noise: Optional[torch.Tensor] = None,
                           step_noises: Optional[Sequence[torch.Tensor]] = None,
                           **cond) -> torch.Tensor:
        """Ancestral sampling over all timesteps. ``step_noises[k]`` is the
        noise of the k-th step (t = T-1-k)."""
        sched = self.schedules[i]
        ucfg = self.unet_configs[i]
        b = shape[0]
        k_init, k_loop = keys.split()
        x = (k_init.normal(shape, self.device) if init_noise is None
             else init_noise.to(self.device, torch.float32))
        if cond.get("lowres_cond_video") is not None:
            cond["lowres_cond_video"] = self._normalize(cond["lowres_cond_video"])
        x_start = torch.zeros_like(x)
        for k, ts in enumerate(range(sched.num_timesteps - 1, -1, -1)):
            t = torch.full((b,), ts, dtype=torch.long, device=self.device)
            mean, _, log_var, x_start = self._p_mean_variance(
                i, x, t, clip_denoised=self.config.clip_denoised,
                cond_scale=cond_scale,
                self_cond=x_start if ucfg.self_cond else None, **cond)
            if ts > 0:
                noise = (k_loop.fold_in(k).normal(shape, self.device)
                         if step_noises is None else step_noises[k].to(self.device))
                x = mean + torch.exp(0.5 * log_var) * noise
            else:
                x = mean
        return self._unnormalize(x)

    @torch.no_grad()
    def p_sample_loop_ddim(self, i: int, keys: RowKeys, shape, *, timesteps: int,
                           cond_scale: float = 1.0,
                           init_noise: Optional[torch.Tensor] = None,
                           step_noises: Optional[Sequence[torch.Tensor]] = None,
                           **cond) -> torch.Tensor:
        """DDIM over ddim_time_pairs; eta = config.ddim_sampling_eta (at
        eta 0 the loop is deterministic once x_T is fixed)."""
        sched = self.schedules[i]
        ucfg = self.unet_configs[i]
        eta = self.config.ddim_sampling_eta
        b = shape[0]
        k_init, k_loop = keys.split()
        x = (k_init.normal(shape, self.device) if init_noise is None
             else init_noise.to(self.device, torch.float32))
        if cond.get("lowres_cond_video") is not None:
            cond["lowres_cond_video"] = self._normalize(cond["lowres_cond_video"])
        acp_pad = torch.cat([torch.ones(1, device=self.device), sched.alphas_cumprod])
        x_start = torch.zeros_like(x)
        for k, (t_now, t_next) in enumerate(ddim_time_pairs(sched.num_timesteps, timesteps)):
            t = torch.full((b,), t_now, dtype=torch.long, device=self.device)
            out = self._unet_apply(i, x, t, cond_scale=cond_scale,
                                   self_cond=x_start if ucfg.self_cond else None, **cond)
            pred, _ = self._split_output(i, out)
            x_start = self._predict_x_start(i, x, t, pred)
            if self.config.clip_denoised:
                x_start = self.dynamic_threshold(x_start)
            pred_noise = sched.predict_noise_from_start(x, t, x_start)
            alpha, alpha_next = acp_pad[t_now + 1], acp_pad[t_next + 1]
            c1 = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
            c2 = torch.sqrt(torch.clamp((1 - alpha_next) - c1**2, min=0.0))
            x = x_start * torch.sqrt(alpha_next) + c2 * pred_noise
            if eta > 0 and t_next >= 0:
                noise = (k_loop.fold_in(k).normal(shape, self.device)
                         if step_noises is None else step_noises[k].to(self.device))
                x = x + c1 * noise
        return self._unnormalize(x)

    # ------------------------------------------------------------------ #
    def sample_stage(self, i: int, keys: RowKeys, *, batch_size: int,
                     prev_video: Optional[torch.Tensor] = None,
                     video_embed: Optional[torch.Tensor] = None,
                     cond_scale: float = 1.0,
                     sample_timesteps: Optional[int] = None,
                     init_noise: Optional[torch.Tensor] = None,
                     step_noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """One cascade stage -> video in [0, 1], (b, T_i, S_i, S_i, C).
        ``sample_timesteps`` overrides the configured step count."""
        cfg = self.config
        ucfg = self.unet_configs[i]
        size, frames = cfg.frame_sizes[i], cfg.frame_numbers[i]
        k_lowres, k_loop = keys.split()
        cond: Dict[str, torch.Tensor] = {}
        if ucfg.cond_on_video_embeds:
            cond["video_embed"] = video_embed
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
        shape = (batch_size, frames, size, size, cfg.channels)
        st = self.sample_timesteps[i] if sample_timesteps is None else sample_timesteps
        if st is not None and st < cfg.timesteps:
            return self.p_sample_loop_ddim(i, k_loop, shape, timesteps=st,
                                           cond_scale=cond_scale, init_noise=init_noise,
                                           step_noises=step_noises, **cond)
        return self.p_sample_loop_ddpm(i, k_loop, shape, cond_scale=cond_scale,
                                       init_noise=init_noise, step_noises=step_noises,
                                       **cond)

    @torch.no_grad()
    def sample(self, keys: RowKeys, *, video_embed: Optional[torch.Tensor] = None,
               batch_size: int = 1,
               cond_scale: Union[float, Tuple[float, ...]] = 1.0,
               start_at_unet_number: int = 1,
               stop_at_unet_number: Optional[int] = None,
               video: Optional[torch.Tensor] = None,
               max_batch_size: Optional[int] = None,
               sample_timesteps: Union[None, int, Tuple[Optional[int], ...]] = None,
               init_noises: Optional[Sequence[Optional[torch.Tensor]]] = None) -> torch.Tensor:
        """Full cascade. ``keys`` holds one key per row, so each row's video
        depends on its own key only, whatever the batch or chunking.
        ``init_noises[i]`` (optional) is stage i's x_T."""
        cfg = self.config
        n = cfg.num_unets
        if not cfg.unconditional:
            if video_embed is None:
                raise ValueError("a conditional decoder needs video_embed")
            batch_size = video_embed.shape[0]
        if len(keys) != batch_size:
            raise ValueError(f"{len(keys)} row keys for a batch of {batch_size}")
        if max_batch_size is not None and batch_size > max_batch_size:
            outs = []
            for s in range(0, batch_size, max_batch_size):
                sz = min(max_batch_size, batch_size - s)
                take = lambda a: None if a is None else a[s:s + sz]
                outs.append(self.sample(
                    keys.take(s, sz), video_embed=take(video_embed), batch_size=sz,
                    cond_scale=cond_scale, start_at_unet_number=start_at_unet_number,
                    stop_at_unet_number=stop_at_unet_number, video=take(video),
                    sample_timesteps=sample_timesteps,
                    init_noises=None if init_noises is None
                    else [take(z) for z in init_noises],
                ))
            return torch.cat(outs, dim=0)

        cond_scales = _cast_tuple(cond_scale, n)
        steps = _cast_tuple(sample_timesteps, n)
        if video_embed is not None:
            video_embed = video_embed.to(self.device, torch.float32)
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
                video_embed=video_embed, cond_scale=cond_scales[i],
                sample_timesteps=steps[i],
                init_noise=None if init_noises is None else init_noises[i],
            )
            if stop_at_unet_number is not None and stop_at_unet_number == i + 1:
                break
        return vid


def build_decoder(cfg: Dict, device: DeviceLike = None) -> VideoDecoder:
    """The cascade from the single-plane config (same keys as
    scripts/train_decoder.py's build_decoder, including the training knobs
    ``memory_efficient``, ``checkpoint_during_training`` and
    ``remat_policy``), plus the kernel knobs ``unetN.groupnorm_impl``
    (``pallas`` | ``fused``), ``unetN.spatial_conv_impl`` (``pallas_small``),
    ``unetN.cross_attention_impl`` and ``flash_attention_sampling``."""

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
