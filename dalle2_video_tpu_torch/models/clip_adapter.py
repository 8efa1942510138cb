"""CLIP adapter facade: one ``embed_text`` / ``embed_video`` interface over
frozen towers (port of dalle2_video_tpu/models/clip_adapter.py).

``VideoClipAdapter`` pairs the frozen text tower with a ViViT video tower;
``GenericClipAdapter`` wraps any two callables; ``XClipAdapter`` and
``CoCaAdapter`` are facades over x-clip's ``CLIP`` and a CoCa model, and
``wrap_clip`` picks one by structure (the x_clip / coca packages are not
needed: detection looks at attributes, as in the JAX module).

"Frozen" is three things here: the towers are in ``eval()`` mode, every
parameter has ``requires_grad`` False, and the embeds are computed under
``torch.no_grad()``. Where the JAX facades move tensors through NumPy on
the host, these keep them on the model's device: a video's frames fold
into the batch, go NCHW through the per-image tower, and the per-frame
embeds are averaged over the frames.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from dalle2_video_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from dalle2_video_tpu_torch.models.vivit import ViViT, ViViTConfig
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device


def _freeze(model: nn.Module) -> nn.Module:
    return model.eval().requires_grad_(False)


def _device_of(model: nn.Module) -> torch.device:
    p = next(iter(model.parameters()), None)
    return torch.device("cpu") if p is None else p.device


@dataclasses.dataclass(frozen=True)
class VideoClipAdapter:
    """The frozen text tower and a ViViT video tower (both frozen here):

    embed_text(tokens)  -> (embed (b, dim), encodings (b, n, width))
    embed_video(videos) -> (embed (b, dim), None)

    BaseClipAdapter's (embed, encodings) contract; the embeds are the
    towers' outputs, not normalised (as the JAX adapter's)."""

    text_encoder: CLIPTextEncoder
    vivit: ViViT

    def __post_init__(self):
        _freeze(self.text_encoder)
        _freeze(self.vivit)

    @staticmethod
    def create(vivit_config: ViViTConfig, vivit_params: Dict[str, torch.Tensor],
               text_params: Dict[str, torch.Tensor],
               text_config: CLIPTextConfig = CLIPTextConfig(),
               device: DeviceLike = None) -> "VideoClipAdapter":
        """Both towers built from their configs and copies of their state
        dicts (loaded strictly) on ``device`` (CUDA by default)."""
        dev = resolve_device(device)
        with torch.device("meta"):
            vivit, text = ViViT(vivit_config), CLIPTextEncoder(text_config)
        for module, params in ((vivit, vivit_params), (text, text_params)):
            module.load_state_dict({k: v.detach().to(dev, torch.float32).clone()
                                    for k, v in params.items()}, strict=True, assign=True)
        return VideoClipAdapter(text_encoder=text, vivit=vivit)

    @property
    def dim_latent(self) -> int:
        return self.text_encoder.cfg.embed_dim

    @torch.no_grad()
    def embed_text(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.text_encoder(torch.as_tensor(tokens).to(_device_of(self.text_encoder)),
                                 return_encodings=True)

    @torch.no_grad()
    def embed_video(self, videos: torch.Tensor) -> Tuple[torch.Tensor, None]:
        dev = _device_of(self.vivit)
        return self.vivit(torch.as_tensor(videos).to(dev, torch.float32)), None


class BaseClipAdapter:
    """The adapter contract: ``embed_text(tokens) -> (embed, encodings or
    None)``, ``embed_video(videos) -> (embed, None)``, and ``dim_latent``.
    Embeds are l2-normalised; both methods are gradient-frozen."""

    @property
    def dim_latent(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def embed_text(self, tokens):  # pragma: no cover - abstract
        raise NotImplementedError

    def embed_video(self, videos):  # pragma: no cover - abstract
        raise NotImplementedError


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


@dataclasses.dataclass(frozen=True)
class GenericClipAdapter(BaseClipAdapter):
    """Bring-your-own backend: wraps two callables (a lookup into
    precomputed embeds, another framework's towers ...)."""

    text_fn: Callable[[Any], Any]  # tokens -> (embed, encodings or None) or embed
    video_fn: Callable[[Any], Any]  # videos -> (embed, None) or embed
    latent_dim: int

    @property
    def dim_latent(self) -> int:
        return self.latent_dim

    @staticmethod
    def _pair(out) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        emb, enc = out if isinstance(out, tuple) else (out, None)
        emb = _l2norm(torch.as_tensor(emb)).detach()
        return emb, None if enc is None else torch.as_tensor(enc).detach()

    @torch.no_grad()
    def embed_text(self, tokens):
        return self._pair(self.text_fn(tokens))

    @torch.no_grad()
    def embed_video(self, videos):
        return self._pair(self.video_fn(videos))


class _FrozenTorchAdapter(BaseClipAdapter):
    """The frozen model (``freeze_model_and_make_eval_``) and the frame
    folding of the per-image facades."""

    def __init__(self, model: nn.Module):
        self.model = _freeze(model)

    @property
    def device(self) -> torch.device:
        return _device_of(self.model)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens).to(self.device).long()

    def _frames(self, videos) -> Tuple[torch.Tensor, int, int]:
        """(b, t, H, W, C) -> (b * t, C, H, W) f32 on the model's device."""
        v = torch.as_tensor(videos).to(self.device, torch.float32)
        b, t = v.shape[:2]
        return v.reshape(b * t, *v.shape[2:]).permute(0, 3, 1, 2), b, t

    @staticmethod
    def _frame_mean(emb: torch.Tensor, b: int, t: int) -> torch.Tensor:
        return _l2norm(emb.reshape(b, t, -1).mean(dim=1))


class XClipAdapter(_FrozenTorchAdapter):
    """Facade over an x-clip ``CLIP``: the CLS token through the latent
    head, the other tokens returned as encodings; a video is the mean of
    its frames' embeds (the tower is per image)."""

    @property
    def dim_latent(self) -> int:
        return self.model.dim_latent

    @torch.no_grad()
    def embed_text(self, tokens):
        enc = self.model.text_transformer(self._tokens(tokens))
        return _l2norm(self.model.to_text_latent(enc[:, 0])), enc[:, 1:]

    @torch.no_grad()
    def embed_video(self, videos):
        frames, b, t = self._frames(videos)
        enc = self.model.visual_transformer(frames)
        return self._frame_mean(self.model.to_visual_latent(enc[:, 0]), b, t), None


class CoCaAdapter(_FrozenTorchAdapter):
    """Facade over a CoCa model: its own ``embed_text`` / ``embed_image``
    heads; a video is the mean of its frames' image embeds."""

    @property
    def dim_latent(self) -> int:
        return self.model.dim

    @torch.no_grad()
    def embed_text(self, tokens):
        out = self.model.embed_text(self._tokens(tokens))
        embed, encodings = out if isinstance(out, tuple) else (out, None)
        return _l2norm(embed), encodings

    @torch.no_grad()
    def embed_video(self, videos):
        frames, b, t = self._frames(videos)
        out = self.model.embed_image(frames)
        return self._frame_mean(out[0] if isinstance(out, tuple) else out, b, t), None


def wrap_clip(model) -> BaseClipAdapter:
    """x-clip CLIP -> XClipAdapter, CoCa -> CoCaAdapter, adapters pass
    through; detection is structural (no x_clip / coca import)."""
    if isinstance(model, (BaseClipAdapter, VideoClipAdapter)):
        return model
    if hasattr(model, "text_transformer") and hasattr(model, "visual_transformer"):
        return XClipAdapter(model)
    if hasattr(model, "embed_text") and hasattr(model, "embed_image"):
        return CoCaAdapter(model)
    raise TypeError(
        f"cannot adapt {type(model).__name__}: expected a BaseClipAdapter, "
        "an x-clip-style CLIP, or a CoCa-style model"
    )
