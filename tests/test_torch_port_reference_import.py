"""The reference's torch checkpoints into the port (models/torch_import.py)
and the CLIP adapters (models/clip_adapter.py), against the JAX package.

Oracles (no reference checkpoint is in the repository): the JAX importer
followed by ``weights.py``'s bridge, on the synthetic ViViT schema of
tests/test_torch_import.py and on ``RefUnet3D``, the torch mirror of the
reference Unet3D that tests/test_torch_import_unet.py builds (loaded from
that file with importlib; it stays as it is). Every parameter-level hold is
bit for bit; the port's Unet3D forward against the mirror's within atol
2e-4, rtol 1e-3 (the JAX file's tolerance). The trainer bundle: the JAX
``trainer_state_from_torch`` then ``load_train_state_from_jax`` against
the port's importer, then one train step on each, bit for bit. The x-clip
and CoCa stand-ins are tests/test_clip_adapters.py's; the adapters' f32
embeds within 1e-6 of the JAX adapters'.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle2_video_tpu.models import clip_adapter as jadapter
from dalle2_video_tpu.models import torch_import as jimport
from dalle2_video_tpu.models.vivit import ViViTConfig as JaxViViTCfg
from dalle2_video_tpu.train import DecoderTrainer as JaxTrainer
from dalle2_video_tpu.train import DecoderTrainerConfig as JaxTrainerConfig
from dalle2_video_tpu_torch.engine.decoder import VideoDecoder, VideoDecoderConfig
from dalle2_video_tpu_torch.models import clip_adapter, torch_import
from dalle2_video_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from dalle2_video_tpu_torch.models.unet3d import UNet3D, UNet3DConfig
from dalle2_video_tpu_torch.models.vivit import ViViT, ViViTConfig
from dalle2_video_tpu_torch.train import DecoderTrainer, DecoderTrainerConfig, eval_clip, train_clip
from dalle2_video_tpu_torch.train.clip_trainer import ClipTrainer
from dalle2_video_tpu_torch.utils.keys import init_from
from dalle2_video_tpu_torch.weights import load_train_state_from_jax, params_from_jax
from test_clip_adapters import CoCaStandin, XClipStandin
from test_torch_port_clip import TEXT, VIVIT, tiny_text_tower, write_clip_store  # noqa: F401

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "ref_unet3d_mirror", Path(__file__).resolve().parent / "test_torch_import_unet.py")
mirror = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mirror)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _port_unet_cfg(jcfg) -> UNet3DConfig:
    fields = {f.name for f in dataclasses.fields(UNet3DConfig)}
    return UNet3DConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})


# ---------------------------------------------------------------- ViViT
def synthetic_vivit_sd(cfg, seed=0):
    """tests/test_torch_import.py:110's schema: the reference ViViT's keys
    at cfg's widths, seeded normal values (no to_out.0 when heads == 1 and
    dim_head == dim: the reference's project_out is then Identity)."""
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa
    d, inner, s = cfg.dim, cfg.heads * cfg.dim_head, cfg.scale_dim_conv
    flat = d * cfg.num_frames // s**2
    sd = {"to_patch_embedding.1.weight": t(d, 3 * cfg.patch_size**2),
          "to_patch_embedding.1.bias": t(d),
          "pos_embedding": t(1, cfg.num_frames, (cfg.frame_size // cfg.patch_size) ** 2 + 1, d),
          "temporal_conv.2.weight": t(d, d * s, 3), "temporal_conv.2.bias": t(d),
          "temporal_conv.4.weight": t(d, d * s, 3), "temporal_conv.4.bias": t(d),
          "to_out.1.weight": t(flat), "to_out.1.bias": t(flat),
          "to_out.2.weight": t(d, flat), "to_out.2.bias": t(d)}
    for tower in ("space_transformer", "temporal_transformer"):
        for i in range(cfg.depth):
            pre = f"{tower}.layers.{i}"
            sd |= {f"{pre}.0.norm.weight": t(d), f"{pre}.0.norm.bias": t(d),
                   f"{pre}.0.fn.to_qkv.weight": t(3 * inner, d),
                   f"{pre}.1.norm.weight": t(d), f"{pre}.1.norm.bias": t(d),
                   f"{pre}.1.fn.net.0.weight": t(d * cfg.scale_dim_attn, d),
                   f"{pre}.1.fn.net.0.bias": t(d * cfg.scale_dim_attn),
                   f"{pre}.1.fn.net.3.weight": t(d, d * cfg.scale_dim_attn),
                   f"{pre}.1.fn.net.3.bias": t(d)}
            if not (cfg.heads == 1 and cfg.dim_head == d):
                sd |= {f"{pre}.0.fn.to_out.0.weight": t(d, inner),
                       f"{pre}.0.fn.to_out.0.bias": t(d)}
    return sd


VIVIT_CASES = {
    "mha": dict(frame_size=8, patch_size=4, num_frames=25, dim=16, depth=2, heads=2,
                dim_head=8, scale_dim_attn=2, scale_dim_conv=5),
    "no_proj": dict(frame_size=8, patch_size=4, num_frames=25, dim=16, depth=1, heads=1,
                    dim_head=16, scale_dim_attn=2, scale_dim_conv=5),
}


@pytest.mark.parametrize("case", VIVIT_CASES)
def test_vivit_import_equals_the_jax_importer_then_the_bridge(case):
    """Bit for bit (the three channel-order permutations included); the
    walk lists exactly the schema's keys at its shapes; the result loads
    strictly into the port's ViViT."""
    kw = VIVIT_CASES[case]
    cfg, jcfg = ViViTConfig(**kw), JaxViViTCfg(**kw)
    sd = synthetic_vivit_sd(cfg)
    got = torch_import.vivit_params_from_torch(sd, cfg)
    _same(got, params_from_jax(_np(jimport.vivit_params_from_torch(sd, jcfg))))
    walk = torch_import.vivit_walk(ViViT(cfg))
    assert {e.ref_key: e.ref_shape for e in walk} == {k: tuple(v.shape) for k, v in sd.items()}
    ViViT(cfg).load_state_dict(got, strict=True)


def test_vivit_import_refusals_and_file(tmp_path):
    """The geometry refusal (as the JAX importer's), a missing key, an
    unmapped key; load_vivit_torch_ckpt from a torch.save file equals the
    in-memory import; a missing file raises FileNotFoundError."""
    cfg = ViViTConfig(**VIVIT_CASES["mha"])
    with pytest.raises(ValueError, match="geometry"):
        torch_import.vivit_params_from_torch(
            {"pos_embedding": torch.zeros(1, 25, 5, 8)}, cfg)
    sd = synthetic_vivit_sd(cfg, seed=1)
    with pytest.raises(KeyError):
        torch_import.vivit_params_from_torch(
            {k: v for k, v in sd.items() if k != "to_out.2.bias"}, cfg)
    with pytest.raises(ValueError, match="unmapped"):
        torch_import.vivit_params_from_torch({**sd, "space_token": torch.zeros(1, 1, 16)}, cfg)
    torch.save(sd, tmp_path / "video_encoder_best.pt")
    _same(torch_import.load_vivit_torch_ckpt(str(tmp_path / "video_encoder_best.pt"), cfg),
          torch_import.vivit_params_from_torch(sd, cfg))
    with pytest.raises(FileNotFoundError):
        torch_import.load_vivit_torch_ckpt(str(tmp_path / "absent.pt"), cfg)


# --------------------------------------------------------------- Unet3D
UNET_CASES = {
    # cross-embed stem, pixel-shuffle upsample, Downsample3D, stage and mid
    # attention, cross-attention resnet blocks
    "main": dict(),
    # pre-downsample + 1x1 post conv, cross-embed downsample, nearest
    # upsample, no attention
    "memory_efficient": dict(memory_efficient=True, cross_embed_downsample=True,
                             pixel_shuffle_upsample=False, attend_at_middle=False,
                             self_attn=False),
}


@pytest.mark.parametrize("case", UNET_CASES)
def test_unet_import_equals_the_jax_importer_and_runs_as_the_mirror(case):
    """RefUnet3D's random state dict: the port's import bit for bit the JAX
    importer's then the bridge; the walk's keys and shapes the mirror's
    state_dict(); the port's forward the mirror's within atol 2e-4, rtol
    1e-3."""
    jcfg = mirror.tiny_cfg(**UNET_CASES[case])
    ref = mirror.RefUnet3D(jcfg).eval()
    mirror._randomize(ref, seed=0)
    sd = ref.state_dict()
    cfg = _port_unet_cfg(jcfg)
    got = torch_import.unet3d_params_from_torch(sd, cfg, strict=True)
    _same(got, params_from_jax(_np(jimport.unet3d_params_from_torch(sd, jcfg, strict=True))))
    unet = UNet3D(cfg).eval()
    walk = torch_import.unet3d_walk(unet)
    assert {e.ref_key: e.ref_shape for e in walk} == {k: tuple(v.shape) for k, v in sd.items()}
    unet.load_state_dict(got, strict=True)

    b, t, h, w = mirror.B, mirror.T, mirror.H, mirror.W
    x = np.random.RandomState(0).randn(b, jcfg.channels, t, h, w).astype(np.float32)
    time = torch.tensor([3.0, 7.0])
    with torch.no_grad():
        want = ref(torch.from_numpy(x), time).numpy()
        out = unet(torch.from_numpy(x.transpose(0, 2, 3, 4, 1)), time)
    np.testing.assert_allclose(out.numpy().transpose(0, 4, 1, 2, 3), want, atol=2e-4, rtol=1e-3)


def test_unet_import_refuses_unknown_and_missing_keys():
    jcfg = mirror.tiny_cfg()
    sd = dict(mirror.RefUnet3D(jcfg).state_dict())
    cfg = _port_unet_cfg(jcfg)
    with pytest.raises(ValueError, match="unmapped"):
        torch_import.unet3d_params_from_torch(
            {**sd, "downs.0.1.block1.project.weight_extra": torch.zeros(1)}, cfg)
    assert set(torch_import.unet3d_params_from_torch(
        {**sd, "extra": torch.zeros(1)}, cfg, strict=False)) == set(UNet3D(cfg).state_dict())
    with pytest.raises(KeyError):
        torch_import.unet3d_params_from_torch(
            {k: v for k, v in sd.items() if k != "mid_block1.block1.norm.bias"}, cfg)
    with pytest.raises(ValueError, match="geometry"):
        torch_import.unet3d_params_from_torch({**sd, "to_out.bias": torch.zeros(7)}, cfg)


# -------------------------------------------------------------- decoder
def _port_decoder(jdec) -> VideoDecoder:
    c = jdec.config
    return VideoDecoder(VideoDecoderConfig(
        unets=tuple(_port_unet_cfg(u) for u in c.unets), frame_sizes=c.frame_sizes,
        frame_numbers=c.frame_numbers, timesteps=c.timesteps,
        learned_variance=c.learned_variance, unconditional=c.unconditional), device="cpu")


def test_decoder_import_skips_the_non_parameter_keys(tmp_path):
    """The JAX test's two-unet decoder state dict with a schedule buffer and
    a VAE buffer: each unet bit for bit the JAX importer's then the bridge,
    the same two keys skipped; load_decoder_torch_ckpt from a file loads the
    unets and returns them; a key outside unets. and the buffers raises."""
    jdec, sd = mirror._decoder_and_sd()
    dec = _port_decoder(jdec)
    params, skipped = torch_import.decoder_params_from_torch(sd, dec)
    jparams, jskipped = jimport.decoder_params_from_torch(sd, jdec)
    assert skipped == jskipped == ["noise_schedulers.0.betas", "vaes.0.layers"]
    for i, p in enumerate(params):
        _same(p, params_from_jax(_np(jparams[f"unet_{i}"])))
    walk = torch_import.decoder_walk(dec)
    assert {e.ref_key for e in walk} == {k for k in sd if k.startswith("unets.")}
    torch.save(sd, tmp_path / "decoder_best.pt")
    assert torch_import.load_decoder_torch_ckpt(str(tmp_path / "decoder_best.pt"), dec) == skipped
    for unet, p in zip(dec.unets, params):
        _same(dict(unet.state_dict()), p)
    with pytest.raises(ValueError, match="unrecognized"):
        torch_import.decoder_params_from_torch({**sd, "prior.x": torch.zeros(1)}, dec)


def test_trainer_bundle_equals_the_jax_import_then_a_step(tmp_path):
    """The JAX test's bundle (EMA shadows the online parameters + 1, EMA
    steps 120 / 121, steps 1200 / 340): the port's import equals JAX
    trainer_state_from_torch then load_train_state_from_jax (parameters,
    EMA shadows and counts, steps, zero Adam moments at count 0), bit for
    bit, and one train step of unet 2 on each gives the same parameters
    (the warm restart is fresh Adam state on both)."""
    jdec, sd = mirror._decoder_and_sd()
    ema_sd = {}
    for i in (0, 1):
        pref = f"unets.{i}."
        for k, v in sd.items():
            if k.startswith(pref):
                ema_sd[f"{i}.ema_model.{k[len(pref):]}"] = v + 1.0
                ema_sd[f"{i}.online_model.{k[len(pref):]}"] = v
        ema_sd[f"{i}.initted"] = torch.tensor(True)
        ema_sd[f"{i}.step"] = torch.tensor(120 + i)
    bundle = {"model": sd, "version": "0.0.0", "steps": torch.tensor([1200, 340]),
              "optim0": {"state": {}, "param_groups": []}, "sched0": {}, "ema": ema_sd}
    jstate = jimport.trainer_state_from_torch(
        bundle, JaxTrainer(jdec, JaxTrainerConfig(lr=1e-4, use_ema=True, bf16_compute=False)),
        jax.random.PRNGKey(0))

    import optax

    opt = []
    for st in jstate.opt_states:
        adam = [s for s in st if isinstance(s, optax.ScaleByAdamState)][0]
        opt.append({"mu": _np(adam.mu), "nu": _np(adam.nu), "count": int(adam.count)})
    want = DecoderTrainer(_port_decoder(jdec), DecoderTrainerConfig(lr=1e-4, use_ema=True))
    load_train_state_from_jax(want, {
        "params": _np(jstate.params), "opt_states": opt,
        "ema": [{"params": _np(e.params), "step": int(e.step)} for e in jstate.ema],
        "steps": [int(s) for s in np.asarray(jstate.steps)]})

    got = DecoderTrainer(_port_decoder(jdec), DecoderTrainerConfig(lr=1e-4, use_ema=True))
    torch.save(bundle, tmp_path / "trainer.pt")
    torch_import.load_trainer_torch_ckpt(str(tmp_path / "trainer.pt"), got)
    assert got.steps == want.steps == [1200, 340]
    assert [e.step for e in got.ema] == [e.step for e in want.ema] == [120, 121]
    for i in (0, 1):
        _same(got.params(i), want.params(i))
        _same(got.ema[i].params, want.ema[i].params)
        _same(got.ema[i].params, {k: v + 1.0 for k, v in got.params(i).items()})
        assert not got.optimizers[i].state
        assert all(not s["exp_avg"].any() and float(s["step"]) == 0
                   for s in want.optimizers[i].state.values())
    video = torch.from_numpy(np.random.default_rng(0).random((1, 2, 16, 16, 3), np.float32))
    for tr in (got, want):
        tr.train_step(video, unet_number=2)
    _same(got.params(1), want.params(1))


# ------------------------------------------------- the CLIP entry points
def test_clip_entry_points_take_a_reference_vivit(tmp_path, tiny_text_tower):
    """train_clip warm-starts from torch_vivit_ckpt (the ViViT at its first
    step is the drawn reference tensors under the walk's conversions, bit
    for bit) and trains; eval_clip embeds with it in place of the run's
    checkpoint."""
    args = write_clip_store(tmp_path, n=5)
    cfg = ViViTConfig(**VIVIT)
    walk = torch_import.vivit_walk(ViViT(cfg))
    sd = torch_import.draw_walk(walk, torch.Generator().manual_seed(0))
    path = tmp_path / "video_encoder_last.pt"
    torch.save(sd, path)
    want = {e.port_key: e.convert(sd[e.ref_key]) for e in walk}
    first = []
    step = ClipTrainer.train_step

    def recording_step(self, *a, **kw):
        if not first:
            first.append({k: v.detach().clone() for k, v in self.vivit.state_dict().items()})
        return step(self, *a, **kw)

    with mock.patch.object(ClipTrainer, "train_step", recording_step):
        out = train_clip.main(args + [f"torch_vivit_ckpt={path}"])
    _same(first[0], want)
    assert out["trainer"].step == 4 and np.isfinite(out["train"]["loss"])  # 2 epochs of 2
    ev = eval_clip.main(args + [f"torch_vivit_ckpt={path}"])
    _same(dict(ev["trainer"].vivit.state_dict()), want)
    assert ev["video_embeds"].shape == (5, VIVIT["dim"])


# ------------------------------------------------------------- adapters
def test_xclip_and_coca_adapters_equal_the_jax_adapters_and_freeze():
    """The stand-ins through both packages' facades: embeds (l2-normalised,
    frame-mean for video) within 1e-6, encodings equal; the models in eval
    mode with no parameter requiring a gradient and the embeds without a
    graph; wrap_clip's structural detection and its TypeError."""
    torch.manual_seed(0)
    tokens = np.arange(2 * 5).reshape(2, 5) % 100
    videos = np.random.RandomState(0).rand(2, 3, 8, 8, 3).astype(np.float32)
    for standin, kind in ((XClipStandin(), clip_adapter.XClipAdapter),
                          (CoCaStandin(), clip_adapter.CoCaAdapter)):
        ad = clip_adapter.wrap_clip(standin)
        jad = jadapter.wrap_clip(standin)
        assert isinstance(ad, kind) and ad.dim_latent == jad.dim_latent
        assert not standin.training and not any(p.requires_grad for p in standin.parameters())
        for (emb, enc), (jemb, jenc) in ((ad.embed_text(tokens), jad.embed_text(tokens)),
                                         (ad.embed_video(videos), jad.embed_video(videos))):
            assert not emb.requires_grad
            np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=1e-6, rtol=0)
            np.testing.assert_allclose(torch.linalg.vector_norm(emb, dim=-1).numpy(), 1.0,
                                       atol=1e-6)
            assert (enc is None) == (jenc is None)
            if enc is not None:
                np.testing.assert_array_equal(enc.numpy(), np.asarray(jenc))
        assert clip_adapter.wrap_clip(ad) is ad
    with pytest.raises(TypeError, match="cannot adapt"):
        clip_adapter.wrap_clip(object())


def test_generic_and_video_clip_adapters():
    """GenericClipAdapter against the JAX one on the same callables' values;
    VideoClipAdapter.create over copies of a ViViT and a text tower: its
    embeds the towers' own bit for bit, the encodings the tower's, every
    copied parameter frozen and the source towers untouched."""
    rng = np.random.default_rng(0)
    emb, enc = rng.standard_normal((2, 6)).astype(np.float32), rng.random((2, 4, 3))
    ad = clip_adapter.GenericClipAdapter(lambda t: (torch.from_numpy(emb), torch.from_numpy(enc)),
                                         lambda v: torch.from_numpy(emb), latent_dim=6)
    jad = jadapter.GenericClipAdapter(lambda t: (jnp.asarray(emb), jnp.asarray(enc)),
                                      lambda v: jnp.asarray(emb), latent_dim=6)
    for (e, c), (je, jc) in ((ad.embed_text(None), jad.embed_text(None)),
                             (ad.embed_video(None), jad.embed_video(None))):
        np.testing.assert_allclose(e.numpy(), np.asarray(je), atol=1e-6, rtol=0)
        assert (c is None) == (jc is None)
    assert ad.dim_latent == 6 and clip_adapter.wrap_clip(ad) is ad

    vcfg, tcfg = ViViTConfig(**VIVIT), CLIPTextConfig(**TEXT)
    with init_from(torch.Generator().manual_seed(1)):
        vivit, text = ViViT(vcfg), CLIPTextEncoder(tcfg)
    vad = clip_adapter.VideoClipAdapter.create(vcfg, vivit.state_dict(), text.state_dict(),
                                               tcfg, device="cpu")
    assert clip_adapter.wrap_clip(vad) is vad and vad.dim_latent == TEXT["embed_dim"]
    tokens = torch.randint(1, TEXT["vocab_size"], (2, 77), generator=torch.Generator().manual_seed(2))
    videos = torch.rand(2, VIVIT["num_frames"], VIVIT["frame_size"], VIVIT["frame_size"], 3,
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want_t, want_enc = text(tokens, return_encodings=True)
        want_v = vivit.eval()(videos)
    (t_emb, t_enc), (v_emb, v_enc) = vad.embed_text(tokens), vad.embed_video(videos)
    assert torch.equal(t_emb, want_t) and torch.equal(t_enc, want_enc)
    assert torch.equal(v_emb, want_v) and v_enc is None
    for m in (vad.vivit, vad.text_encoder):
        assert not m.training and not any(p.requires_grad for p in m.parameters())
    assert all(p.requires_grad for p in vivit.parameters())
