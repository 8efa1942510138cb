"""Quality scoring and profiling against the JAX package: the FVD functions
(float64 host statistics, relative 1e-10) and ``compute_fvd`` batched
against unbatched; every ``jax.image.resize`` method, up and down in space
and in time, in f32 within 1e-5; ``StepTimer``, ``trace``, ``flops_of``
(equal to XLA's count on a bias-free matmul and a bias-free 3x3 conv) and
``mfu``; the fixed-seed ViViT extractor against the JAX ViViT on the same
parameters (f32, 2e-5 of the features' scale); and the distill entry
point's scoring on a tiny store: its keys, finite values, resume, and each
FVD equal to the JAX ``fvd_from_features`` of the same features.

The JAX sides are NumPy (the FVD) or small programs compiled at XLA's
lowest optimisation level; the port runs on one CPU thread.
"""

from __future__ import annotations

import json
import time
import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch

from dalle2_video_tpu.models.vivit import ViViT as JaxViViT
from dalle2_video_tpu.models.vivit import ViViTConfig as JaxViViTCfg
from dalle2_video_tpu.utils import fvd as jfvd
from dalle2_video_tpu.utils import profiling as jprof
from dalle2_video_tpu_torch.models.vivit import ViViT
from dalle2_video_tpu_torch.ops import video as pvideo
from dalle2_video_tpu_torch.engine.decoder import VideoDecoder
from dalle2_video_tpu_torch.train import distill
from dalle2_video_tpu_torch.train.__main__ import main as train_decoder_main
from dalle2_video_tpu_torch.utils import fvd, profiling
from dalle2_video_tpu_torch.utils.keys import RowKeys, init_from
from test_torch_port_prior_moe import jax_tree_of

torch.set_num_threads(1)
_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_O0)


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-300)


# ------------------------------------------------------------------ FVD
def test_fvd_functions_match_jax():
    """feature_stats, the eigh square-root trace, frechet_distance and
    fvd_from_features on seeded features, full-rank and rank-deficient
    (fewer samples than dimensions: the clips keep it finite); compute_fvd
    batched equals unbatched."""
    rng = np.random.default_rng(0)
    for n_real, n_fake, d in ((40, 30, 6), (5, 4, 12)):
        real = rng.standard_normal((n_real, d))
        fake = rng.standard_normal((n_fake, d)) * 1.5 + 0.3
        (mu, s), (jmu, js) = fvd.feature_stats(real), jfvd.feature_stats(real)
        np.testing.assert_array_equal(mu, jmu)
        np.testing.assert_array_equal(s, js)
        _, s2 = fvd.feature_stats(fake)
        assert _rel(fvd._sqrtm_product_trace(s, s2), jfvd._sqrtm_product_trace(js, s2)) < 1e-10
        got = fvd.fvd_from_features(real, fake)
        assert np.isfinite(got) and _rel(got, jfvd.fvd_from_features(real, fake)) < 1e-10
        # a rank-deficient self-distance is sqrt(eps)-small, not 0: the clips
        self_d = fvd.frechet_distance(mu, s, mu, s)
        assert abs(self_d) < 1e-6 * np.trace(s)
        assert _rel(self_d, jfvd.frechet_distance(jmu, js, jmu, js)) < 1e-10
    with pytest.raises(AssertionError):
        fvd.feature_stats(np.zeros((1, 3)))

    videos = rng.random((7, 2, 3, 3, 3)).astype(np.float32)
    fakes = rng.random((6, 2, 3, 3, 3)).astype(np.float32)
    embed = lambda v: np.asarray(v).reshape(len(v), -1)[:, :5] * 2.0  # noqa: E731
    batched = fvd.compute_fvd(videos, fakes, embed, batch_size=3)
    assert batched == fvd.compute_fvd(videos, fakes, embed, batch_size=100)
    assert _rel(batched, jfvd.compute_fvd(videos, fakes, embed, batch_size=3)) < 1e-10


# --------------------------------------------------------------- resize
METHODS = ("nearest", "linear", "cubic", "lanczos3", "lanczos5")


@pytest.mark.parametrize("method", METHODS)
def test_resize_methods_match_jax(method):
    """resize_video down (12 x 9 -> 5 x 5) and up (-> 20 x 20) in space and
    resize_video_time down (6 -> 4) and up (6 -> 9), f32 within 1e-5."""
    x = np.random.default_rng(1).standard_normal((2, 6, 12, 9, 3)).astype(np.float32)
    shapes = [(2, 6, 5, 5, 3), (2, 6, 20, 20, 3), (2, 4, 12, 9, 3), (2, 9, 12, 9, 3)]
    want = _compiled(lambda a: [jax.image.resize(a, s, method=method) for s in shapes], x)(x)
    t = torch.from_numpy(x)
    got = [pvideo.resize_video(t, 5, method), pvideo.resize_video(t, 20, method),
           pvideo.resize_video_time(t, 4, method), pvideo.resize_video_time(t, 9, method)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_resize_aliases_and_refusal():
    """The aliases compute their method's function bit for bit; nearest
    keeps F.interpolate's nearest-exact route; an unknown method raises
    as jax.image.resize does; integer input resizes as f32."""
    t = torch.from_numpy(np.random.default_rng(2).random((1, 4, 6, 6, 3)).astype(np.float32))
    for alias, name in (("bilinear", "linear"), ("trilinear", "linear"), ("triangle", "linear"),
                        ("bicubic", "cubic"), ("tricubic", "cubic")):
        assert torch.equal(pvideo.resize_video(t, 3, alias), pvideo.resize_video(t, 3, name))
        assert torch.equal(pvideo.resize_video_time(t, 7, alias),
                           pvideo.resize_video_time(t, 7, name))
    frames = t.reshape(4, 6, 6, 3).permute(0, 3, 1, 2)
    want = torch.nn.functional.interpolate(frames, size=(4, 4), mode="nearest-exact")
    assert torch.equal(pvideo.resize_video(t, 4), want.permute(0, 2, 3, 1).reshape(1, 4, 4, 4, 3))
    with pytest.raises(ValueError, match="Unknown resize method"):
        pvideo.resize_video(t, 3, "area")
    ints = (t * 100).to(torch.int32)
    assert pvideo.resize_video(ints, 3, "linear").dtype == torch.float32


# ------------------------------------------------------------ profiling
def test_step_timer_summary_and_wait():
    """The JAX summary's keys and window; stop(result) waits on CUDA
    results only (no synchronize for a tree of CPU tensors), and the step()
    context times its block."""
    timer = profiling.StepTimer(window=3)
    assert timer.summary() == {}
    with mock.patch.object(torch.cuda, "synchronize") as sync:
        for _ in range(4):
            with timer.step() as out:
                time.sleep(0.002)
                out["result"] = {"loss": torch.ones(()), "parts": [torch.zeros(2), (1.0,)]}
        assert not sync.called
        profiling.wait_for([torch.ones(1), {"a": torch.ones(1)}])
        assert not sync.called
    s = timer.summary()
    jtimer = jprof.StepTimer(window=3)
    jtimer._times = list(timer._times)
    assert s == jtimer.summary()
    assert len(timer._times) == 3 and all(t >= 0.002 for t in timer._times)
    assert s["steps_per_sec"] == pytest.approx(1.0 / s["step_time_mean_s"])
    assert s["step_time_p50_s"] <= s["step_time_p90_s"]


def test_trace_writes_a_tensorboard_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())


def test_flops_of_equals_xla_on_a_matmul_and_a_conv_and_mfu():
    """FlopCounterMode's count equals XLA's on programs where both are
    exact: a bias-free matmul and a bias-free 3 x 3 conv (valid padding;
    XLA counts only the taps inside a padded window, FlopCounterMode all).
    A program with no counted operation raises (the JAX function returns
    0.0). mfu as the JAX function."""
    a = np.ones((16, 24), np.float32)
    b = np.ones((24, 8), np.float32)
    want = jprof.flops_of(jax.jit(lambda x, y: x @ y), a, b)
    assert want == 2 * 16 * 24 * 8
    assert profiling.flops_of(torch.matmul, torch.from_numpy(a), torch.from_numpy(b)) == want

    x = np.ones((2, 10, 10, 4), np.float32)  # NHWC / HWIO for XLA
    w = np.ones((3, 3, 4, 5), np.float32)
    conv = lambda x, w: jax.lax.conv_general_dilated(  # noqa: E731
        x, w, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    want = jprof.flops_of(jax.jit(conv), x, w)
    got = profiling.flops_of(torch.nn.functional.conv2d,
                             torch.from_numpy(x).permute(0, 3, 1, 2),
                             torch.from_numpy(w).permute(3, 2, 0, 1))
    assert got == want == 2 * 2 * 8 * 8 * 5 * 4 * 9
    with pytest.raises(ValueError, match="no operation"):
        profiling.flops_of(torch.add, torch.ones(3), torch.ones(3))

    for args in ((1e12, 0.5, 1e13), (0.0, 1.0, 1.0), (1.0, 0.0, 1.0), (1.0, 1.0, 0.0)):
        assert profiling.mfu(*args) == jprof.mfu(*args)
    assert profiling.mfu(1e12, 0.5, 1e13) == pytest.approx(0.2)


# ------------------------------------------------------------ extractor
def test_extractor_matches_the_jax_vivit():
    """vivit_embed_fn's ViViT (16 x 64^2, dim 256, depth 2, 4 x 32 heads,
    scale_dim_conv 2, seed 0) against the JAX ViViT on its parameters
    through the bridge: clips at the extractor's geometry, and clips of
    another geometry resized as JAX resizes them (time nearest, space
    linear), f32 within 2e-5 of the features' scale."""
    embed, provenance = fvd.vivit_embed_fn(device="cpu")
    assert "seed 0" in provenance and "not with the JAX" in provenance
    with init_from(torch.Generator().manual_seed(0)):
        vivit = ViViT(fvd.EXTRACTOR)
    c = fvd.EXTRACTOR
    jcfg = JaxViViTCfg(dim=c.dim, num_frames=c.num_frames, frame_size=c.frame_size,
                       patch_size=c.patch_size, depth=c.depth, heads=c.heads,
                       dim_head=c.dim_head, scale_dim_conv=c.scale_dim_conv)
    rng = np.random.default_rng(3)
    same = rng.random((2, 16, 64, 64, 3)).astype(np.float32)
    other = rng.random((2, 20, 32, 32, 3)).astype(np.float32)
    tree = jax_tree_of(vivit)
    for conv in ("temporal_conv1", "temporal_conv2"):  # Conv1d (out, in, 3) -> (3, in, out)
        node = tree["params"][conv]
        node["kernel"] = np.ascontiguousarray(node.pop("weight").transpose(2, 1, 0))

    def jax_embed(p, a, b):
        b = jax.image.resize(b, (2, 16, 32, 32, 3), "nearest")
        b = jax.image.resize(b, (2, 16, 64, 64, 3), "linear")
        return JaxViViT(jcfg).apply(p, a), JaxViViT(jcfg).apply(p, b)

    want = _compiled(jax_embed, tree, same, other)(tree, same, other)
    for got, w in zip((embed(same), embed(torch.from_numpy(other))), want):
        w = np.asarray(w)
        assert got.shape == (2, 256) and got.dtype == np.float32
        np.testing.assert_allclose(got, w, atol=2e-5 * np.abs(w).max(), rtol=0)


# -------------------------------------------------------------- scoring
# tests/test_torch_port_prior_train.py's tiny decoder recipe
DECODER = ["frame_sizes=[8,16]", "frame_numbers=[2,2]", "decoder.batch_size=2",
           "decoder.epochs=1", "decoder.bf16_compute=false", "unet1.dim=16", "unet2.dim=8",
           *(f"unet{u}.{k}" for u in (1, 2) for k in (
               "dim_mults=[1,2]", "num_resnet_blocks=1", "attn_heads=2", "attn_dim_head=8"))]


def write_decoder_store(root, n=7):
    """A .vshard store of n seeded (3, 25, 16, 16) clips (CLIP-normalised
    values: standard normal) and (n, 24) video embeds; returns the decoder
    stage's overrides reading them."""
    from dalle2_video_tpu_torch.data import shards

    rng = np.random.default_rng(0)
    with shards.ShardWriter(f"{root}/videos.vshard", (3, 25, 16, 16), np.float32) as w:
        for _ in range(n):
            w.append(rng.standard_normal((3, 25, 16, 16), dtype=np.float32))
    np.save(f"{root}/videos.npy", rng.standard_normal((n, 24)).astype(np.float32))
    return [f"run_dir={root}/runs", "device=cpu", "loader=thread", "dim=24",
            f"videos.preprocessed={root}/videos.vshard", f"videos.embed={root}/videos.npy",
            *DECODER]


def test_distill_scoring_keys_resume_and_fvd_as_jax(tmp_path):
    """python -m ...train.distill on a 7-clip store (split 2 / 5) after a
    one-step decoder run, N_EVAL 4 at EVAL_BATCH 3: the anchor and one
    FVD per student, each the JAX fvd_from_features of the features the
    extractor gave; the reals the held-out clips at unet 1's geometry
    clamped to [0, 1]; samples at each student's own step count, one
    request seed 1000 + i per sample; a rerun without phase 4's score
    samples phase 4 alone and keeps the other scores."""
    args = write_decoder_store(tmp_path)
    train_decoder_main(args + ["max_steps=1"])
    run = tmp_path / "distill"
    feats, samples = [], []
    make_embed = fvd.vivit_embed_fn
    sample = VideoDecoder.sample

    def recording_embed_fn(*a, **kw):
        embed_fn, prov = make_embed(*a, **kw)

        def record(v):
            feats.append((tuple(v.shape), float(v.min()), float(v.max()), embed_fn(v)))
            return feats[-1][-1]
        return record, prov

    def recording_sample(self, keys, **kw):
        samples.append((self.sample_timesteps[0], keys.seeds, kw["cond_scale"],
                        kw["stop_at_unet_number"]))
        return sample(self, keys, **kw)

    argv = args + ["train_ratio=0.4", "--run", str(run), "--steps", "1"]
    with mock.patch.object(distill, "N_EVAL", 4), mock.patch.object(distill, "EVAL_BATCH", 3), \
            mock.patch.object(distill, "vivit_embed_fn", recording_embed_fn), \
            mock.patch.object(VideoDecoder, "sample", recording_sample):
        out = distill.main(argv)
        scored = json.loads((run / "results.json").read_text())
        tags = [f"student{s}" for s in distill.PHASES]
        assert {"extractor", "score_space", "fvd_real_vs_real_splithalf",
                *(f"fvd_{t}" for t in tags), *(f"sample_s_{t}" for t in tags)} <= set(scored)
        assert all(np.isfinite(scored[k]) for k in scored if k.startswith(("fvd_", "sample_s_")))
        assert scored["fvd_real_vs_real_splithalf"] == out["fvd_real_vs_real_splithalf"]
        # the reals: 4 clips of 2 frames at 8 px in [0, 1], in batches of 3 + 1
        assert [f[0] for f in feats[:2]] == [(3, 2, 8, 8, 3), (1, 2, 8, 8, 3)]
        assert all(0.0 <= f[1] and f[2] <= 1.0 for f in feats)
        real = np.concatenate([f[3] for f in feats[:2]])
        assert scored["fvd_real_vs_real_splithalf"] == jfvd.fvd_from_features(real[:2], real[2:])
        for i, tag in enumerate(tags):
            fake = np.concatenate([f[3] for f in feats[2 + 2 * i:4 + 2 * i]])
            assert _rel(scored[f"fvd_{tag}"], jfvd.fvd_from_features(real, fake)) < 1e-10
        want = [(s, RowKeys.from_request_seeds(seeds).seeds, 1.0, 1)
                for s in distill.PHASES for seeds in ((1000, 1001, 1002), (1003,))]
        assert samples == want

        del scored["fvd_student4"]
        (run / "results.json").write_text(json.dumps(scored))
        samples.clear()
        feats.clear()
        again = distill.main(argv)
    assert [s[0] for s in samples] == [4, 4]
    assert all(again[f"fvd_{t}"] == scored[f"fvd_{t}"] for t in tags[:3])
    assert np.isfinite(again["fvd_student4"])
