"""The trained-teacher quality path against the JAX scripts it ports:
scripts/train_r2_curve.py (the blob corpus, the batch index stream with
its replay, the recipe's configs and parameter counts),
scripts/eval_quality.py (the grid, the ladder's configs),
scripts/demo_inpaint.py (the masks), scripts/demo_longvideo.py (the
windows and the seam flicker) and scripts/distill_sr_demo.py (the PSNR),
each on the same arrays, bit for bit (the PSNR and the flicker to 1e-12
relative: the same NumPy float64 arithmetic). A nested function or a
config the scripts build inside ``main`` is taken from the script's own
source (``script_statements``).

Port-only: a curve run of 4 steps a stage at a narrow width, with its
mid-run reload and after a crash and a relaunch, equals the same run
uninterrupted bit for bit; the replacement inpainting of each demo mode
keeps the known region within 1e-6; the curve source of the distill
entry point runs its phases and scores on blob clips; the extractor takes
a trained tower's weights (``--vivit``). The port runs on one CPU thread.
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import importlib
import json
import sys
import unittest.mock as mock
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dalle2_video_tpu.engine.decoder  # noqa: F401 -- the scripts import these inside
import dalle2_video_tpu.train  # noqa: F401 -- their functions: paid once, at collection
from dalle2_video_tpu.models.unet3d import UNet3D as JaxUNet3D
from dalle2_video_tpu_torch.engine.decoder import VideoDecoder, VideoDecoderConfig, build_unet
from dalle2_video_tpu_torch.models.unet3d import UNet3DConfig
from dalle2_video_tpu_torch.train import demo_inpaint, demo_longvideo, distill, distill_sr_demo
from dalle2_video_tpu_torch.train import elastic, eval_quality, train_curve
from dalle2_video_tpu_torch.models.vivit import ViViT
from dalle2_video_tpu_torch.ops.video import resize_video, resize_video_time
from dalle2_video_tpu_torch.train.checkpoint import save_checkpoint
from dalle2_video_tpu_torch.train.trainer import DecoderTrainer
from dalle2_video_tpu_torch.utils import fvd, grid
from dalle2_video_tpu_torch.utils.keys import init_from

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
sys.path.insert(0, str(ROOT))
from scripts.demo_inpaint import masks_for as jax_masks_for  # noqa: E402
from scripts.demo_longvideo import seam_flicker as jax_seam_flicker  # noqa: E402
from scripts.demo_longvideo import windows as jax_windows  # noqa: E402
from scripts.distill_sr_demo import psnr as jax_psnr  # noqa: E402
from scripts.eval_quality import LADDER as JAX_LADDER  # noqa: E402
from scripts.eval_quality import build as jax_build  # noqa: E402
from scripts.eval_quality import save_grid as jax_save_grid  # noqa: E402
from scripts.train_r2_curve import blob_videos as jax_blobs  # noqa: E402


def script_statements(name, func="main", keep=None):
    """The namespace after running, from ``func``'s body in
    scripts/<name>.py, the statements ``keep`` accepts and the imports
    they use, over the script's globals."""
    tree = ast.parse((SCRIPTS / f"{name}.py").read_text())
    body = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == func).body
    kept = [n for n in body if keep(n)]
    used = {x.id for n in kept for x in ast.walk(n) if isinstance(x, ast.Name)}
    chosen = [n for n in body if n in kept or isinstance(n, (ast.Import, ast.ImportFrom)) and any(
        (a.asname or a.name) in used for a in n.names)]
    ns = dict(vars(importlib.import_module(f"scripts.{name}")))  # the script's globals
    exec(compile(ast.Module(chosen, []), str(SCRIPTS / f"{name}.py"), "exec"), ns)
    return ns


def _assigns(*names):
    return lambda n: isinstance(n, ast.Assign) and any(
        isinstance(t, ast.Name) and t.id in names for t in n.targets)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _same_fields(port, jax_cfg):
    """Every field of the port's config equal to the JAX config's, tuples
    and lists alike; nested configs field by field."""
    want = _fields(jax_cfg)
    for name, got in _fields(port).items():
        w = want[name]
        if dataclasses.is_dataclass(got):
            _same_fields(got, w)
        elif isinstance(got, tuple) and got and dataclasses.is_dataclass(got[0]):
            assert len(got) == len(w)
            for a, b in zip(got, w):
                _same_fields(a, b)
        else:
            norm = lambda v: tuple(v) if isinstance(v, list) else v  # noqa: E731
            assert norm(got) == norm(w), (name, got, w)


# ------------------------------------------------------------ the corpus
def test_blob_videos_bit_for_bit():
    """The pools' stream: base clips then SR clips from one RandomState,
    the port's and the script's equal bit for bit (cut from 64 / 16 clips
    to 4 / 2; the draws per clip do not depend on the count)."""
    r_port, r_jax = np.random.RandomState(0), np.random.RandomState(0)
    for n, t, s in ((4, 16, 64), (2, 64, 128), (3, 5, 24)):
        got, want = train_curve.blob_videos(r_port, n, t, s), jax_blobs(r_jax, n, t, s)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            assert np.array_equal(a, b)
    assert got[0].min() >= 0.0 and got[0].max() <= 1.0


@pytest.mark.parametrize("skip", [0, 3])
def test_batch_index_stream_and_replay_bit_for_bit(skip):
    """train_curve.batches against the script's nested ``batches`` on the
    same pool: the same clips in the same order, from a fresh stream and
    after a resume's replay of ``skip`` draws, at both stages' batch
    sizes."""
    ns = script_statements("train_r2_curve", keep=lambda n: isinstance(n, ast.FunctionDef)
                           and n.name == "batches")
    ns["jnp"] = np  # the script's arrays, on the host
    pool = train_curve.blob_videos(np.random.RandomState(5), 6, 2, 8)
    for u, bs in ((1, 8), (2, 1)):
        port = train_curve.batches(pool, bs, u, torch.device("cpu"), skip=skip)
        script = ns["batches"](pool, bs, u, skip=skip)
        for _ in range(5):
            (pv, pe), (jv, je) = next(port), next(script)
            assert np.array_equal(pv.numpy(), jv) and np.array_equal(pe.numpy(), je)


# -------------------------------------------------------------- the recipe
def _script_recipe():
    ns = script_statements("train_r2_curve", keep=_assigns("u1", "u2", "dec", "trainer"))
    return ns["dec"].config, ns["trainer"].cfg


def test_curve_configs_field_by_field():
    """The unets, the decoder and the trainer (EMA included) of the
    script's main, field by field; eval_quality's build the same decoder
    with bf16 sampling, as the script's build."""
    jax_dec, jax_tr = _script_recipe()
    _same_fields(train_curve.curve_config(), jax_dec)
    _same_fields(train_curve.CURVE_TRAINER, jax_tr)
    cfg, _, _ = jax_build()
    _same_fields(eval_quality.eval_config(), cfg)
    assert cfg.sample_compute_dtype == "bfloat16"


def test_curve_parameter_counts_at_full_width():
    """Each unet's parameter count at the recipe's full width (on meta
    tensors) equals the JAX unet's init (traced with jax.eval_shape on
    init_params' dummy inputs, at 8 px; the SR unet traced on its xla
    attention route, whose parameters are the flash route's): 50,213,443
    and 14,112,492."""
    _, jdec, _ = jax_build()
    want = []
    for unet, ucfg in zip(jdec.unets, jdec.unet_configs):
        x, t = jnp.zeros((1, 1, 8, 8, 3)), jnp.zeros((1,), jnp.int32)
        kw = {"video_embed": jnp.zeros((1, ucfg.video_embed_dim))} if ucfg.cond_on_video_embeds \
            else {"lowres_cond_video": x}
        init = JaxUNet3D(dataclasses.replace(ucfg, attention_impl="xla")).init
        want.append(sum(int(v.size) for v in jax.tree_util.tree_leaves(
            jax.eval_shape(init, jax.random.PRNGKey(0), x, t, **kw))))
    cfg = train_curve.curve_config()
    got = []
    for i, u in enumerate(cfg.unets):
        ucfg = u.cast_for_cascade(lowres_cond=i > 0, lowres_noise_cond=False, channels=3,
                                  channels_out=3, cond_on_video_embeds=i == 0,
                                  cond_on_text_encodings=False)
        with torch.device("meta"):
            got.append(sum(p.numel() for p in build_unet(ucfg).parameters()))
    assert got == want == [50_213_443, 14_112_492]


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
def test_ladder_configs_match_the_script(sampler):
    """Each ladder point's decoder config against the script's
    dataclasses.replace(cfg, sample_timesteps=(st, st), sampler=...)."""
    jcfg, _, _ = jax_build()
    cfg = eval_quality.eval_config()
    assert eval_quality.LADDER == JAX_LADDER
    for st in JAX_LADDER:
        _same_fields(eval_quality.ladder_config(cfg, st, sampler),
                     dataclasses.replace(jcfg, sample_timesteps=(st, st), sampler=sampler))


# ------------------------------------------------------ the scripts' helpers
def test_save_grid_matches_the_script_and_decodes(tmp_path):
    """save_grid's uint8 grid equals the one the script hands imageio (its
    imwrite patched), at the default 6 x 8 and at 2 rows x 16 frames, from
    values past [0, 1]; the port's PNG decodes (imageio and read_png) to
    that grid."""
    v = np.random.default_rng(0).uniform(-0.2, 1.2, (7, 20, 6, 5, 3)).astype(np.float32)
    for kw in ({}, dict(n_rows=2, n_frames=16)):
        captured = []
        with mock.patch("imageio.v2.imwrite", lambda p, a: captured.append(a)):
            jax_save_grid(tmp_path / "jax.png", v, **kw)
        grid.save_grid(tmp_path / "port.png", torch.from_numpy(v), **kw)
        got = grid.grid_array(v, **kw)
        assert got.dtype == np.uint8 and np.array_equal(got, captured[0])
        assert np.array_equal(imageio.imread(tmp_path / "port.png"), captured[0])
        assert np.array_equal(grid.read_png(tmp_path / "port.png"), captured[0])


def test_extractor_loads_a_trained_tower(tmp_path):
    """eval_quality's --vivit: the extractor's weights from a checkpoint
    directory holding a ViViT state dict (loaded strictly) in place of the
    seed-0 init; the features are that tower's."""
    with init_from(torch.Generator().manual_seed(0)):
        tower = ViViT(fvd.EXTRACTOR)
    with torch.no_grad():
        for p in tower.parameters():
            p.mul_(0.5)
    save_checkpoint(str(tmp_path / "vivit"), tower.state_dict())
    embed, provenance = fvd.vivit_embed_fn("cpu", ckpt=str(tmp_path / "vivit"))
    seeded, _ = fvd.vivit_embed_fn("cpu")
    v = np.random.default_rng(3).random((2, 16, 64, 64, 3), dtype=np.float32)
    x = resize_video(resize_video_time(torch.from_numpy(v), 16), 64, method=fvd.SPACE_METHOD)
    with torch.no_grad():
        want = tower.eval()(x).numpy()
    assert provenance == f"trained ({tmp_path / 'vivit'})"
    assert np.array_equal(embed(v), want) and not np.allclose(seeded(v), want)


def test_masks_match_demo_inpaint():
    for mode in ("extend", "interpolate", "spatial"):
        for t, s in ((16, 64), (6, 10)):
            got, want = demo_inpaint.masks_for(mode, t, s), jax_masks_for(mode, t, s)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError):
        demo_inpaint.masks_for("outpaint", 16, 64)
    assert demo_inpaint.parse_jobs("extend,spatial,extend_guided") == (
        ("extend", "replace"), ("spatial", "replace"), ("extend", "guided"))


def test_windows_and_seam_flicker_match_demo_longvideo():
    v = np.random.default_rng(1).random((3, 64, 4, 4, 3)).astype(np.float32)
    for t, stride in ((16, 8), (8, 4)):
        assert np.array_equal(demo_longvideo.windows(v, t, stride), jax_windows(v, t, stride))
    for t_win, overlap in ((16, 4), (8, 2)):
        got, want = demo_longvideo.seam_flicker(v, t_win, overlap), jax_seam_flicker(
            v, t_win, overlap)
        assert got.keys() == want.keys()
        for k in got:
            assert abs(got[k] - want[k]) <= 1e-12 * abs(want[k])


def test_psnr_matches_distill_sr_demo():
    rng = np.random.default_rng(2)
    a = rng.random((2, 4, 8, 8, 3)).astype(np.float32)
    for b in (a + 0.01 * rng.standard_normal(a.shape).astype(np.float32), a.copy()):
        assert abs(distill_sr_demo.psnr(a, b) - jax_psnr(a, b)) <= 1e-12 * abs(jax_psnr(a, b))


# ------------------------------------------------------------ port-only
TINY_UNET = dict(dim=8, dim_mults=(1, 2), num_resnet_blocks=1, attn_heads=2, attn_dim_head=8,
                 video_embed_dim=train_curve.EMB)
TINY = VideoDecoderConfig(
    unets=(UNet3DConfig(**TINY_UNET), UNet3DConfig(**TINY_UNET, attention_impl="flash")),
    frame_sizes=(8, 16), frame_numbers=(2, 4), timesteps=1000, sample_timesteps=(2, 2),
    learned_variance=False)
TINY_POOLS = ((6, 2, 8), (3, 4, 16))


def _curve(run, **kw):
    return train_curve.train_curve(run, 4, "cpu", config=TINY, pools=TINY_POOLS,
                                   sample_steps=2, **kw)


@pytest.fixture(scope="module")
def plain_curve(tmp_path_factory):
    """The uninterrupted 4-step-a-stage run (no reload): its directory and
    its trainer's state; the distill test's teacher too."""
    run = tmp_path_factory.mktemp("curve") / "plain"
    out = _curve(run, exercise_resume=False)
    assert out["trainer"].steps == [4, 4]
    return run, out["trainer"].state_dict()


def _equal(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def test_curve_run_reload_and_relaunch_bit_for_bit(tmp_path, plain_curve):
    """4 steps a stage at a narrow width: a run with its mid-run reload
    (stage 1, step 2) that then crashed in stage 2 after its periodic save
    and was relaunched (the batch stream replayed, the step keys
    recomputed) ends in the uninterrupted run's state (parameters, AdamW
    moments, EMA, counts) and samples, bit for bit; its loss log and
    heartbeat are where the elastic supervisor looks for them."""
    plain_run, plain_state = plain_curve
    run = tmp_path / "crashed"
    step = DecoderTrainer.train_step
    calls = []

    def crash(self, *a, unet_number, **kw):
        calls.append(unet_number)
        if calls.count(2) == 4:
            raise RuntimeError("crash")
        return step(self, *a, unet_number=unet_number, **kw)

    with mock.patch.object(train_curve, "SAVE_EVERY", 2), \
            mock.patch.object(DecoderTrainer, "train_step", crash), pytest.raises(RuntimeError):
        _curve(run)
    assert json.loads((run / "progress.json").read_text()) == {"stage": 2, "next_step": 2}
    with mock.patch.object(train_curve, "SAVE_EVERY", 2):
        again = _curve(run)
    _equal(again["trainer"].state_dict(), plain_state)
    samples = [np.load(d / "samples.npy") for d in (plain_run, run)]
    assert samples[0].shape == (2, 4, 16, 16, 3) and np.array_equal(*samples)
    summary = json.loads((run / "summary.json").read_text())
    assert summary["steps_per_stage"] == 4 and "2" in summary["ms_per_step"]
    logged = [json.loads(x) for x in (run / "curve.metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(r[k]) for r in logged for k in r if k.startswith("train/"))
    cmd = ["python", "-m", "dalle2_video_tpu_torch.train.train_curve", f"run_dir={run}",
           "train_name=curve"]
    assert str(run / "curve.heartbeat") in glob.glob(elastic.watch_glob(cmd))
    assert train_curve.parse_argv(["3", "run_dir=x", "resume=true"])["steps"] == 3


@pytest.mark.parametrize("mode", ["extend", "interpolate", "spatial"])
def test_replace_inpainting_keeps_the_known_region(mode):
    """demo_inpaint's replacement sampling on a narrow random decoder: the
    known region within 1e-6 of the reals, the rest generated."""
    dec = VideoDecoder(TINY, torch.device("cpu"))
    reals, embs = eval_quality.held_out(3, demo_inpaint.REAL_SEED, 2, 8)
    outs, dt = demo_inpaint.inpaint(dec, reals, embs, mode, "replace", batch=2, steps=2)
    known, gen = demo_inpaint.known_errors(outs, reals, demo_inpaint.masks_for(mode, 2, 8))
    assert outs.shape == reals.shape and dt > 0
    assert known <= 1e-6 and gen > 1e-2


def test_distill_curve_source_runs_and_scores(tmp_path, plain_curve):
    """python -m ...train.distill --curve on a narrow curve teacher: the
    phases (cut to 4 and 2 steps) on blob batches (one step each) from the
    curve's EMA unet 1,
    the students scored against held-out blob clips (N_EVAL 4) at their
    step counts with one request seed per sample, a finite FVD each, and
    the last student's grid."""
    curve, _ = plain_curve
    samples = []
    sample = VideoDecoder.sample

    def recording(self, keys, **kw):
        samples.append((self.sample_timesteps[0], len(keys)))
        return sample(self, keys, **kw)

    with mock.patch.object(eval_quality, "eval_config",
                           lambda: dataclasses.replace(TINY, sample_compute_dtype="bfloat16")), \
            mock.patch.object(distill, "N_EVAL", 4), mock.patch.object(distill, "EVAL_BATCH", 3), \
            mock.patch.object(distill, "CURVE_BATCH", 2), \
            mock.patch.object(distill, "PHASES", (4, 2)), \
            mock.patch.object(VideoDecoder, "sample", recording):
        out = distill.main(["--curve", str(curve), "--run", str(tmp_path / "d"), "--steps", "1",
                            "device=cpu"])
    assert samples == [(s, n) for s in (4, 2) for n in (3, 1)]
    assert all(np.isfinite(out[f"fvd_student{s}"]) for s in (4, 2))
    assert np.isfinite(out["fvd_real_vs_real_splithalf"])
    assert grid.read_png(tmp_path / "d" / "grid_student2.png").shape == (8 * 4, 8 * 8, 3)
