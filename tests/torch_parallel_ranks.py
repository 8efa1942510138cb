"""The ranks of tests/test_torch_port_parallel.py: one process of a
4-rank gloo group on the CPU, running every case of the port's
``parallel/`` code on the inputs the test wrote, and saving what it saw.

    RANK=r WORLD_SIZE=4 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_parallel_ranks.py <inputs.pt> <out_dir> <second_port>

Imports torch and the port only (no JAX: the test holds the results to
the JAX package in its own process). A rank starts before the inputs
exist: it joins its group, then waits for ``<inputs.pt>``, and for
``clip.pt`` beside it before the CLIP case. Each case's results go to
``<out_dir>/rank<r>.pt``; the last case runs the decoder's entry point
twice (it joins the process group itself and tears it down, so its resume
joins a second one on ``second_port``).
"""

from __future__ import annotations

import copy
import logging
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dalle2_video_tpu_torch.data.datasets import BatchLoader  # noqa: E402
from dalle2_video_tpu_torch.data.worker_loader import make_worker_loader  # noqa: E402
from dalle2_video_tpu_torch.engine.decoder import VideoDecoder, VideoDecoderConfig  # noqa: E402
from dalle2_video_tpu_torch.models.layers import Attention  # noqa: E402
from dalle2_video_tpu_torch.models.unet3d import UNet3DConfig  # noqa: E402
from dalle2_video_tpu_torch.parallel import sp_attention  # noqa: E402
from dalle2_video_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh,
    active_mesh,
    create_mesh,
    maybe_init_distributed,
    shard_batch,
)
from dalle2_video_tpu_torch.parallel.sharded import (  # noqa: E402
    ShardedOptimizer,
    all_reduce_mean,
    make_sharded_distill_step,
    make_sharded_sample_stage,
    make_sharded_train_step,
    make_sharded_train_steps_scan,
    reduce_gradients,
    shard_draws,
    shard_state,
)
from dalle2_video_tpu_torch.serve.stack import (  # noqa: E402
    DataParallelGenerate,
    apply_smoke,
    build_generate_batch,
    serve_worker,
)
from dalle2_video_tpu_torch.train import load_latest  # noqa: E402
from dalle2_video_tpu_torch.train.__main__ import main as train_main  # noqa: E402
from dalle2_video_tpu_torch.train.checkpoint import RollingCheckpointManager  # noqa: E402
from dalle2_video_tpu_torch.train.clip_trainer import ClipTrainer, ClipTrainerConfig  # noqa: E402
from dalle2_video_tpu_torch.train.distill import DistillConfig, DistillTrainer  # noqa: E402
from dalle2_video_tpu_torch.train.trainer import DecoderTrainer, DecoderTrainerConfig  # noqa: E402
from dalle2_video_tpu_torch.models.clip_text import CLIPTextConfig  # noqa: E402
from dalle2_video_tpu_torch.models.vivit import ViViTConfig  # noqa: E402
from dalle2_video_tpu_torch.utils.config import load_config  # noqa: E402
from dalle2_video_tpu_torch.utils.keys import RowKeys  # noqa: E402
from dalle2_video_tpu_torch.weights import (  # noqa: E402
    load_clip_train_state_from_jax,
    load_from_jax,
    load_train_state_from_jax,
)

CPU = torch.device("cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a))


def decoder(inp, **unet_kw):
    ucfg = UNet3DConfig(**{**inp["unet"], **unet_kw})
    return VideoDecoder(VideoDecoderConfig(unets=(ucfg,), **inp["dec"]), device=CPU)


def trainer(inp, key="export"):
    """A DecoderTrainer on the JAX state the test exported."""
    t = DecoderTrainer(decoder(inp), DecoderTrainerConfig(**inp["trainer"]))
    load_train_state_from_jax(t, inp[key])
    return t


def params(t):
    return {k: v.detach().clone() for k, v in t.params(0).items()}


def full_state(t):
    """Params, EMA and the optimiser's state dict (gathered: collective;
    copied, as a torch optimiser's state dict holds its live tensors)."""
    return {"params": params(t), "ema": {k: v.clone() for k, v in t.ema[0].params.items()},
            "opt": copy.deepcopy(t.optimizers[0].state_dict())}


def case_dp(inp, mesh41, out):
    """DP + ZeRO-1 on (4, 1): two steps, and the scan of the same two."""
    vid, emb = _t(inp["video"]), _t(inp["embed"])
    t = shard_state(trainer(inp), mesh41)
    step = make_sharded_train_step(t, mesh41, 1)
    rows = [shard_batch(mesh41, (vid[j], emb[j])) for j in range(2)]
    out["dp_loss"] = [float(step(*rows[0], draws=inp["draws"][0]))]
    out["dp_step1"] = full_state(t)
    out["dp_moment_bytes"] = t.optimizers[0].moment_bytes()
    out["dp_loss"].append(float(step(*rows[1], draws=inp["draws"][1])))
    out["dp_step2"] = params(t)
    out["update_count"] = t.update_count(0)
    s = shard_state(trainer(inp), mesh41)
    losses = make_sharded_train_steps_scan(s, mesh41, 1)(
        torch.stack([r[0] for r in rows]), torch.stack([r[1] for r in rows]),
        draws=inp["draws"])
    out["scan_losses"] = losses.tolist()
    out["scan_params"] = params(s)
    # a non-finite batch on one rank: every rank skips the update
    bad = [r.clone() for r in rows[0]]
    if mesh41.rank == 2:
        bad[0][0] = float("nan")
    before = params(t)
    out["nan_loss"] = float(step(*bad, draws=inp["draws"][0]))
    out["nan_kept"] = all(torch.equal(before[k], v) for k, v in params(t).items())
    out["nan_counts"] = (t.update_count(0), t.steps[0])
    return t


def case_one_process(inp, out):
    """The same two steps in one process at the global batch."""
    t = trainer(inp)
    vid, emb = _t(inp["video"]), _t(inp["embed"])
    for j in range(2):
        t.train_step(vid[j], video_embed=emb[j], unet_number=1, draws=inp["draws"][j])
    out["one_process"] = params(t)


def case_tp(inp, mesh22, out):
    t = shard_state(trainer(inp), mesh22, tp=True, tp_min_width=8)
    rows = shard_batch(mesh22, (_t(inp["video"][0]), _t(inp["embed"][0])))
    out["tp_loss"] = float(make_sharded_train_step(t, mesh22, 1)(*rows, draws=inp["draws"][0]))
    out["tp_step1"] = params(t)
    out["tp_specs"] = t.optimizers[0].specs
    out["tp_moment_bytes"] = t.optimizers[0].moment_bytes()


def case_sp_mqa(inp, mesh14, out):
    leaves = {k: _t(inp["sp"][k]).requires_grad_(True) for k in ("q", "k", "v", "nk", "nv")}
    o = sp_attention.sequence_parallel_mqa(
        leaves["q"], leaves["k"], leaves["v"], mesh14, sm_scale=inp["sp"]["scale"],
        null_kv=(leaves["nk"], leaves["nv"]))
    (o ** 2).sum().backward()
    out["sp_out"] = o.detach()
    out["sp_grads"] = {k: v.grad for k, v in leaves.items()}


def case_sp_unet(inp, mesh22, out):
    """A unet with attention_impl sp against xla on the same params, and
    the fallback where the tokens do not divide the model axis."""
    calls = []
    real = sp_attention.sequence_parallel_mqa

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    sp_attention.sequence_parallel_mqa = counted
    try:
        got = {}
        for impl in ("sp", "xla"):
            dec = VideoDecoder(VideoDecoderConfig(
                unets=(UNet3DConfig(**{**inp["sp_unet"]["unet"], "attention_impl": impl}),),
                **inp["sp_unet"]["dec"]), device=CPU)
            dec.unets[0].load_state_dict(inp["sp_unet"]["params"])
            t = DecoderTrainer(dec, DecoderTrainerConfig(lr=1e-3, use_ema=False))
            shard_state(t, mesh22)
            vid, emb = shard_batch(mesh22, (_t(inp["sp_unet"]["video"]),
                                            _t(inp["sp_unet"]["embed"])))
            with active_mesh(mesh22):
                loss = t.backward(vid, video_embed=emb, unet_number=1,
                                  draws=shard_draws(inp["sp_unet"]["draws"], mesh22))
                loss = all_reduce_mean(loss, mesh22.data_group)
                reduce_gradients(list(dec.unets[0].parameters()), mesh22.data_group)
            got[impl] = (float(loss), {k: p.grad.clone() for k, p in
                                       dec.unets[0].named_parameters()})
        out["sp_unet"] = got
        out["sp_calls"] = list(calls)
        calls.clear()
        attn = Attention(16, heads=2, dim_head=8, impl="sp")
        x = _t(inp["sp"]["x_odd"])
        with active_mesh(mesh22), torch.no_grad():
            sp_out = attn(x)
        out["fallback"] = (len(calls), torch.equal(sp_out, attn(x, impl="xla")))
    finally:
        sp_attention.sequence_parallel_mqa = real


def case_clip(inp, mesh41, out):
    c = inp["clip"]
    x, y = (shard_batch(mesh41, _t(c[k])).requires_grad_(True) for k in ("x", "y"))
    temp = torch.tensor(c["temp"], requires_grad=True)
    from dalle2_video_tpu_torch.utils.contrastive import sharded_clip_loss

    loss = sharded_clip_loss(x, y, temp, mesh41)
    loss.backward()
    out["clip_loss"] = float(loss.detach())
    out["clip_grads"] = (x.grad, y.grad, temp.grad)
    tr = ClipTrainer(ViViTConfig(**c["vivit"]), CLIPTextConfig(**c["text"]),
                     ClipTrainerConfig(**c["cfg"]), device="cpu")
    load_from_jax(tr.text_encoder, c["text_params"])
    load_clip_train_state_from_jax(tr, c["state"])
    videos, tokens = shard_batch(mesh41, (_t(c["videos"]), _t(c["tokens"])))
    metrics = tr.make_sharded_train_step(mesh41)(videos, tokens)
    out["clip_step"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                        "params": {k: p.detach().clone() for k, p in tr.vivit.named_parameters()},
                        "temperature": float(tr.temperature)}


def case_distill(inp, mesh41, out):
    d = inp["distill"]

    def make():
        dec = decoder(inp)
        load_from_jax(dec.unets[0], d["teacher"])
        t = DistillTrainer(dec, DistillConfig(student_steps=4))
        t.init_state(student={k: _t(v) for k, v in d["student"].items()})
        return t

    t = make()
    vid, emb = shard_batch(mesh41, (_t(d["video"]), _t(d["embed"])))
    out["distill_dp"] = (float(make_sharded_distill_step(t, mesh41)(
        vid, video_embed=emb, draws=d["draws"])),
        {k: v.detach().clone() for k, v in t.student.items()})
    if mesh41.rank == 0:
        s = make()
        loss = s.distill_step(_t(d["video"]), video_embed=_t(d["embed"]), draws=d["draws"])
        out["distill_single"] = (float(loss), {k: v.detach().clone()
                                               for k, v in s.student.items()})


class _Indices:
    def __len__(self):
        return 32

    def batch_items(self, idx):
        return {"x": np.asarray(idx)}


def case_loaders(mesh41, out):
    kw = dict(shuffle=True, seed=7, shard_index=mesh41.data_index, num_shards=4)
    out["loader_thread"] = [b["x"].tolist() for b in BatchLoader(_Indices(), 2, **kw)]
    out["loader_workers"] = [b["x"].tolist() for b in make_worker_loader(
        _Indices(), 2, worker_count=0, **kw)]


def case_checkpoint(inp, t, mesh41, out, run_dir):
    """Save the (4, 1) trainer's state from rank 0; restore at 2 ranks and
    at 1."""
    state = t.state_dict()
    if mesh41.rank == 0:
        RollingCheckpointManager(run_dir).save(t.steps[0], state)
        out["saved"] = state
    dist.barrier()
    pair = dist.new_group([0, 1], backend="gloo")
    if mesh41.rank < 2:
        mesh2 = Mesh(2, 1, mesh41.rank, CPU, "gloo", data_group=pair, world_group=pair)
        r2 = trainer(inp)
        r2.load_state_dict(load_latest(run_dir))
        shard_state(r2, mesh2)
        if not isinstance(r2.optimizers[0], ShardedOptimizer):
            raise AssertionError("restored state is not sharded")
        out["restored_2"] = r2.state_dict()
    if mesh41.rank == 0:
        r1 = trainer(inp)
        r1.load_state_dict(load_latest(run_dir))
        out["restored_1"] = r1.state_dict()


@torch.no_grad()
def case_sample_stage(inp, mesh41, out):
    """make_sharded_sample_stage: stage 1 for 4 rows over (4, 1)."""
    dec = trainer(inp).decoder
    keys, emb = RowKeys.from_request_seeds([1, 2, 3, 4]), _t(inp["embed"][0])
    fixed = dict(cond_scale=1.0, sample_timesteps=2)
    out["stage_dp"] = make_sharded_sample_stage(dec, mesh41, 0, **fixed)(keys, emb)
    out["stage_single"] = dec.sample_stage(0, keys, batch_size=4, video_embed=emb, **fixed)


def case_sampler(mesh41, out, run_dir):
    cfg = dict(apply_smoke(load_config(None)), run_dir=run_dir)
    gen = build_generate_batch(cfg, logging.getLogger("ranks"), device="cpu")
    dp = DataParallelGenerate(gen, mesh41)
    kw = dict(cond_scale=3.0, ddim_steps=2)
    prompts, seeds = ["a cat", "a dog", "a red car", "the sea"], [5, 6, 7, 8]
    if mesh41.rank != 0:
        out["served"] = serve_worker(dp)
        return
    out["dp_videos"] = dp(prompts, seeds, **kw)
    dp.stop()
    out["single_videos"] = gen(prompts, seeds, **kw)


def _wait_for(path: Path, seconds: float = 300.0) -> None:
    """The test writes the inputs while the ranks start (each file by an
    atomic rename): wait for one, for at most ``seconds``."""
    deadline = time.time() + seconds
    while not path.exists():
        if time.time() > deadline:
            raise TimeoutError(f"no inputs at {path} after {seconds} s")
        time.sleep(0.05)


def main(inputs: str, out_dir: str, second_port: str) -> None:
    torch.set_num_threads(1)
    logging.basicConfig(level=logging.WARNING)
    maybe_init_distributed(True, device="cpu")
    rank = dist.get_rank()
    meshes = {(d, m): create_mesh(d, m) for d, m in ((4, 1), (2, 2), (1, 4))}
    _wait_for(Path(inputs))
    inp = torch.load(inputs, weights_only=False)
    out = {"seconds": {}}
    clock = time.time()

    def timed(name, fn, *a):
        nonlocal clock
        res = fn(*a)
        out["seconds"][name] = time.time() - clock
        clock = time.time()
        return res

    t = timed("dp", case_dp, inp, meshes[4, 1], out)
    if rank == 0:
        timed("one_process", case_one_process, inp, out)
    timed("tp", case_tp, inp, meshes[2, 2], out)
    timed("sp_mqa", case_sp_mqa, inp, meshes[1, 4], out)
    timed("sp_unet", case_sp_unet, inp, meshes[2, 2], out)
    clip = Path(inputs).with_name("clip.pt")
    _wait_for(clip)
    inp["clip"] = torch.load(clip, weights_only=False)
    timed("clip", case_clip, inp, meshes[4, 1], out)
    timed("distill", case_distill, inp, meshes[4, 1], out)
    timed("loaders", case_loaders, meshes[4, 1], out)
    timed("checkpoint", case_checkpoint, inp, t, meshes[4, 1], out, str(Path(out_dir) / "ckpt"))
    timed("sample_stage", case_sample_stage, inp, meshes[4, 1], out)
    timed("sampler", case_sampler, meshes[4, 1], out, str(Path(out_dir) / "no_checkpoints"))
    # the decoder's entry point: it tears the group down after training,
    # so the resume joins a new one on the second port
    run = Path(out_dir) / "entry"
    args = ["smoke=true", "device=cpu", f"run_dir={run}", "mesh.data=-1",
            "decoder.bf16_compute=false", "dim=16", "log_level=WARNING"]
    timed("entry", train_main, args)
    os.environ["MASTER_PORT"] = second_port
    timed("resume", train_main, args + ["resume=true"])
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


if __name__ == "__main__":
    main(*sys.argv[1:4])
