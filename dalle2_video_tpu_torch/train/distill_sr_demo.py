"""The SR stage's distillation witness on the curve teacher (the
counterpart of scripts/distill_sr_demo.py).

    python -m dalle2_video_tpu_torch.train.distill_sr_demo [--steps 300] \
        [--curve runs/r2_curve] [--run runs/distill_sr] [--device cuda]

Distils the curve cascade's SR unet (unet 2: 64 x 128^2, lowres-
conditioned, its joint attention through rows 1 and 2 of the kernel
table) to an ``STUDENT_STEPS``-step student, one fresh blob clip a step
(RandomState(7)), then shows the claim in pixel space, no extractor
needed: on the same base-stage video and the same SR keys (DDIM is
deterministic given x_T), the student's 8-step SR output lies closer (in
PSNR) to the teacher's 64-step SR output than the teacher's own 8-step
output does. Each step's draws come from a generator keyed on the step
alone (the script's fold_in(key, i)). Writes ``<run>/state`` (the
distill state), ``results.json`` and grids.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dalle2_video_tpu_torch.train.checkpoint import save_checkpoint
from dalle2_video_tpu_torch.train.distill import DistillConfig, DistillTrainer
from dalle2_video_tpu_torch.train.eval_quality import base_geometry, build, held_out, load_teacher
from dalle2_video_tpu_torch.train.train_curve import RUN, batch_keys, blob_videos
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device
from dalle2_video_tpu_torch.utils.grid import save_grid
from dalle2_video_tpu_torch.utils.keys import derive_generator
from dalle2_video_tpu_torch.utils.profiling import StepTimer

log = logging.getLogger("dalle2_video_tpu_torch.distill_sr_demo")

OUT = "runs/distill_sr"
STEPS = 300
B_TRAIN = 1  # the SR geometry (64 x 128^2); a distill step holds three forwards
B_EVAL = 2
STUDENT_STEPS = 8  # the few-step grid the student samples with
REF_STEPS = 64  # the many-step teacher reference
KEY_SEED = 42
EVAL_SEED = 9
LOG_EVERY = 50


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float(-10.0 * np.log10(max(mse, 1e-12)))


def distill_sr_demo(curve_run: Path = Path(RUN), run: Path = Path(OUT), steps: int = STEPS,
                    device: DeviceLike = None) -> Dict[str, Any]:
    dev = resolve_device(device)
    run = Path(run)
    run.mkdir(parents=True, exist_ok=True)
    _, dec = build(dev)
    load_teacher(dec, curve_run)
    teacher = {k: v.detach().clone() for k, v in dec.unets[1].named_parameters()}
    tr = DistillTrainer(dec, DistillConfig(student_steps=STUDENT_STEPS, unet_number=2))
    tr.init_state(teacher)

    data_rng = np.random.RandomState(7)
    t_frames, t_size = dec.config.frame_numbers[1], dec.config.frame_sizes[1]
    losses = []
    timer = StepTimer()
    timer.start()
    for i in range(steps):
        video, emb = blob_videos(data_rng, B_TRAIN, t_frames, t_size)
        tr.generator = derive_generator(KEY_SEED, i, device=dev)
        loss = tr.distill_step(torch.from_numpy(video).to(dev),
                               video_embed=torch.from_numpy(emb).to(dev))
        losses.append(float(loss))
        if i % LOG_EVERY == 0:
            log.info("step %d: loss %.5f", i, losses[-1])
    train_s = timer.stop()
    save_checkpoint(str(run / "state"), tr.state_dict())

    # the same base video and the same SR keys for the three variants
    _, eval_emb = held_out(B_EVAL, **base_geometry(dec.config))
    eval_emb = torch.from_numpy(eval_emb).to(dev)
    k_base, k_sr = batch_keys(EVAL_SEED, B_EVAL).split()
    base = dec.sample(k_base, video_embed=eval_emb, cond_scale=1.0, stop_at_unet_number=1)

    def sr(params, n_steps: int) -> Tuple[np.ndarray, float]:
        with torch.no_grad():
            for k, p in dec.unets[1].named_parameters():
                p.copy_(params[k])
        dec._sampling_unets.clear()  # the bf16 copy is rebuilt
        t = StepTimer()
        t.start()
        with torch.no_grad():
            out = dec.sample_stage(1, k_sr, batch_size=B_EVAL, prev_video=base,
                                   video_embed=eval_emb, cond_scale=1.0,
                                   sample_timesteps=n_steps)
        dt = t.stop(out)
        return out.float().cpu().numpy(), dt

    ref64, s_ref = sr(teacher, REF_STEPS)
    teacher8, s_t8 = sr(teacher, STUDENT_STEPS)
    student8, s_s8 = sr(tr.student_decoder_params([{}, teacher])[1], STUDENT_STEPS)
    results = {
        "steps_trained": steps,
        "student_steps": STUDENT_STEPS,
        "ref_steps": REF_STEPS,
        "loss_first10_mean": float(np.mean(losses[:10])) if losses else None,
        "loss_last10_mean": float(np.mean(losses[-10:])) if losses else None,
        "train_s": train_s,
        "psnr_teacher8_vs_ref64": psnr(teacher8, ref64),
        "psnr_student8_vs_ref64": psnr(student8, ref64),
        "sr_sample_s": {"ref64": s_ref, "teacher8": s_t8, "student8": s_s8},
    }
    (run / "results.json").write_text(json.dumps(results, indent=1))
    save_grid(run / "grid_sr_student8.png", student8)
    save_grid(run / "grid_sr_ref64.png", ref64)
    log.info("RESULT %s", json.dumps(results))
    return {**results, "trainer": tr}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS, help="distill steps")
    ap.add_argument("--curve", default=RUN, help="the curve's run directory (the teacher)")
    ap.add_argument("--run", default=OUT)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(level="INFO")
    return distill_sr_demo(Path(args.curve), Path(args.run), args.steps, args.device)


if __name__ == "__main__":
    main()
