#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py             # all phases, one card
    python3 chip_smoke.py --profile   # and a per-layer / per-kernel profile

Phases (any failure exits non-zero and prints no result line):
  1. environment: card name and power limit, torch / CUDA versions, and the
     parallel nvcc build of every kernel under dalle2_video_tpu_torch/csrc/;
  2. kernels: each hand-written kernel against its plain PyTorch version on
     the card, in bf16, at the shapes the serving path gives it, with
     kernel / plain / library times and the card's lower bound; the flash
     forward timed at the serving shape and the probes' geometry, and
     checked at the cascade's and the training shapes (FLASH_FWD_CASES),
     the backward at the training, cascade and probe shapes
     (FLASH_BWD_CASES); the cross-attention (row 5) at every shape the
     serving paths give it (SERVE_SITES of probes/xattn_rows.py, at the CFG
     batch of a group of one and of two requests), each timed, and summed
     over one DDIM step beside that step's bound; past 16 keys (the long
     route: per-frame and text tokens) at every m of LONG_MS (bf16 and f32)
     and at every shape serve_text gives it (TEXT_SITES), each timed beside
     its bound and SDPA, each serve_text request's DDIM step summed
     (check_xattn_text); the GroupNorm kernels
     (rows 3, 4 and 9) at every (batch, shape) the paths give them
     (probes/gn_rows.py: the map), each held and timed, row 3 summed over
     one serve DDIM step at each CFG batch;
     The backward kernels are checked the same way at the training shapes
     (bf16, and one f32 case each), and so are the opt-in conv paths'
     kernels (the 3x3 conv and its dx, its weight gradient, the conv + bias
     + statistics forward, the fused block's GroupNorm backward): the three
     convs at every shape the conv paths give them (CONV_SHAPES,
     the sites of probes/conv_rows.py), with their plans logged. Every kernel that sums gives
     two bit-equal calls (the GroupNorm kernels, rows 3, 4 and 9, too);
     rows 1, 3 and 5 also at batch 1, the distilled student's unguided
     serving batch (check_student_kernels), each summed over one DDIM step;
     rows 1 and 2 at the curve recipe's SR bottleneck, q (b, 262144, 32),
     kv (b, 16385, 32): row 1 in bf16 at batch 1, 2 and 4 and in f32 at 1
     and 4, row 2 at batch 1 on the CUDA cores (check_curve_kernels);
  3. module check: small UNet3Ds with the kernel impls against the same
     weights on the plain impls, f32 and bf16; then one loss's gradients
     through both, bf16 compute over f32 masters. Two cases: the serving /
     training kernels, and the conv paths (groupnorm_impl fused,
     spatial_conv_impl pallas_small);
  4. serve: the full-width celebv_text stack at the 90-frame recipe
     (frame_numbers [90, 90], cross_attention_impl flash, bf16 unets,
     random weights from a seed) behind GenerationEngine with buckets
     (1, 2), on each path of SERVE_PATHS: "serve" (groupnorm_impl pallas,
     REQUESTS requests, STEPS DDIM steps per stage) and "serve_conv" (the
     conv paths, fewer requests and steps). Every request must return a
     finite (90, 128, 128, 3) video in [0, 1], and every kernel's launch
     count over the path's run must equal what the unet structure predicts
     (no backward kernel);
  4b. serve_options: the request options of scripts/serve.py::generate_batch
     on the serve recipe (random weights from seed 0, output convs redrawn),
     OPTION_STEPS DDIM steps a stage, one request at a time through
     GenerationEngine: first the serve stack (flash cross-attention) must
     refuse guided inpainting, launching nothing; then (a) a negative prompt
     (it must change the plain request's video), (b) inpainting by
     replacement of the first OPTION_KNOWN of 90 frames (they must equal the
     conditioning video nearest-resized to 128 px within 1e-6), (c) the
     same by guidance on a stack with cross_attention_impl xla (rows 1-4
     inside the sampler), (d) a long video of OPTION_FRAMES frames (3
     windows; every window must reproduce the frames earlier ones emitted
     within 1e-6), (e) the DPM++ sampler. Every video finite, in [0, 1], of
     its shape; every request's launches and the path's as the unet
     structure predicts (rows 2 and 4 under (c) only, the flash backward on
     the tensor cores), the kernel shapes the map's; each request's wall
     time and frames/s printed with the card. Then the three
     cross-attention routes (broadcast, xla, row 5) timed at the 7 serving
     shapes;
  4c. serve_text: the serve recipe with every unet and the prior
     conditioned on the 12 x 512 text tower's encodings (max_text_len 256,
     built with dataclasses.replace: TEXT_UNET), TEXT_STEPS DDIM steps a
     stage, one request at a time through DALLE2Video.generate: (a) a
     global video embed, then the same with negative text encodings, (b)
     temporal_emb on a decoder whose unet 1 takes per-frame embeds (90
     prior rows, best-of-2); launches of rows 1, 3 and 5 and row 5's
     shapes (TEXT_REQUESTS) as the structure predicts;
  5. train: the decoder training path at the same widths and recipe
     (attention_impl auto -> flash at the 5760-token bottlenecks,
     cross_attention_impl xla, bf16 compute, batch 2) on synthetic
     90x128x128 videos, on each path of TRAIN_PATHS: "train" (groupnorm_impl
     pallas, with a checkpoint round trip) and "train_conv" (the conv
     paths): its steps of each unet, one eval_loss each; finite losses,
     every parameter moved, EMA step counts, every step's launch counts
     as the unet structure predicts, and no weight-gradient shape that
     phase 2 did not check. Prints ms per step, samples/s and peak
     memory;
 5a. train_text: the "train" recipe with text encodings from the frozen
     text tower on both unets and per-frame embeds on unet 1
     (text_cond_drop_prob 0.5), TEXT_TRAIN_STEPS steps a unet and
     eval_loss: finite losses, every parameter moved, EMA counts, rows 1-4
     and the GroupNorm calls as the structure predicts;
 5b. stages 1 and 2 (the README's train_clip -> eval_clip -> train_prior),
     which launch no kernel: "train_clip" times CLIP_STEPS steps of the
     recipe's ViViT (224^2, patch 56, 150 frames, dim 512, depth 2, 3 x 64
     heads) against the frozen 12 x 512 text tower at clip.batch_size 64 on
     seeded device tensors (finite loss, every ViViT parameter and the
     temperature moved, the text tower bit for bit unchanged, the lr the
     multistep schedule's at each step), writes a .vshard store of 10
     CLIP-normalised clips at the preprocessor's celebv_text shape (3, 150,
     224, 224) f32 and their tokens to a temporary directory (the reader
     built by g++ from native/shard_reader.cpp), runs python -m
     ...train.train_clip on it (2 epochs at batch 2) and ...train.eval_clip
     (the handoff: 10 + 10 embeddings, the tail included, each the towers'
     output on its clip, eval's text tower bit for bit train's, the
     retrieval logged); "train_prior" times PRIOR_STEPS steps of the
     recipe's prior at prior.batch_size 256 (finite losses, every parameter
     moved), then runs python -m ...train.train_prior on the handoff with
     an EMA and reloads its checkpoint exactly. Each prints ms per step,
     samples/s and peak memory;
 5c. train_data: the "train" recipe trained from that store and the
     handoff's video embeddings through the entry point's data path
     (train/__main__.py: the dataset and split main builds from
     videos.preprocessed / videos.embed, train_decoder, loader grain = 4
     worker processes, pinned batches copied without blocking), 3 steps of
     each unet at batch 2, the validation batch and a checkpoint. Every
     batch the trainer receives must equal the store's clips in
     BatchLoader's order (the embeddings the handoff's), every loss be
     finite, the step and EMA counts right, every step's launches and the
     GroupNorm calls as the unet structure predicts; paired_random_crop on
     the card must equal its CPU result at the same offsets. Prints ms per
     step, samples/s, peak memory and the loop's wait on the loader beside
     each step;
 5d. serve_trained: the serve recipe built from the stages' run directory
     (build_stack: the prior's checkpoint, its EMA shadow; the decoder's
     best state's EMA shadows, each checked equal bit for bit) answers one
     request at OPTION_STEPS DDIM steps a stage: a finite (90, 128, 128, 3)
     video in [0, 1] and serve_options' plain request's launches;
 5d'. import_reference: the reference's torch checkpoints drawn from the
     importers' walks (models/torch_import.py) at full width: a ViViT at the
     CLIP recipe through train_clip.main and eval_clip.main with
     torch_vivit_ckpt (the imported tower the drawn tensors under the walk's
     conversions, bit for bit), flops_of of one batch-64 CLIP step beside
     clip_step_flops (more than FLOP_RATIO_FAIL apart fails); a decoder with
     non-parameter buffers among its keys loaded into the serve recipe's
     stack (bit for bit, exactly the buffers skipped) answering one request
     at OPTION_STEPS (rows 1, 3, 5 as serve_trained's); the trainer bundle
     (EMA shadows + 1, steps set) into the "train" recipe's trainer, then
     one step per unet (rows 1-4 as train's); walls from StepTimer;
 5e. distill: progressive distillation (train/distill.py) of the "train"
     recipe's decoder at full width (teacher from seed 0, bf16 sampling
     unets, xla cross-attention, batch 2 of synthetic videos): unet 1
     DISTILL_STEPS steps at 32 student steps under guidance 2.0, then at 16
     and w 1 with the first phase's EMA student as teacher, unet 2 (the SR
     stage) at 32; finite losses, every student parameter moved, the
     teacher bit for bit unchanged, the EMA exact, rows 1-4 per step as the
     structure predicts (three forwards, one backward); then python -m
     ...train.distill on the stages' store (the teacher: train_data's
     checkpoint) through its four phases at DISTILL_ENTRY_STEPS a phase,
     then its scoring: DISTILL_N_EVAL held-out clips (the split at
     DISTILL_TRAIN_RATIO) at DISTILL_EVAL_BATCH, each student sampled
     unguided at its own step count through rows 1, 3 and 5
     (score_expected), the anchor and each FVD finite and not below
     -1e-6 x the anchor's scale;
 5f. serve_student: the serve recipe with serve_distill on the entry
     point's 4-step student (slot 1 its EMA, the grid pinned to (4,
     OPTION_STEPS)), two requests at cond_scale 1 (the second warm): rows 1,
     3 and 5 at batch 1 as the structure predicts (held at batch 1 in phase
     2: check_student_kernels); wall, frames/s and peak memory;
 5g. train_vqgan: python -m ...train.train_vqgan on the stages' store at
     the vqgan section's full widths, batch 8, disc_start 2 (reduced from
     1000: the gate opens in the run), 3 epochs then resume=true to 5
     (VQGAN_ARGS, VQGAN_EPOCHS); one PatchDiscriminator and one
     VectorQuantizer forward held to the CPU; no kernel;
 5h. latent: the VQVAE restored from that checkpoint as the frozen VAE of
     scripts/train_latent90.py's decoder (engine/decoder.py::
     latent90_decoder; 90 x 32 x 32 x 4 latents of 90 x 128^2 pixels):
     LATENT_STEPS bf16 train steps at batch 2 (the VAE unchanged), one DDIM
     request (CFG 2, LATENT_DDIM steps) decoded to 90 x 128^2 x 3 and one
     inpainting request; rows 1-5 counted exactly (latent_launches) at the
     map's shapes (probes/gn_rows.py::latent_sites; rows 1 and 2 at this
     bottleneck held in phase 2: FLASH_FWD_CASES, FLASH_BWD_CASES);
 5i'. parallel: the data and model axes (dalle2_video_tpu_torch/parallel/)
     on the one card, after the kernels are built: PAR_RANKS ranks
     (`chip_smoke.py --parallel-rank DIR`) share it over gloo: train_dp
     (the train path's unet 1 at mesh {data 2, model 1}, global batch 2,
     ZeRO-1, the reduced gradient once then PAR_DP_STEPS steps: the ranks'
     losses and parameters bit for bit equal, each within the one-process
     batch-2 steps' losses (PAR_LOSS_RTOL), gradient (PAR_GRAD_RTOL) and
     parameters after the steps (PAR_PARAM_RTOL per tensor), the moment
     bytes per rank logged), train_sp (mesh {data 1, model 2},
     attention_impl sp: rows 1 and 2 at one rank's query shard, PAR_SP_SHAPES,
     counted exactly; the same holds) and serve_dp (2 requests of the serve
     recipe at OPTION_STEPS split over the ranks through
     serve/stack.py::DataParallelGenerate, each row bit for bit the request
     served alone by one process); each run's launches are each rank's, summed in
     launches_by_run, each rank's in launches_by_rank. Then the prior's
     model axis on the same ranks: prior_pp (the recipe's prior pipelined
     over 2 stages at M = 4, batch 256: the gradient, PRIOR_PAR_STEPS steps,
     a 64-step sample at cond_scale 2) and prior_ep (8 experts, 4 a rank:
     the gradient, the steps), each held to one process (PRIOR_PAR_*
     holds), the replicated parameters bit for bit equal on the ranks, each
     rank's parameter and moment bytes logged, no kernel launched. The
     decoder's entry point under torchrun --nproc_per_node=1 (NCCL,
     smoke=true, mesh.data=-1) must train one batch through both unets, and
     the prior's (pipeline_microbatches 4: its local loop) its 2 steps;
 5j. sample_cli: python -m dalle2_video_tpu_torch.serve.sample (the README's
     stage 5) at the serve recipe, its config asking SAMPLE_CLI_STEPS DDIM
     steps a stage, random weights from sample_seed: the plain request
     through the CLI's main (its .npy float32 (1, 90, 128, 128, 3), finite,
     in [0, 1]) equal bit for bit to build_generate_batch's video for the
     same prompt and seed at batch 1; then through the CLI's request
     handling on that callable inpainting of frames 0 and 1 of a 64 px
     known clip (kept within 1e-6 of it resized to 128 px), a negative
     prompt and a long video of SAMPLE_CLI_FRAMES frames (2 windows); rows
     1, 3 and 5 per request as the unet structure predicts;
 5k. curve: train/train_curve.py's recipe (configs/cascade_sr.yaml's
     geometry, 50.2M + 14.1M parameters, bf16 compute, batch 8 then 1) at
     CURVE_STEPS steps a stage on its blob corpus: the losses finite, the
     last 10 steps' mean below the first 10's per stage, the mid-run reload
     equal to the state saved before it exactly, the end sample in [0, 1];
     then on that teacher eval_quality (CURVE_N clips, CURVE_LADDER, the
     cascade grid), demo_inpaint's extension (its known region within
     1e-6), demo_longvideo (CURVE_LONG_FRAMES frames), distill --curve
     (CURVE_DISTILL_PHASES, a step each) and the SR witness
     (CURVE_SR_STEPS steps), every number finite; rows 1 and 2 at the SR
     unet's bottleneck (held there in phase 2: check_curve_kernels)
     counted exactly, every backward on the CUDA cores (batch 1);
 5i. train_prior_moe: the recipe's prior with 8 experts a layer and
     self-conditioning, PRIOR_STEPS steps at batch 256 (finite loss and
     aux, every parameter moved), one best-of-2 64-step sample; no kernel;
  6. probes: the flash probes' variants (rows 10 and 11: the r2 forward, at
     block_k 1024 and 2048, and the inner-kv forward, inner 2 / 4 x chain /
     par) against their plain versions at the probes' geometry (bf16, q
     (2, 368640, 32), kv (2, 23041, 32)) and at probe 9's check_small
     (f32, against exact softmax); then the probes' own rows
     (dalle2_video_tpu_torch/probes/perf_r3_probe{8,9}.py: r2, the fused
     forward, with lse, the full VJP, inner 2 / 4 x chain / par, SDPA) with
     exact launch counts;
  7. cascade: configs/cascade_sr.yaml with the JAX package's recipe
     (engine/decoder.py::cascade_sr_overrides), full width: "serve_cascade"
     (1 request, DDIM cut to CASCADE_STEPS per stage, cond_scale 3.0: a
     finite (64, 128, 128, 3) video in [0, 1], row 1 at both sampling unets
     and nothing else) and "train_cascade" (batch 4, bf16 compute, the SR
     unet's remat_policy conv: 3 steps of each unet and one eval_loss, row 1
     and row 2 once per SR-unet step). The module checks also hold the
     temporal-SR layers (TemporalAttention, LinearAttention,
     NearestUpsample3D, the temporal_conv unet) on the card to the same
     modules on the CPU, and the remat policies' gradients (bit for bit on
     both conv-path routes, REMAT_CASES) and recompute launches on the
     conv paths' kernels, every resize method on the card against the CPU
     and the CLIP adapters over the CLIP stage's towers
     (check_resize_and_adapters). Every path's run records the shapes that reach
     the three conv kernels, the cross-attention and the GroupNorm kernels
     (ShapeRecord) and fails unless they are the path's own
     (conv_path_shapes; serve_shapes: the 7 cross-attention shapes at their
     site counts, at each group's CFG batch, on serve and serve_conv, none
     elsewhere; gn_path_calls: rows 3, 4 and 9 by (batch, shape) from the
     map), all of them checked in phase 2.
Then it prints the phase times, the {"kernels": [...]} line, the card line,
and as the last line {"ok": true, "device": {...}}.

Bounds (bound_ms) are the larger of bytes / 3.35 TB/s and operations /
peak: 989 TFLOP/s for the products (H100 SXM, dense bf16), and for the
flash kernel's exponentials 132 SMs x 16 per clock x 1.98 GHz = 4.18e12 per
second (the special-function unit rate for exp2 at compute capability 9.0,
CUDA C++ Programming Guide throughput table). Bytes count each input read
once and each output written once. The flash backward's operations are its
five (n_q x n_kv x d) products and one exponential per probability.

Kernel tolerances scale with the output: |kernel - plain| <= atol +
rtol * |plain|. Both sides end in a bf16 rounding, and one bf16 step is at
most 2^-7 = 7.8e-3 of the value, so rtol 1e-2 admits one rounding flip
anywhere; atol covers the f32 work before the rounding near zero. The bf16
flash forwards (rows 1, 10, 11) are also held to one bf16 step per value
and to an f64 oracle of their function (hold_flash), at the JAX block
sizes, and each prints its share of bf16 values that differ. The bf16
cross-attention (row 5) is held to the JAX kernel's function
(ops/cross_attention.py::fused_cross_attention_reference) by
probes/xattn_rows.py::hold_bf16: the same tolerance, widened only by the
flips of probabilities that lie within an f32 rounding of a bf16 midpoint,
at most 0.05% of its values differing. The bf16 GroupNorm kernels (rows 3,
4, 9) keep their standing tolerances and are held besides by
probes/gn_rows.py's hold_fwd / hold_bwd: one bf16 step per value (at no
less than 2^-8 of its channel's largest |value|), a share differing, the
f64 oracle, the statistics and dA, dB, with bounds set from the measures of
the kernels before their one-launch redesign; the forward at inputs of
mean 30 (one-pass cancellation) to those kernels' share from the oracle.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
import time
from collections import Counter

try:
    from dalle2_video_tpu_torch.engine.decoder import cascade_sr_overrides
    from dalle2_video_tpu_torch.probes import card_line, time_ms
    from dalle2_video_tpu_torch.probes.conv_rows import (
        FUSED_SITES,
        KERNELS,
        TRAIN_BT,
        all_shapes,
        conv_path_shapes,
    )
    from dalle2_video_tpu_torch.probes import gn_rows
    from dalle2_video_tpu_torch.probes.xattn_rows import BATCHES as XA_BATCHES
    from dalle2_video_tpu_torch.probes.xattn_rows import (
        LONG_MS,
        SERVE_SITES,
        TEXT_LEN,
        TEXT_REQUESTS,
        TEXT_SITES,
        hold_bf16,
        serve_shapes,
        sites_per_step,
        text_shapes,
    )
    from dalle2_video_tpu_torch.probes.xattn_rows import bound as xa_bound
except ImportError as exc:
    print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
    sys.exit(2)

REQUESTS = 3  # served as a group of 2 and a group of 1
STEPS = 50  # DDIM steps per stage, sized to the 1200 s limit
CASCADE_STEPS = 10  # DDIM steps per stage of serve_cascade (the recipe: 64)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
EXP_PER_S = 132 * 16 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def library_time(name: str, fn):
    """Time a PyTorch yardstick call; None (and a log line) if it refuses."""
    try:
        return time_ms(fn)
    except RuntimeError as exc:
        log(f"library call for {name} failed: {exc}")
        return None


def sdpa_backward_alone(torch, qh, kh, vh, goh, sc):
    """A call of SDPA's flash backward alone
    (``aten._scaled_dot_product_flash_attention_backward``), fed with its
    forward's saved outputs."""
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(qh, kh, vh, 0.0, False, False,
                                                             scale=sc)
    out, lse, cq, ck, mq, mk, seed, offset = fwd[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        goh, qh, kh, vh, out, lse, cq, ck, mq, mk, 0.0, False, seed, offset, scale=sc)


def check(name, label, out, ref, atol, rtol):
    """max |out - ref| and the worst share of atol + rtol*|ref| it uses;
    raises if any element is outside the tolerance."""
    diff = (out.float() - ref.float()).abs()
    e = float(diff.max())
    worst = float((diff / (atol + rtol * ref.float().abs())).max())
    log(f"{name} {label}: max_abs_err={e:.3e} (tol {atol:g} + {rtol:g}*|ref|, "
        f"worst share of it {worst:.3f})")
    if not worst <= 1.0:
        raise AssertionError(f"{name} disagrees with its plain version")
    return e, f"{atol:g} + {rtol:g}*|ref|"


def bound(bytes_moved: float, flops: float = 0.0, exps: float = 0.0):
    t = {"bytes": bytes_moved / HBM_BYTES_PER_S,
         "operations": max(flops / BF16_FLOP_PER_S, exps / EXP_PER_S)}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


def rel(name, label, parts, outs, refs, rtol, atol_frac):
    """check() on every output; atol is atol_frac of that output's largest
    plain value (the f32 sums' order error scales with it)."""
    errs = []
    for part, o, r in zip(parts, outs, refs):
        atol = atol_frac * float(r.float().abs().max())
        errs.append(check(name, f"{label} {part}", o, r, atol=atol, rtol=rtol)[0])
    return max(errs), f"{atol_frac:g}*max|ref| + {rtol:g}*|ref|"


# --------------------------------------------------------------- phase 2
# The flash forward (row 1) at the other shapes the main paths and the
# probes give it, checked untimed at the JAX auto rule's block_k:
# serve_cascade's two sampling bottlenecks (CFG batch 2; unet 1 at 16x8x8
# tokens, unet 2 at 64x8x8), train_cascade's SR-unet forward (batch 4, with
# the lse), train's (the serving shape, with the lse) and the probes'
# geometry with the lse. (label, batch, tokens, save_lse)
FLASH_FWD_CASES = [("serve_cascade unet 1", 2, 16 * 8 * 8, False),
                   ("serve_cascade unet 2", 2, 64 * 8 * 8, False),
                   ("train_cascade unet 2", 4, 64 * 8 * 8, True),
                   ("train", 2, 90 * 8 * 8, True),
                   ("probe geometry", 2, 23040, True),
                   # the latent stage's unet: 8 heads of 32 at its 5,760-token
                   # bottleneck, sampled at CFG batch 2 and trained at batch 2
                   ("latent sample", gn_rows.LATENT_SERVE_BATCH, 90 * 8 * 8, False, 8),
                   ("latent train", 2, 90 * 8 * 8, True, 8)]
# The flash backward (row 2): (dtype, label, (batch, query rows, keys)) and
# the route it takes (ops/flash_mqa.py::bwd_rounds, the JAX "auto" rule:
# bf16 at batch >= 2 on the tensor cores, else all f32 on the CUDA cores);
# the "train celebv" case is timed for the kernel row
FLASH_BWD_CASES = [("float32", "f32 check", (2, 333, 65), "cuda_cores"),
                   ("bfloat16", "batch 1 (f32 math)", (1, 1000, 5761), "cuda_cores"),
                   ("bfloat16", "train celebv", (2, 90 * 8 * 8 * 16, 90 * 8 * 8 + 1),
                    "tensor_cores"),
                   ("bfloat16", "train_cascade unet 2", (4, 64 * 8 * 8 * 16, 64 * 8 * 8 + 1),
                    "tensor_cores"),
                   ("bfloat16", "latent train", (2, 90 * 8 * 8 * 8, 90 * 8 * 8 + 1),
                    "tensor_cores"),
                   ("bfloat16", "probe 8 VJP", (2, 23040 * 16, 23041), "tensor_cores")]


# The bf16 flash forwards (rows 1, 10, 11) compute the JAX kernels' function
# (p rounded to bf16 relative to a running max moved once per block_k keys).
# Two f32 implementations of it differ where a probability lands within an
# f32 rounding of a bf16 rounding boundary: each such flip moves the
# outputs of its row by a fraction of a bf16 step at the row's scale, and
# their share grows with the keys per row. So each forward is held to its
# plain version by the standing tolerance, by one bf16 step per value (at
# no less than its row's largest |value|: at serve_cascade's 4,097 keys the
# plain version's own f32 error put a small output 1.5 steps of the
# output's RMS from the f64 oracle, which the kernel matched), and on
# ORACLE_ROWS query rows to an f64 oracle of the same function (the plain
# version with work=torch.float64): the kernel's share of values that differ
# from the oracle may exceed the plain version's own by ORACLE_MARGIN at
# most. Every share is printed.
ORACLE_ROWS = 2048
ORACLE_MARGIN = 0.0025


def bf16_steps(torch, out, ref):
    """Share of values that differ, and the largest difference in bf16
    steps of the larger value, taken at no less than the row's largest
    |value| (a probability's flip moves every output of its row by an
    amount set by the row's scale, not by the value's own size)."""
    out, ref = out.float(), ref.float()
    differ = out != ref
    if not bool(differ.any()):
        return 0.0, 0.0
    scale = torch.maximum(torch.maximum(out.abs(), ref.abs()), ref.abs().amax(-1, keepdim=True))
    _, e = torch.frexp(scale)
    step = torch.ldexp(torch.ones_like(scale), e - 8)
    return float(differ.float().mean()), float(((out - ref).abs() / step)[differ].max())


def hold_flash(torch, name, label, got, want, oracle):
    """The bf16 flash forward checks (see ORACLE_ROWS): the standing
    tolerance, one bf16 step, and the oracle margin. Returns max |got -
    want| and the tolerance text."""
    e, tol = check(name, label, got, want, atol=5e-4, rtol=1e-2)
    share, steps = bf16_steps(torch, got, want)
    rows = oracle.shape[1]
    kern_o = bf16_steps(torch, got[:, :rows], oracle)[0]
    plain_o = bf16_steps(torch, want[:, :rows], oracle)[0]
    log(f"  bf16 values that differ: {100 * share:.4f}% from the plain version (at most "
        f"{steps:.2f} bf16 steps); on {rows} rows from the f64 oracle: kernel "
        f"{100 * kern_o:.4f}%, plain {100 * plain_o:.4f}%")
    if steps > 1.0:
        raise AssertionError(f"{name} {label}: a value differs by {steps:.2f} bf16 steps")
    if kern_o > plain_o + ORACLE_MARGIN:
        raise AssertionError(f"{name} {label}: {100 * kern_o:.4f}% of values differ from the "
                             f"f64 oracle, the plain version's {100 * plain_o:.4f}%")
    return e, f"{tol}, <= 1 bf16 step, oracle share <= plain's + {ORACLE_MARGIN:g}"


def row1_case(torch, fm, g, dev, b, n, h, d):
    """q (b, n h, d), kv (b, n + 1, d) bf16: a joint bottleneck with its
    null kv; block_k is the JAX auto rule's."""
    bf = torch.bfloat16
    q = torch.randn(b, n * h, d, generator=g, device=dev).to(bf)
    k = torch.randn(b, n + 1, d, generator=g, device=dev).to(bf)
    v = torch.randn(b, n + 1, d, generator=g, device=dev).to(bf)
    return q, k, v, fm.auto_fwd_blocks(n * h, n + 1)[1]


def check_row1(torch, fm, label, q, k, v, sc, bk, save_lse=False):
    """Row 1 at one shape: the kernel against its plain version and the
    f64 oracle, two calls bit-equal."""
    got = fm.flash_mqa_fwd(q, k, v, sm_scale=sc, save_lse=save_lse)
    want = fm.flash_mqa_reference(q, k, v, sc, save_lse, block_k=bk)
    oracle = fm.flash_mqa_reference(q[:, :ORACLE_ROWS], k, v, sc, block_k=bk,
                                    work=torch.float64)
    shape = f"{label} b={q.shape[0]} n_q={q.shape[1]} n_kv={k.shape[1]} d={q.shape[2]} block_k={bk}"
    again = fm.flash_mqa_fwd(q, k, v, sm_scale=sc, save_lse=save_lse)
    if save_lse:
        e, tol = hold_flash(torch, "flash_mqa_fwd", f"{shape} out", got[0], want[0], oracle)
        # f32 on both sides; a probability's bf16 flip moves l by 2^-8 at most
        check("flash_mqa_fwd", f"{shape} lse", got[1], want[1], atol=1e-4, rtol=0.0)
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
    else:
        e, tol = hold_flash(torch, "flash_mqa_fwd", shape, got, want, oracle)
        same = torch.equal(got, again)
    if not same:
        raise AssertionError(f"flash_mqa_fwd {shape}: two calls differ")
    return e, tol


# Rows 3, 4 and 9 at every (batch, shape) the paths give them
# (probes/gn_rows.py: the map, counted on meta tensors), each held by
# gn_rows' hold on well-conditioned inputs (one bf16 step, the share that
# differs, the f64 oracle, the statistics or dA / dB) and, at MEAN30_SHAPES,
# on inputs of mean 30 (the forward: its share from the oracle), timed
# beside its byte bound; the JSON row is the timed shape's, and row 3 is
# also summed over one serve DDIM step at each CFG batch.
GN_TIMED = {gn_rows.FWD: (2, 90 * 128 * 128, 8), gn_rows.BWD: (2, 90 * 128 * 128, 8),
            gn_rows.ROW9: (2, 90 * 64 * 64, 64)}


def check_gn_map(torch, dev, name):
    from dalle2_video_tpu_torch.ops import fused_block as fb
    from dalle2_video_tpu_torch.ops import groupnorm_film as gn

    if name == gn_rows.FWD:
        run = lambda *a: gn.groupnorm_film_silu(*a, gn_rows.EPS, return_stats=True)  # noqa: E731
        draw = lambda b, l, c, kind: gn_rows.inputs(dev, b, l, c, kind)  # noqa: E731
        measure, hold = gn_rows.measure_fwd, gn_rows.hold_fwd
        plain = lambda *a: gn.groupnorm_film_reference(*a, gn_rows.EPS)  # noqa: E731
    else:
        entry = gn.BWD_KERNEL if name == gn_rows.BWD else fb.GN_BWD_KERNEL
        run = lambda *a: gn.groupnorm_film_bwd(*a, kernel=entry)  # noqa: E731
        draw = lambda b, l, c, kind: gn_rows.bwd_inputs(gn, dev, b, l, c, kind)  # noqa: E731
        measure, hold = gn_rows.measure_bwd, lambda m, *_: gn_rows.hold_bwd(m)
        plain = gn.groupnorm_film_bwd_reference
    row, ms_at = None, {}
    for b, l, c, groups in gn_rows.all_shapes()[name]:
        label = f"{name} B={b} L={l} C={c} G={groups}"
        args = draw(b, l, c, "normal")
        m = measure(run, gn, *args, groups)
        try:
            text = hold(m)
            if (b, l, c) in gn_rows.MEAN30_SHAPES:
                text += "; mean 30: " + hold(measure(run, gn, *draw(b, l, c, "mean30"), groups),
                                             "mean30", (b, l, c))
        except AssertionError as exc:
            raise AssertionError(f"{label}: {exc}") from None
        kms = ms_at[(b, l, c, groups)] = time_ms(lambda: run(*args, groups))
        bnd = gn_rows.bound_ms(name, b, l, c)
        log(f"{label}: {text}; ms={kms:.4f} bound_ms={bnd:.4f}")
        if (b, l, c) == GN_TIMED[name]:
            row = dict(max_abs_err=m["max_abs_err"],
                       tolerance=f"<= 1 bf16 step (floor {gn_rows.STEP_FLOOR:g} of the channel's "
                                 f"max), share <= {gn_rows.MAX_SHARE:g}, oracle share <= plain's "
                                 f"+ {gn_rows.ORACLE_MARGIN:g} (probes/gn_rows.py)",
                       shape=f"x{(b, l, c)} G={groups} bf16", ms=kms,
                       plain_ms=time_ms(lambda: plain(*args, groups), iters=3),
                       library_ms=None, bound_ms=bnd, bound_by="bytes")
        del args
        torch.cuda.empty_cache()
    if name == gn_rows.FWD:
        row["serve_step"] = {}
        for b in gn_rows.SERVE_BATCHES:
            step = gn_rows.serve_step(b)
            row["serve_step"][str(b)] = dict(
                calls=sum(step.values()), ms=sum(n * ms_at[key] for key, n in step.items()),
                bound_ms=sum(n * gn_rows.bound_ms(name, *key[:3]) for key, n in step.items()))
            log(f"{name}: one DDIM step's {sum(step.values())} calls at CFG batch {b}: "
                f"{row['serve_step'][str(b)]['ms']:.4f} ms, bound "
                f"{row['serve_step'][str(b)]['bound_ms']:.4f} ms")
    return row


STUDENT_BATCH = 1  # serve_student's: cond_scale 1, one request


def check_student_kernels(dev, torch, rows):
    """Rows 1, 3 and 5 at batch 1, the distilled student's unguided
    serving batch (serve_student), a batch no other path gives them: row 1
    at the joint bottleneck (hold_flash), row 3 at every (1, L, C, G) of one
    DDIM step of each unet (gn_rows' hold), row 5 at every serving site
    (hold_bf16); each timed, and summed over one student DDIM step of
    each unet (the "student_step" entries of the JSON rows)."""
    from dalle2_video_tpu_torch.ops import cross_attention as xa
    from dalle2_video_tpu_torch.ops import flash_mqa as fm
    from dalle2_video_tpu_torch.ops import groupnorm_film as gn

    g = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16
    step = {u: {} for u in (1, 2)}
    h, d = 16, 32
    q, k, v, bk = row1_case(torch, fm, g, dev, STUDENT_BATCH, 90 * 8 * 8, h, d)
    check_row1(torch, fm, "serve_student", q, k, v, d**-0.5, bk)
    fms = time_ms(lambda: fm.flash_mqa_fwd(q, k, v, sm_scale=d**-0.5))
    log(f"  serve_student: ms={fms:.4f}")
    del q, k, v
    for u in (1, 2):
        step[u]["flash_mqa_fwd"] = fms
    run = lambda *a: gn.groupnorm_film_silu(*a, gn_rows.EPS, return_stats=True)  # noqa: E731
    for u in (1, 2):
        total = 0.0
        for (b, l, c, groups), n in gn_rows.calls(gn_rows.FWD, STUDENT_BATCH, u).items():
            args = gn_rows.inputs(dev, b, l, c, "normal")
            label = f"{gn_rows.FWD} B={b} L={l} C={c} G={groups}"
            try:
                text = gn_rows.hold_fwd(gn_rows.measure_fwd(run, gn, *args, groups))
            except AssertionError as exc:
                raise AssertionError(f"{label}: {exc}") from None
            kms = time_ms(lambda: run(*args, groups))
            total += n * kms
            bnd = gn_rows.bound_ms(gn_rows.FWD, b, l, c)
            log(f"{label}: {text}; ms={kms:.4f} bound_ms={bnd:.4f}")
            del args
        step[u][gn_rows.FWD] = total
    sc = 64**-0.5
    for u in (1, 2):
        step[u]["cross_attention_fwd"] = 0.0
    for unet, n, m, sites in SERVE_SITES:
        q = torch.randn(STUDENT_BATCH, n, 8, 64, generator=g, device=dev).to(bf)
        k, v = (torch.randn(STUDENT_BATCH, m, 8, 64, generator=g, device=dev).to(bf)
                for _ in range(2))
        out = xa.cross_attention(q, k, v, sm_scale=sc)
        label = f"unet{unet} b={STUDENT_BATCH} n={n} m={m}"
        try:
            held = hold_bf16(out, xa.fused_cross_attention_reference(q, k, v, sc), q, k, v, sc)
        except AssertionError as exc:
            raise AssertionError(f"cross_attention_fwd {label}: {exc}") from None
        if not torch.equal(out, xa.cross_attention(q, k, v, sm_scale=sc)):
            raise AssertionError(f"cross_attention_fwd {label}: two calls differ")
        kms = time_ms(lambda: xa.cross_attention(q, k, v, sm_scale=sc))
        step[unet]["cross_attention_fwd"] += sites * kms
        log(f"cross_attention_fwd {label}: {held['text']}; ms={kms:.4f} bound_ms="
            f"{xa_bound(STUDENT_BATCH, n, 8, 64, m)[0]:.4f}")
        del q, k, v, out
    for name in ("flash_mqa_fwd", gn_rows.FWD, "cross_attention_fwd"):
        rows[name]["student_step"] = {f"unet{u}": step[u][name] for u in (1, 2)}
    log(f"serve_student kernels at batch {STUDENT_BATCH}, one DDIM step (ms): "
        + ", ".join(f"unet {u} {step[u]}" for u in (1, 2)))
    torch.cuda.empty_cache()
    return rows


# The curve recipe's SR unet (train/train_curve.py: 64 x 128^2, dim mults
# (1, 2, 4, 8), attention_impl flash) attends jointly at its 64 x 16 x 16
# bottleneck, 16 heads of 32: q (b, 262,144, 32) against kv (b, 16,385,
# 32), the null kv included. Its paths give row 1 (label, dtype, batch,
# save_lse): the training forward at batch 1 in bf16 and, for the batch-1
# backward's exact lse, again in f32 (ops/flash_mqa.py::fwd_residuals;
# train_curve's stage 2 and the SR witness's student); the bf16 sampling
# forwards at batch 1 (the witness's teacher), 2 (its SR samples at
# cond_scale 1) and 4 (eval_quality's cascade grid: 2 rows under CFG); and
# the f32 sampling forward at batch 4 (train_curve's end sample: the recipe
# samples in f32). Row 2 at batch 1 in bf16 takes the CUDA cores (the JAX
# rule: _bwd_xla_scan's f32 math).
CURVE_SR_TOKENS = 64 * 16 * 16
CURVE_FWD_CASES = [("train", "bfloat16", 1, True), ("train exact lse", "float32", 1, True),
                   ("witness teacher", "bfloat16", 1, False),
                   ("witness SR sample", "bfloat16", 2, False),
                   ("cascade grid", "bfloat16", 4, False),
                   ("end sample", "float32", 4, False)]
CURVE_F32_CHUNK = 16384  # query rows of the f32 plain version at a time


def check_curve_kernels(dev, torch, rows):
    """Rows 1 and 2 at the curve recipe's SR shapes (CURVE_FWD_CASES and
    the batch-1 backward), each held to its plain version and timed beside
    its bound (the "curve" entries of the JSON rows). The bf16 forwards by
    check_row1 (hold_flash and the f64 oracle); the f32 forwards to the f32
    plain version (one softmax over every key, taken CURVE_F32_CHUNK query
    rows at a time) within 1e-5 (out) and 1e-4 (lse) absolute, the
    standing f32 tolerance of tests/test_torch_port_cuda.py; the backward
    as check_backward_kernels holds its bf16 cases, on the CUDA-core route,
    with the f32 forward's exact lse as the training path hands it."""
    from dalle2_video_tpu_torch.ops import flash_mqa as fm

    g = torch.Generator(device=dev).manual_seed(13)
    h, d = 16, 32
    sc = d**-0.5
    n = CURVE_SR_TOKENS
    fwd = {}
    for label, dtype, b, save_lse in CURVE_FWD_CASES:
        q, k, v, bk = row1_case(torch, fm, g, dev, b, n, h, d)
        shape = f"curve {label} {dtype} b={b} n_q={n * h} n_kv={n + 1} d={d}"
        if dtype == "float32":
            q, k, v = q.float(), k.float(), v.float()
            got = fm.flash_mqa_fwd(q, k, v, sm_scale=sc, save_lse=save_lse)
            again = fm.flash_mqa_fwd(q, k, v, sm_scale=sc, save_lse=save_lse)
            outs, agains = (got if save_lse else (got,)), (again if save_lse else (again,))
            if not all(torch.equal(x, y) for x, y in zip(outs, agains)):
                raise AssertionError(f"flash_mqa_fwd {shape}: two calls differ")
            err = 0.0
            for r0 in range(0, q.shape[1], CURVE_F32_CHUNK):
                sl = slice(r0, r0 + CURVE_F32_CHUNK)
                ref = fm.flash_mqa_reference(q[:, sl], k, v, sc, save_lse)
                refs = ref if save_lse else (ref,)
                for part, o, r, atol in zip(("out", "lse"), outs, refs, (1e-5, 1e-4)):
                    diff = float((o[:, sl] - r).abs().max())
                    err = max(err, diff) if part == "out" else err
                    if not diff <= atol:
                        raise AssertionError(f"flash_mqa_fwd {shape} {part} rows {r0}+: max "
                                             f"|diff| {diff:.3e} > {atol:g}")
                del ref, refs
            log(f"flash_mqa_fwd {shape}: max_abs_err={err:.3e} (out within 1e-5, lse within "
                f"1e-4, absolute), two calls bit-equal")
        else:
            err = check_row1(torch, fm, f"curve {label}", q, k, v, sc, bk, save_lse)[0]
        kms = time_ms(lambda: fm.flash_mqa_fwd(q, k, v, sm_scale=sc, save_lse=save_lse))
        bnd, by = bound(q.element_size() * (2 * q.numel() + 2 * k.numel()),
                        flops=4.0 * b * n * h * (n + 1) * d, exps=float(b * n * h * (n + 1)))
        fwd[label] = dict(shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} {dtype}"
                          + (" lse" if save_lse else ""), max_abs_err=err, ms=kms,
                          bound_ms=bnd, bound_by=by)
        log(f"  ms={kms:.4f} bound_ms={bnd:.4f} ({by}) [{card_line()}]")
        del q, k, v
    rows["flash_mqa_fwd"]["curve"] = fwd

    b = 1
    q, k, v, _ = row1_case(torch, fm, g, dev, b, n, h, d)
    go = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
    out, lse = fm.fwd_residuals(q, k, v, sm_scale=sc)
    before = dict(fm.BWD_KERNEL.routes)
    got = fm.flash_mqa_bwd(q, k, v, out, lse, go, sm_scale=sc)
    took = {r: c - before.get(r, 0) for r, c in fm.BWD_KERNEL.routes.items()
            if c != before.get(r, 0)}
    if took != {"cuda_cores": 1}:
        raise AssertionError(f"flash_mqa_bwd curve: routes {took}, the JAX rule gives cuda_cores")
    want = fm.flash_mqa_bwd_reference(q, k, v, out, lse, go, sc)
    shape = f"curve train bfloat16 b={b} n_q={n * h} n_kv={n + 1} d={d} (cuda_cores)"
    e, tol = rel("flash_mqa_bwd", shape, ("dq", "dk", "dv"), got, want, rtol=1e-2,
                 atol_frac=1e-3)
    del want
    if not all(torch.equal(x, y) for x, y in zip(
            got, fm.flash_mqa_bwd(q, k, v, out, lse, go, sm_scale=sc))):
        raise AssertionError(f"flash_mqa_bwd {shape}: two calls differ")
    kms = time_ms(lambda: fm.flash_mqa_bwd(q, k, v, out, lse, go, sm_scale=sc), iters=5)
    pms = time_ms(lambda: fm.flash_mqa_bwd_reference(q, k, v, out, lse, go, sc), iters=1,
                  warmup=1)
    bnd, by = bound(2 * (4 * q.numel() + 4 * k.numel()) + 8 * b * n * h,
                    flops=5 * 2.0 * b * n * h * (n + 1) * d, exps=float(b * n * h * (n + 1)))
    rows["flash_mqa_bwd"]["curve"] = dict(
        shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16 (cuda_cores)", max_abs_err=e,
        tolerance=tol, ms=kms, plain_ms=pms, bound_ms=bnd, bound_by=by)
    log(f"  ms={kms:.4f} plain_ms={pms:.2f} bound_ms={bnd:.4f} ({by}) [{card_line()}]")
    del q, k, v, go, out, lse, got
    torch.cuda.empty_cache()
    return rows


def check_kernels(dev, torch):
    """Each kernel vs its plain version at serving shapes (bf16)."""
    import torch.nn.functional as F

    from dalle2_video_tpu_torch.ops import cross_attention as xa
    from dalle2_video_tpu_torch.ops import flash_mqa as fm
    from dalle2_video_tpu_torch.ops import groupnorm_film as gn

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    rows = {}

    # flash-MQA: joint bottleneck of both unets at 90 frames, CFG batch 2,
    # then at the probes' geometry (each timed), then the other shapes
    h, d = 16, 32
    sc = d**-0.5
    timed = {}
    for label, b, n in (("serve", 2, 90 * 8 * 8), ("probe geometry", 2, 23040)):
        q, k, v, bk = row1_case(torch, fm, g, dev, b, n, h, d)
        e, tol = check_row1(torch, fm, label, q, k, v, sc, bk)
        qh = q.view(b, n, h, d).transpose(1, 2)
        # the library yardstick gets the kv expanded per head (no MQA entry)
        kh = k[:, None].expand(b, h, n + 1, d).contiguous()
        vh = v[:, None].expand(b, h, n + 1, d).contiguous()
        bnd, by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                        flops=4.0 * b * n * h * (n + 1) * d, exps=float(b * n * h * (n + 1)))
        timed[label] = dict(
            max_abs_err=e, tolerance=tol,
            shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16 block_k {bk}",
            ms=time_ms(lambda: fm.flash_mqa_fwd(q, k, v, sm_scale=sc)),
            plain_ms=time_ms(lambda: fm.flash_mqa_reference(q, k, v, sc, block_k=bk), iters=2),
            library_ms=library_time("flash_mqa_fwd", lambda: F.scaled_dot_product_attention(
                qh, kh, vh, scale=sc)),
            bound_ms=bnd, bound_by=by)
        log(f"  {label}: ms={timed[label]['ms']:.4f} library_ms={timed[label]['library_ms']} "
            f"bound_ms={bnd:.4f} plain_ms={timed[label]['plain_ms']:.2f}")
        del q, k, v, qh, kh, vh
    rows["flash_mqa_fwd"] = dict(timed["serve"], probe_geometry=timed["probe geometry"])
    for label, b, n, save_lse, *heads in FLASH_FWD_CASES:
        q, k, v, bk = row1_case(torch, fm, g, dev, b, n, heads[0] if heads else h, d)
        check_row1(torch, fm, label, q, k, v, sc, bk, save_lse)
        if label.startswith("latent"):
            kms = time_ms(lambda: fm.flash_mqa_fwd(q, k, v, sm_scale=sc, save_lse=save_lse))
            bnd, by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                            flops=4.0 * q.shape[0] * q.shape[1] * k.shape[1] * d,
                            exps=float(q.shape[0] * q.shape[1] * k.shape[1]))
            rows["flash_mqa_fwd"].setdefault("latent", {})[label] = dict(
                shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16 block_k {bk}", ms=kms,
                bound_ms=bnd, bound_by=by)
            log(f"  {label}: ms={kms:.4f} bound_ms={bnd:.4f} ({by})")
        del q, k, v

    # GroupNorm-FiLM-SiLU (row 3): the standing check at the largest L of
    # each unet, C = 8 and the widest C, then gn_rows' hold and the time at
    # every (batch, shape) of the map
    gn_cases = [("unet2 stage 0", 2, 90 * 128 * 128, 8),
                ("unet1 stage 0", 2, 90 * 64 * 64, 64),
                ("unet1 bottleneck", 2, 90 * 8 * 8, 512)]
    for label, b, l, c in gn_cases:
        x = (torch.randn(b, l, c, generator=g, device=dev) * 2 + 0.3).to(bf)
        gamma = (1 + 0.1 * torch.randn(c, generator=g, device=dev)).to(bf)
        beta = (0.1 * torch.randn(c, generator=g, device=dev)).to(bf)
        s_ = (0.1 * torch.randn(b, c, generator=g, device=dev)).to(bf)
        t_ = (0.1 * torch.randn(b, c, generator=g, device=dev)).to(bf)
        out = gn.groupnorm_film_silu(x, gamma, beta, s_, t_, 8, return_stats=True)
        ref = gn.groupnorm_film_reference(x, gamma, beta, s_, t_, 8, 1e-5)
        # the statistics are f32 sums over up to 1.5M values in another order
        check("groupnorm_film_silu_fwd", f"{label} B={b} L={l} C={c}", out[0], ref,
              atol=2e-2, rtol=1e-2)
        again = gn.groupnorm_film_silu(x, gamma, beta, s_, t_, 8, return_stats=True)
        if not all(torch.equal(a, b_) for a, b_ in zip(out, again)):
            raise AssertionError("groupnorm_film_silu_fwd: two calls differ (the fold order)")
        del x, out, ref
    rows[gn_rows.FWD] = check_gn_map(torch, dev, gn_rows.FWD)

    # cross-attention (row 5): an f32 check, then bf16 at every (batch,
    # shape) the serving paths give it (probes/xattn_rows.py: SERVE_SITES at
    # each CFG batch of BATCHES; they hold the two shapes timed before, unet
    # 2 at 90x64x64 with m = 3 and unet 1 at 90x32x32 with m = 7), each held
    # to the JAX kernel's function (fused_cross_attention_reference) by
    # xattn_rows.hold_bf16, two calls bit-equal; timed beside its bound,
    # unet 2's 90x64x64 at batch 2 for the JSON row with SDPA and the plain
    # version, and summed over one DDIM step's calls at each batch
    sc = 64**-0.5
    g32 = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(2, n, 8, 64, generator=g32, device=dev) for n in (1000, 7, 7))
    check("cross_attention_fwd", "f32 check b=2 n=1000 m=7",
          xa.cross_attention(q, k, v, sm_scale=sc), xa.fused_cross_attention_reference(q, k, v, sc),
          atol=1e-5, rtol=0.0)
    steps, ms_at = {}, {}
    for b in XA_BATCHES:
        step = steps[str(b)] = dict(ms=0.0, bound_ms=0.0)
        for unet, n, m, sites in SERVE_SITES:
            h, d = 8, 64
            q = torch.randn(b, n, h, d, generator=g, device=dev).to(bf)
            k = torch.randn(b, m, h, d, generator=g, device=dev).to(bf)
            v = torch.randn(b, m, h, d, generator=g, device=dev).to(bf)
            run = lambda: xa.cross_attention(q, k, v, sm_scale=sc)  # noqa: E731
            out = run()
            ref = xa.fused_cross_attention_reference(q, k, v, sc)
            label = f"unet{unet} b={b} n={n} h={h} d={d} m={m}"
            try:
                held = hold_bf16(out, ref, q, k, v, sc)
            except AssertionError as exc:
                raise AssertionError(f"cross_attention_fwd {label}: {exc}") from None
            log(f"cross_attention_fwd {label}: {held['text']}")
            if not torch.equal(out, run()):
                raise AssertionError(f"cross_attention_fwd {label}: two calls differ")
            bnd, by = xa_bound(b, n, h, d, m)
            kms = ms_at[(b, n, m)] = time_ms(run)
            step["ms"] += sites * kms
            step["bound_ms"] += sites * bnd
            log(f"  ms={kms:.4f} bound_ms={bnd:.4f} ({by}); {sites} calls a DDIM step")
            if (b, n, m) == (2, 90 * 64 * 64, 3):
                qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                rows["cross_attention_fwd"] = dict(
                    max_abs_err=held["max_abs_err"], tolerance=held["tolerance"],
                    shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16", ms=kms,
                    plain_ms=time_ms(lambda: xa.fused_cross_attention_reference(q, k, v, sc),
                                     iters=3),
                    library_ms=library_time("cross_attention_fwd",
                                            lambda: F.scaled_dot_product_attention(qt, kt, vt)),
                    bound_ms=bnd, bound_by=by)
                del qt, kt, vt
            del q, k, v, out, ref
        log(f"cross_attention_fwd: one DDIM step's {sites_per_step()} calls at batch {b} "
            f"{step['ms']:.4f} ms, bound {step['bound_ms']:.4f} ms")
    rows["cross_attention_fwd"]["serve_step"] = steps
    rows["cross_attention_fwd"]["text"] = check_xattn_text(dev, torch, g, ms_at)
    torch.cuda.empty_cache()
    return rows


def check_xattn_text(dev, torch, g, ms_at):
    """Row 5 past the short route's 16 keys: held at every m of LONG_MS
    (bf16 by hold_bf16, f32 within 1e-5) on q (2, 4000, 8, 64), a ragged
    tail of tokens; then, bf16, at every shape serve_text gives it with
    m > 16 (probes/xattn_rows.py: TEXT_SITES, at each CFG batch), each held,
    two calls bit-equal, timed beside its bound and SDPA, and each
    serve_text request's DDIM step summed (its m <= 16 shapes are the
    serving ones, timed before: ``ms_at``). Returns the JSON row's part."""
    import torch.nn.functional as F

    from dalle2_video_tpu_torch.ops import cross_attention as xa

    sc = 64**-0.5
    for m in LONG_MS:
        q = torch.randn(2, 4000, 8, 64, generator=g, device=dev)
        k, v = (torch.randn(2, m, 8, 64, generator=g, device=dev) for _ in range(2))
        check("cross_attention_fwd", f"f32 b=2 n=4000 m={m}",
              xa.cross_attention(q, k, v, sm_scale=sc),
              xa.fused_cross_attention_reference(q, k, v, sc), atol=1e-5, rtol=0.0)
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        out = xa.cross_attention(q, k, v, sm_scale=sc)
        try:
            held = hold_bf16(out, xa.fused_cross_attention_reference(q, k, v, sc), q, k, v, sc)
        except AssertionError as exc:
            raise AssertionError(f"cross_attention_fwd bf16 m={m}: {exc}") from None
        log(f"cross_attention_fwd bf16 b=2 n=4000 m={m}: {held['text']}")
    shapes = {}
    for b in XA_BATCHES:
        for unet, n, m, sites in TEXT_SITES:
            if m <= 16:
                continue
            h, d = 8, 64
            q = torch.randn(b, n, h, d, generator=g, device=dev).to(torch.bfloat16)
            k, v = (torch.randn(b, m, h, d, generator=g, device=dev).to(q.dtype)
                    for _ in range(2))
            run = lambda: xa.cross_attention(q, k, v, sm_scale=sc)  # noqa: E731
            out = run()
            label = f"unet{unet} b={b} n={n} h={h} d={d} m={m}"
            try:
                held = hold_bf16(out, xa.fused_cross_attention_reference(q, k, v, sc), q, k, v, sc)
            except AssertionError as exc:
                raise AssertionError(f"cross_attention_fwd {label}: {exc}") from None
            if not torch.equal(out, run()):
                raise AssertionError(f"cross_attention_fwd {label}: two calls differ")
            bnd, by = xa_bound(b, n, h, d, m)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            rec = ms_at[(b, n, m)] = dict(
                ms=time_ms(run), bound_ms=bnd, bound_by=by,
                sdpa_ms=library_time("cross_attention_fwd",
                                     lambda: F.scaled_dot_product_attention(qt, kt, vt)),
                max_abs_err=held["max_abs_err"])
            shapes[label] = rec
            log(f"cross_attention_fwd {label}: {held['text']}; ms={rec['ms']:.4f} "
                f"bound_ms={bnd:.4f} ({by}) sdpa_ms={rec['sdpa_ms']}; {sites} calls a DDIM step")
            del q, k, v, qt, kt, vt, out
        torch.cuda.empty_cache()
    steps = {}
    for b in XA_BATCHES:
        for r, sites in TEXT_REQUESTS.items():
            key = f"request {r} batch {b}"
            at = lambda n, m: ms_at[(b, n, m)]  # noqa: E731
            steps[key] = dict(
                calls=sum(s[3] for s in sites),
                ms=sum(s[3] * (at(s[1], s[2])["ms"] if s[2] > 16 else at(s[1], s[2]))
                       for s in sites),
                bound_ms=sum(s[3] * xa_bound(b, s[1], 8, 64, s[2])[0] for s in sites))
            log(f"cross_attention_fwd: serve_text {key}: one DDIM step's {steps[key]['calls']} "
                f"calls {steps[key]['ms']:.4f} ms, bound {steps[key]['bound_ms']:.4f} ms")
    return dict(shapes=shapes, serve_text_step=steps)


def check_backward_kernels(dev, torch, rows):
    """The two backward kernels vs their plain versions at the training
    shapes, bf16 (one f32 case each). Inputs that come from the forward
    (out, lse, mean, rstd) are the forward kernels' own, handed to both."""
    from dalle2_video_tpu_torch.ops import flash_mqa as fm
    from dalle2_video_tpu_torch.ops import groupnorm_film as gn

    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16

    # flash backward: the joint bottleneck of either unet at 90 frames, batch
    # 2 (timed), then the cascade's SR unet and the probes' VJP; each on the
    # route the JAX rule gives it, bit for bit again on a second call
    import torch.nn.functional as F

    for dtype, label, (b, n_q, n_kv), route in FLASH_BWD_CASES:
        dtype = getattr(torch, dtype)
        d = 32
        q = torch.randn(b, n_q, d, generator=g, device=dev).to(dtype)
        k = torch.randn(b, n_kv, d, generator=g, device=dev).to(dtype)
        v = torch.randn(b, n_kv, d, generator=g, device=dev).to(dtype)
        go = torch.randn(b, n_q, d, generator=g, device=dev).to(dtype)
        sc = d**-0.5
        out, lse = fm.flash_mqa_fwd(q, k, v, sm_scale=sc, save_lse=True)
        before = dict(fm.BWD_KERNEL.routes)
        got = fm.flash_mqa_bwd(q, k, v, out, lse, go, sm_scale=sc)
        took = {r: n - before.get(r, 0) for r, n in fm.BWD_KERNEL.routes.items()
                if n != before.get(r, 0)}
        if took != {route: 1}:
            raise AssertionError(f"flash_mqa_bwd {label}: routes {took}, the JAX rule gives {route}")
        want = fm.flash_mqa_bwd_reference(q, k, v, out, lse, go, sc)
        # f32: same f32 math in another summation order (sums of up to 92k
        # terms): 1e-5 of the largest value. bf16: both sides round the f32
        # result once (rtol 1e-2 admits one flip, 2^-7 of the value); atol
        # 1e-3 of the largest value covers the f32 sums near zero.
        shape = f"{label} {dtype} b={b} n_q={n_q} n_kv={n_kv} d={d} ({route})"
        e, tol = rel("flash_mqa_bwd", shape,
                     ("dq", "dk", "dv"), got, want, rtol=0.0 if dtype == torch.float32 else 1e-2,
                     atol_frac=1e-5 if dtype == torch.float32 else 1e-3)
        del want
        again = fm.flash_mqa_bwd(q, k, v, out, lse, go, sm_scale=sc)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"flash_mqa_bwd {shape}: two calls differ")
        del again
        kms = time_ms(lambda: fm.flash_mqa_bwd(q, k, v, out, lse, go, sm_scale=sc))
        # five (n_q x n_kv x d) products, P formed once; the two-pass
        # design's own floor: 2 exponentials per probability
        bnd, by = bound(2 * (4 * q.numel() + 4 * k.numel()) + 8 * b * n_q,
                        flops=5 * 2.0 * b * n_q * n_kv * d, exps=float(b * n_q * n_kv))
        exp_floor = 2.0 * b * n_q * n_kv / EXP_PER_S * 1e3
        log(f"  ms={kms:.4f} bound_ms={bnd:.4f} ({by}) two-pass exponential floor "
            f"{exp_floor:.4f} ms")
        if label == "latent train":
            rows["flash_mqa_bwd"]["latent"] = dict(
                shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16 ({route})", ms=kms,
                bound_ms=bnd, bound_by=by)
        if label == "train celebv":
            h = 16
            qh = q.view(b, n_q // h, h, d).transpose(1, 2)
            kh = k[:, None].expand(b, h, n_kv, d).contiguous()
            vh = v[:, None].expand(b, h, n_kv, d).contiguous()
            goh = go.view(b, n_q // h, h, d).transpose(1, 2)
            alone = time_ms(sdpa_backward_alone(torch, qh, kh, vh, goh, sc))
            qg, kg, vg = (t.detach().requires_grad_() for t in (qh, kh, vh))

            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(qg, kg, vg, scale=sc)
                torch.autograd.grad(o, (qg, kg, vg), goh)

            fwd_bwd = library_time("flash_mqa_bwd (SDPA forward + backward)", sdpa_fwd_bwd)
            log(f"  SDPA (kv expanded per head): backward alone {alone} ms "
                "(aten._scaled_dot_product_flash_attention_backward on the forward's saved "
                f"outputs), forward + backward {fwd_bwd} ms")
            rows["flash_mqa_bwd"] = dict(
                max_abs_err=e, tolerance=tol,
                shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16 ({route})", ms=kms,
                plain_ms=time_ms(lambda: fm.flash_mqa_bwd_reference(q, k, v, out, lse, go, sc),
                                 iters=2),
                library_ms=alone, library_fwd_bwd_ms=fwd_bwd, bound_ms=bnd, bound_by=by)
        del q, k, v, go, out, lse, got

    # GroupNorm backward (row 4): the standing check at the training path's
    # largest L at C = 8, C = 64 and the widest C, then gn_rows' hold and the
    # time at every shape of the map
    gn_cases = [(torch.float32, "f32 check", 2, 4097, 128),
                (bf, "unet2 stage 0", 2, 90 * 128 * 128, 8),
                (bf, "unet1 stage 0", 2, 90 * 64 * 64, 64),
                (bf, "unet1 bottleneck", 2, 90 * 8 * 8, 512)]
    for dtype, label, b, l, c in gn_cases:
        x = (torch.randn(b, l, c, generator=g, device=dev) * 2 + 0.3).to(dtype)
        gy = torch.randn(b, l, c, generator=g, device=dev).to(dtype)
        gamma = (1 + 0.1 * torch.randn(c, generator=g, device=dev)).to(dtype)
        beta = (0.1 * torch.randn(c, generator=g, device=dev)).to(dtype)
        s_ = (0.1 * torch.randn(b, c, generator=g, device=dev)).to(dtype)
        t_ = (0.1 * torch.randn(b, c, generator=g, device=dev)).to(dtype)
        _, mean, rstd = gn.groupnorm_film_silu(x, gamma, beta, s_, t_, 8, return_stats=True)
        a_vec, b_vec = gn.fold_ab(gamma, beta, s_, t_, dtype, b)
        args = (x, gy, a_vec, b_vec, mean, rstd, 8)
        got = gn.groupnorm_film_bwd(*args)
        want = gn.groupnorm_film_bwd_reference(*args)
        # dA, dB are f32 sums over up to 1.47M values in another order, dx
        # ends in one rounding (bf16: rtol 1e-2 = one flip); atol 1e-3 of
        # the largest value covers the sums' order error and dx near zero
        rel("groupnorm_film_silu_bwd", f"{label} {dtype} B={b} L={l} C={c}",
            ("dx", "dA", "dB"), got, want, rtol=0.0 if dtype == torch.float32 else 1e-2,
            atol_frac=1e-5 if dtype == torch.float32 else 1e-3)
        if not all(torch.equal(a, b_) for a, b_ in zip(got, gn.groupnorm_film_bwd(*args))):
            raise AssertionError("groupnorm_film_silu_bwd: two calls differ (the fold order)")
        del x, gy, got, want
    rows[gn_rows.BWD] = check_gn_map(torch, dev, gn_rows.BWD)
    torch.cuda.empty_cache()
    return rows


def check_conv_kernels(dev, torch, rows):
    """The opt-in conv paths' kernels (rows 6-9) vs their plain versions at
    the slice's shapes in bf16, and one f32 case each. The JSON row of each
    is unet 1's 64x64 stage at B*T = 180, where the fused block runs its
    widest sums and the conv dx its largest launches; the other shapes are
    logged. Tolerances are the backward kernels' form: f32 2e-5 of the
    largest value (same products, another order); bf16 one rounding flip
    (rtol 1e-2) plus 1e-3 of the largest value; the f32 weight gradient and
    statistics 1e-4 / 1e-5 of their largest value."""
    import math

    import torch.nn.functional as F

    from dalle2_video_tpu_torch.ops import fused_block as fb
    from dalle2_video_tpu_torch.ops import groupnorm_film as gn
    from dalle2_video_tpu_torch.ops import spatial_conv as sc

    g = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    tol = {torch.float32: dict(rtol=0.0, atol_frac=2e-5), bf: dict(rtol=1e-2, atol_frac=1e-3)}
    stage0 = (180, 64, 64, 64, 64)

    def inputs(dtype, n, h, w, c, co):
        x = torch.randn(n, h, w, c, generator=g, device=dev).to(dtype)
        wt = (torch.randn(co, c, 3, 3, generator=g, device=dev) / math.sqrt(9 * c)).to(dtype)
        return x, wt

    def conv_flops(n, h, w, c, co):
        return 2.0 * n * h * w * 9 * c * co

    def cl(x, wt):  # the cuDNN yardstick's channels-last operands
        return x.permute(0, 3, 1, 2), wt.contiguous(memory_format=torch.channels_last)

    # row 6: the conv forward (pallas_small at the 8x8 512-wide sites) and
    # its dx (every fused site) at every shape the conv paths give it
    # (CONV_SHAPES), each with its plan logged, two calls bit-equal; the
    # JSON row is the dx of unet 1's 64x64 stage
    row6 = [(torch.float32, "f32 check", (6, 16, 16, 64, 128))]
    row6 += [(bf, "conv paths", shape) for shape in sorted(CONV_SHAPES["conv3x3"])]
    for dtype, label, shape in row6:
        x, wt = inputs(dtype, *shape)
        got = sc.conv3x3(x, wt)
        e, tl = rel("conv3x3", f"{label} {dtype} {shape}", ("y",), [got],
                    [sc.conv3x3_reference(x, wt)], **tol[dtype])
        if not torch.equal(got, sc.conv3x3(x, wt)):
            raise AssertionError(f"conv3x3 {shape}: two calls differ")
        if dtype == bf:
            n, h, w, c, co = shape
            bnd, by = bound(2 * (x.numel() + wt.numel() + n * h * w * co),
                            flops=conv_flops(*shape))
            kms = time_ms(lambda: sc.conv3x3(x, wt))
            xc, wc = cl(x, wt)
            lib = library_time("conv3x3", lambda: F.conv2d(xc, wc, padding=1))
            log(f"  ms={kms:.4f} bound_ms={bnd:.4f} ({by}) cudnn_ms={lib} plan "
                f"{tuple(sc.conv_plan(*shape))} (frames, rows, seg, tiles_per_row, blocks)")
            if shape == stage0:
                rows["conv3x3"] = dict(
                    max_abs_err=e, tolerance=tl, shape=f"x{tuple(x.shape)} w{tuple(wt.shape)} bf16",
                    ms=kms, plain_ms=time_ms(lambda: sc.conv3x3_reference(x, wt), iters=3),
                    library_ms=lib, bound_ms=bnd, bound_by=by)
        del x, wt, got

    # row 7: the weight gradient at every shape train_conv's fused sites
    # give it (FUSED_SITES at TRAIN_BT; its train run checks that no other
    # reaches the kernel), each with its own plan
    # (ops/spatial_conv.py::wgrad_plan).
    # Its oracle is the plain version on f64 copies: over the 737,280
    # pixels of the 64x64 stage the f32 plain version (cuDNN, one long sum
    # per value) is itself off by ~1e-4 of the largest value, the kernel
    # (split-K, short f32 sums) by ~1e-5 (both logged below), so 1e-5 of
    # the largest value.
    wgrad_cases = [(torch.float32, "f32 check", (6, 16, 16, 64, 128))]
    wgrad_cases += [(bf, f"unet{u} {h}x{w} {c}->{co}", (TRAIN_BT, h, w, c, co))
                    for u, stages in FUSED_SITES.items() for h, w, c, co in stages]
    for dtype, label, shape in wgrad_cases:
        x, _ = inputs(dtype, *shape)
        dy = torch.randn(*shape[:3], shape[4], generator=g, device=dev).to(dtype)
        got = sc.conv3x3_wgrad(x, dy)
        want = sc.conv3x3_wgrad_reference(x.double(), dy.double())
        e, tl = rel("conv3x3_wgrad", f"{label} {dtype} {shape}", ("dW",), [got], [want],
                    rtol=0.0, atol_frac=1e-5)
        scale = float(want.abs().max())
        plain_e = float((sc.conv3x3_wgrad_reference(x, dy).double() - want).abs().max())
        log(f"  against the f64 oracle, in units of its largest value: kernel "
            f"{e / scale:.2e}, plain f32 version {plain_e / scale:.2e}")
        del want
        if not torch.equal(got, sc.conv3x3_wgrad(x, dy)):
            raise AssertionError("conv3x3_wgrad: two calls differ (split-K order)")
        if dtype == bf:
            bnd, by = bound(2 * (x.numel() + dy.numel()) + 4 * got.numel(),
                            flops=conv_flops(*shape))
            kms = time_ms(lambda: sc.conv3x3_wgrad(x, dy))
            xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            lib = library_time("conv3x3_wgrad", lambda: torch.nn.grad.conv2d_weight(
                xc, tuple(got.shape), dyc, padding=1))
            log(f"  ms={kms:.4f} bound_ms={bnd:.4f} ({by}) library_ms={lib} plan "
                f"(rows, seg, groups, splits) {sc.wgrad_plan(*shape)}")
            if shape == stage0:
                rows["conv3x3_wgrad"] = dict(
                    max_abs_err=e, tolerance=tl, shape=f"x, dy{tuple(x.shape)} bf16 -> dW f32",
                    ms=kms, plain_ms=time_ms(lambda: sc.conv3x3_wgrad_reference(x, dy), iters=3),
                    library_ms=lib, bound_ms=bnd, bound_by=by)
        del x, dy, got

    # row 8: conv + bias + statistics of the fused forward at every shape
    # the conv paths give it (CONV_SHAPES: the fused sites at B*T frames in
    # B batch rows), each with its plan logged, two calls bit-equal; the
    # JSON row is unet 1's 64x64 stage in 2 rows
    row8 = [(torch.float32, "f32 check (147-pixel rows)", (6, 7, 7, 64, 64, 2))]
    row8 += [(bf, "conv paths", shape) for shape in sorted(CONV_SHAPES["conv3x3_bias_stats"])]
    for dtype, label, shape in row8:
        x, wt = inputs(dtype, *shape[:5])
        batch = shape[5]
        bias = 0.5 * torch.randn(shape[4], generator=g, device=dev)
        got = fb.conv_bias_stats(x, wt, bias, batch)
        want = fb.conv_bias_stats_reference(x, wt, bias, batch)
        e, tl = rel("conv3x3_bias_stats", f"{label} {dtype} {shape} y", ("y",), got[:1],
                    want[:1], **tol[dtype])
        rel("conv3x3_bias_stats", f"{label} {dtype} {shape}", ("sum", "sum of squares"),
            got[1:], want[1:], rtol=0.0, atol_frac=1e-5)
        if not all(torch.equal(a, b) for a, b in zip(got, fb.conv_bias_stats(x, wt, bias, batch))):
            raise AssertionError(f"conv3x3_bias_stats {shape}: two calls differ")
        if dtype == bf:
            n, h, w, c, co = shape[:5]
            bnd, by = bound(2 * (x.numel() + wt.numel() + n * h * w * co) + 4 * (co + 4 * co),
                            flops=conv_flops(*shape[:5]))
            kms = time_ms(lambda: fb.conv_bias_stats(x, wt, bias, batch))
            xc, wc = cl(x, wt)
            # no one call computes conv + bias + the statistics; what the
            # conv alone costs in cuDNN stands beside it
            alone = library_time("conv3x3_bias_stats", lambda: F.conv2d(xc, wc, padding=1))
            log(f"  ms={kms:.4f} bound_ms={bnd:.4f} ({by}) cudnn_conv_alone_ms={alone} plan "
                f"{tuple(sc.conv_plan(*shape))} (frames, rows, seg, tiles_per_row, blocks)")
            if shape == (*stage0, 2):
                rows["conv3x3_bias_stats"] = dict(
                    max_abs_err=e, tolerance=tl, shape=f"x{tuple(x.shape)} w{tuple(wt.shape)} bf16, "
                                                       "2 batch rows",
                    ms=kms, plain_ms=time_ms(lambda: fb.conv_bias_stats_reference(
                        x, wt, bias, batch), iters=3),
                    library_ms=None, conv_alone_ms=alone, bound_ms=bnd, bound_by=by)
        del x, wt, got, want

    # row 9: the fused block's GroupNorm-FiLM-SiLU backward on the conv
    # output, the row-4 kernel counted under its own entry: the standing
    # check, then gn_rows' hold and the time at every shape of the map
    for dtype, label, (b, l, c) in ((torch.float32, "f32 check", (2, 4097, 128)),
                                    (bf, "unet1 stage 0", (2, 90 * 64 * 64, 64))):
        y = (torch.randn(b, l, c, generator=g, device=dev) * 2 + 0.3).to(dtype)
        gy = torch.randn(b, l, c, generator=g, device=dev).to(dtype)
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
        beta = 0.1 * torch.randn(c, generator=g, device=dev)
        s_, t_ = (0.1 * torch.randn(b, c, generator=g, device=dev) for _ in range(2))
        sums = y.float().sum(1), (y.float() ** 2).sum(1)
        mean, rstd = fb.stats_to_mean_rstd(*sums, 8, l * c // 8, 1e-5)
        a_vec, b_vec = fb.fold_ab(gamma, beta, s_, t_, b)
        args = (y, gy, a_vec, b_vec, mean, rstd, 8)
        got = gn.groupnorm_film_bwd(*args, kernel=fb.GN_BWD_KERNEL)
        rel("fused_block_gn_bwd", f"{label} {dtype} B={b} L={l} C={c}", ("dy", "dA", "dB"),
            got, gn.groupnorm_film_bwd_reference(*args),
            rtol=tol[dtype]["rtol"], atol_frac=1e-5 if dtype == torch.float32 else 1e-3)
        if not all(torch.equal(a, b_) for a, b_ in zip(
                got, gn.groupnorm_film_bwd(*args, kernel=fb.GN_BWD_KERNEL))):
            raise AssertionError("fused_block_gn_bwd: two calls differ (the fold order)")
        del y, gy
    rows[gn_rows.ROW9] = check_gn_map(torch, dev, gn_rows.ROW9)
    torch.cuda.empty_cache()
    return rows


def check_probe_kernels(dev, torch, rows):
    """Rows 10 and 11 (the r2 and inner-kv flash forwards) vs their plain
    versions at the probes' geometry and block_k (1024; row 10 also 2048),
    bf16, held as the flash forward is (hold_flash, an f64 oracle of each
    variant on ORACLE_ROWS rows), two calls bit-equal. Then probe 9's check_small on
    the kernels (f32, against exact softmax, < 1e-4). The bound is the
    flash forward's: the exponentials of b x n_q x n_kv real logits (padded
    columns are the kernels' extra work, not the function's)."""
    from dalle2_video_tpu_torch.ops import flash_variants as fv
    from dalle2_video_tpu_torch.probes import SCALE, inputs, sdpa_row
    from dalle2_video_tpu_torch.probes.perf_r3_probe9 import check_small

    q, k, v = inputs(dev)
    b, n_q, d = q.shape
    n_kv = k.shape[1]
    bk = fv.BLOCK_K
    qs = (q.float() * SCALE).to(q.dtype)
    bnd, by = bound(2 * (2 * q.numel() + 2 * k.numel()), flops=4.0 * b * n_q * n_kv * d,
                    exps=float(b * n_q * n_kv))
    shape = f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16 block_k {bk}"
    library = library_time("flash variants (SDPA)", sdpa_row(q, k, v))
    qo, f64 = q[:, :ORACLE_ROWS], torch.float64

    def held(name, label, run, plain, oracle):
        got = run()
        e, tol = hold_flash(torch, name, label, got, plain(), oracle)
        if not torch.equal(got, run()):
            raise AssertionError(f"{name} {label}: two calls differ")
        return e, tol

    run_r2 = lambda: fv.r2_fwd(qs, k, v, block_k=bk)
    e, tol = held("flash_r2_fwd", shape, run_r2, lambda: fv.r2_fwd_reference(qs, k, v, block_k=bk),
                  fv.r2_fwd_reference(qs[:, :ORACLE_ROWS], k, v, block_k=bk, work=f64))
    rows["flash_r2_fwd"] = dict(
        max_abs_err=e, tolerance=tol, shape=shape, ms=time_ms(run_r2, iters=3),
        plain_ms=time_ms(lambda: fv.r2_fwd_reference(qs, k, v, block_k=bk), iters=2),
        library_ms=library, bound_ms=bnd, bound_by=by)
    log(f"  r2: ms={rows['flash_r2_fwd']['ms']:.3f} library_ms={library} bound_ms={bnd:.3f}")
    # and at block_k 2048 (the JAX auto rule's block at these 23,041 keys)
    run_r2 = lambda: fv.r2_fwd(qs, k, v, block_k=2048)
    held("flash_r2_fwd", f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16 block_k 2048", run_r2,
         lambda: fv.r2_fwd_reference(qs, k, v, block_k=2048),
         fv.r2_fwd_reference(qs[:, :ORACLE_ROWS], k, v, block_k=2048, work=f64))
    rows["flash_r2_fwd"]["block_k_2048"] = dict(ms=time_ms(run_r2, iters=3))
    log(f"  r2 block_k 2048: ms={rows['flash_r2_fwd']['block_k_2048']['ms']:.3f}")
    variants = {}
    for inner, merge in ((2, "chain"), (4, "chain"), (2, "par"), (4, "par")):
        run = lambda: fv.inner_fwd(q, k, v, sm_scale=SCALE, block_k=bk, inner=inner, merge=merge)
        e, tol = held("flash_inner_fwd", f"inner={inner} merge={merge} {shape}", run,
                      lambda: fv.inner_fwd_reference(q, k, v, sm_scale=SCALE, block_k=bk,
                                                     inner=inner, merge=merge),
                      fv.inner_fwd_reference(qo, k, v, sm_scale=SCALE, block_k=bk, inner=inner,
                                             merge=merge, work=f64))
        variants[f"inner{inner}_{merge}"] = dict(ms=time_ms(run), max_abs_err=e)
        log(f"  inner={inner} merge={merge}: ms={variants[f'inner{inner}_{merge}']['ms']:.3f}")
    first = variants["inner2_chain"]
    rows["flash_inner_fwd"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in variants.values()), tolerance=tol,
        shape=shape + ", inner2_chain timed (every variant in variants)", ms=first["ms"],
        plain_ms=time_ms(lambda: fv.inner_fwd_reference(q, k, v, sm_scale=SCALE, block_k=bk),
                         iters=2),
        library_ms=library, bound_ms=bnd, bound_by=by, variants=variants)
    errs = check_small(dev)
    log(f"check_small (f32, kernels vs exact softmax): {errs}")
    del q, k, v, qs
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------- phase 3
RESIZE_TOL = 1e-5


def check_resize_and_adapters(dev, torch):
    """ops/video.py's resizes by every jax.image.resize method on the card
    against the same function on the CPU (within RESIZE_TOL), down and up
    in space and in time; then VideoClipAdapter over copies of the CLIP
    stage's towers (the recipe's ViViT and text tower, seed 0): its embeds
    equal the trainer's embed_text / embed_video bit for bit, no parameter
    requires a gradient; a GenericClipAdapter over the trainer's methods
    returns those embeds l2-normalised."""
    from dalle2_video_tpu_torch.models.clip_adapter import GenericClipAdapter, VideoClipAdapter
    from dalle2_video_tpu_torch.ops.video import METHODS, resize_video, resize_video_time
    from dalle2_video_tpu_torch.train import train_clip
    from dalle2_video_tpu_torch.train.clip_trainer import ClipTrainer
    from dalle2_video_tpu_torch.utils.config import load_config

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((2, 16, 64, 64, 3), generator=g, device=dev)
    worst = {}
    for method in METHODS:
        outs = [(resize_video, 37), (resize_video, 96), (resize_video_time, 9),
                (resize_video_time, 24)]
        worst[method] = max(float((fn(x, n, method).cpu() - fn(x.cpu(), n, method)).abs().max())
                            for fn, n in outs)
    log(f"module check: resize_video / resize_video_time of (2, 16, 64, 64, 3) to 37^2, 96^2, 9 "
        f"and 24 frames, card vs CPU, max |diff| by method {worst}")
    if max(worst.values()) > RESIZE_TOL:
        raise AssertionError(f"resize: the card differs from the CPU by more than {RESIZE_TOL}")

    cfg = load_config(None)
    vc, tc = train_clip.vivit_config(cfg), train_clip.text_config(cfg)
    trainer = ClipTrainer(vc, tc, seed=cfg["seed"], device=dev)
    adapter = VideoClipAdapter.create(vc, trainer.vivit.state_dict(),
                                      trainer.text_encoder.state_dict(), tc, dev)
    videos = torch.rand((2, vc.num_frames, vc.frame_size, vc.frame_size, 3), generator=g,
                        device=dev)
    tokens = torch.randint(1, 49408, (2, 77), generator=g, device=dev)
    v_want, t_want = trainer.embed_video(videos), trainer.embed_text(tokens)
    (v_emb, v_enc), (t_emb, t_enc) = adapter.embed_video(videos), adapter.embed_text(tokens)
    frozen = not any(p.requires_grad for m in (adapter.vivit, adapter.text_encoder)
                     for p in m.parameters())
    generic = GenericClipAdapter(trainer.embed_text, trainer.embed_video, vc.dim)
    norm = lambda e: e / torch.linalg.vector_norm(e, dim=-1, keepdim=True).clamp_min(1e-12)  # noqa
    g_v, g_t = generic.embed_video(videos)[0], generic.embed_text(tokens)[0]
    unit = max(float((torch.linalg.vector_norm(e, dim=-1) - 1).abs().max()) for e in (g_v, g_t))
    ok = (torch.equal(v_emb, v_want) and torch.equal(t_emb, t_want) and v_enc is None
          and t_enc.shape == (2, 77, tc.width) and frozen and torch.equal(g_v, norm(v_want))
          and torch.equal(g_t, norm(t_want)) and unit < 1e-6 and not v_emb.requires_grad)
    log(f"module check: VideoClipAdapter over the CLIP stage's towers ({vc.num_frames} x "
        f"{vc.frame_size}^2 ViViT, {tc.layers} x {tc.width} text tower): embeds equal the "
        f"trainer's bit for bit {torch.equal(v_emb, v_want) and torch.equal(t_emb, t_want)}, "
        f"encodings {tuple(t_enc.shape)}, no parameter requiring a gradient {frozen}; "
        f"GenericClipAdapter l2-normalised, max |norm - 1| {unit:.1e}")
    if not ok:
        raise AssertionError("clip adapters: the embeds, the freezing or the normalisation "
                             "differ from the trainer's")
    del trainer, adapter, videos
    torch.cuda.empty_cache()


def _small_unet(UNet3D, UNet3DConfig, kw, dev):
    """The module checks' UNet3D. Its output conv starts at zero (the JAX
    package's init), which would make both outputs 0 and stop every
    gradient upstream of it: it is redrawn like the other kernels."""
    from dalle2_video_tpu_torch.models.layers import kernel_init_

    unet = UNet3D(UNet3DConfig(**kw)).to(dev).eval()
    w = unet.to_out.Conv_0.weight
    kernel_init_(w, w[0].numel())
    return unet


# The module checks' small UNet3Ds on the same weights as their plain twins:
# the serving / training kernels, and the opt-in conv paths -- whose 64-wide
# sites take the fused block and, in bf16, whose 512-wide 16x16 sites take
# the conv kernel (pallas_small; in f32 the weight bound sends them to the
# plain conv, as in the JAX package). Per case: the unet, the fast knobs,
# and the kernels that must launch in a forward / a forward + backward.
MODULE_CASES = {
    "kernels": dict(
        kw=dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, attn_heads=16,
                attn_dim_head=32, video_embed_dim=32, cond_on_video_embeds=True),
        fwd=dict(attention_impl="flash", groupnorm_impl="pallas", cross_attention_impl="flash"),
        grad=dict(attention_impl="flash", groupnorm_impl="pallas"),
        need_fwd=("flash_mqa_fwd", "groupnorm_film_silu_fwd", "cross_attention_fwd"),
        need_grad=("flash_mqa_bwd", "groupnorm_film_silu_bwd")),
    "conv paths": dict(
        kw=dict(dim=64, dim_mults=(1, 8), num_resnet_blocks=1, attn_heads=4,
                attn_dim_head=32, video_embed_dim=32, cond_on_video_embeds=True),
        fwd=dict(groupnorm_impl="fused", spatial_conv_impl="pallas_small"),
        grad=dict(groupnorm_impl="fused", spatial_conv_impl="pallas_small"),
        need_fwd=("conv3x3_bias_stats",),
        need_grad=("conv3x3_bias_stats", "fused_block_gn_bwd", "conv3x3", "conv3x3_wgrad")),
}


def _counted(torch, fn, need, label):
    """Run fn; return what it returned and the kernel launches it made, and
    fail if a kernel in ``need`` did not launch."""
    from dalle2_video_tpu_torch.ops._cuda import all_kernels

    kernels = all_kernels()
    before = {k.name: k.launches for k in kernels}
    out = fn()
    torch.cuda.synchronize()
    used = {k.name: k.launches - before[k.name] for k in kernels if k.launches != before[k.name]}
    missing = [n for n in need if n not in used]
    if missing:
        raise AssertionError(f"{label}: kernels {missing} never launched ({used})")
    return out, used


def check_modules(dev, torch, case):
    """Small UNet3D: kernel impls vs plain impls on the same weights."""
    from dalle2_video_tpu_torch.models.unet3d import UNet3D, UNet3DConfig

    spec = MODULE_CASES[case]
    kw = spec["kw"]
    torch.manual_seed(0)
    plain = _small_unet(UNet3D, UNet3DConfig, kw, dev)
    fast = UNet3D(UNet3DConfig(**kw, **spec["fwd"])).to(dev).eval()
    fast.load_state_dict(plain.state_dict())
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(2, 4, 32, 32, 3, generator=g, device=dev)
    ve = torch.randn(2, 32, generator=g, device=dev)
    t = torch.tensor([10, 700], device=dev)
    # bf16: 4e-2 of the output scale, about 3.5x the 3e-2 measured on an H100
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 4e-2)):
        p, f = plain.to(dtype), fast.to(dtype)
        with torch.no_grad():
            a, used = _counted(torch, lambda: f(x.to(dtype), t, video_embed=ve.to(dtype)).float(),
                               spec["need_fwd"], f"UNet3D {case} ({dtype})")
            b = p(x.to(dtype), t, video_embed=ve.to(dtype)).float()
        e = float((a - b).abs().max())
        scale = max(1.0, float(b.abs().max()))
        log(f"UNet3D {case} vs plain ({dtype}): max_abs_err={e:.3e} "
            f"(tol {tol} x output scale {scale:.2f}); launches {used}")
        if not (torch.isfinite(a).all() and e <= tol * scale):
            raise AssertionError("UNet3D with kernels disagrees with the plain impls")


# relative L2 error per parameter tensor: f32 is the same math summed in
# another order (1e-3). In bf16 the two sides round at other places: the
# plain attention computes its products and softmax in bf16, as the JAX
# package's xla path does, while the flash kernel keeps f32 softmax state,
# as the Pallas kernel does; the kernels' f32 sums. The JAX package's own
# flash and xla paths differ by up to 8.7e-2 on this unet's gradients
# (tests/measure_jax_flash_vs_xla_bf16_grads.py, two seeds, CPU); 0.2
# leaves room for that while a dropped or mis-scaled gradient (error ~1)
# fails.
GRAD_RTOL = {"float32": 1e-3, "bfloat16": 0.2}


def check_module_grads(dev, torch, case):
    """The same small UNet3D with gradients: one loss's gradients with the
    kernel impls (and their backward kernels) and with the plain impls, on
    the same weights and the same draws, in f32 and in bf16 compute over
    f32 masters (as the trainer runs it). Every parameter tensor must get a
    nonzero gradient on both sides, within GRAD_RTOL of the plain one."""
    from dalle2_video_tpu_torch.models.unet3d import UNet3D, UNet3DConfig

    spec = MODULE_CASES[case]
    kw = spec["kw"]
    torch.manual_seed(0)
    plain = _small_unet(UNet3D, UNet3DConfig, kw, dev)
    fast = UNet3D(UNet3DConfig(**kw, **spec["grad"])).to(dev)
    fast.load_state_dict(plain.state_dict())
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(2, 4, 32, 32, 3, generator=g, device=dev)
    target = torch.randn(2, 4, 32, 32, 3, generator=g, device=dev)
    ve = torch.randn(2, 32, generator=g, device=dev)
    t = torch.tensor([10, 700], device=dev)
    keep = torch.tensor([True, False], device=dev)  # one null video embed
    for dtype in (torch.float32, torch.bfloat16):
        grads = []
        for unet in (plain, fast):
            unet.zero_grad(set_to_none=True)
            cast = {k: p.to(dtype) for k, p in unet.named_parameters()}

            def step():
                out = torch.func.functional_call(unet, cast, (x.to(dtype), t), dict(
                    video_embed=ve.to(dtype), video_keep_mask=keep))
                ((out.float() - target) ** 2).mean().backward()

            if unet is fast:
                used = _counted(torch, step, spec["need_grad"], f"UNet3D {case} grads")[1]
            else:
                step()
            grads.append({k: p.grad for k, p in unet.named_parameters()})
        worst, worst_name = 0.0, ""
        for name, gp in grads[0].items():
            gf = grads[1][name]
            if gp is None or gf is None or float(gp.norm()) == 0 or float(gf.norm()) == 0:
                raise AssertionError(f"module grads: {name} has no gradient on one side")
            err = float((gf - gp).norm() / gp.norm())
            if err > worst:
                worst, worst_name = err, name
        tol = GRAD_RTOL[str(dtype).split(".")[-1]]
        log(f"UNet3D {case} gradients vs plain ({dtype} compute, f32 masters): "
            f"{len(grads[0])} tensors, worst relative L2 error {worst:.3e} ({worst_name}); "
            f"tol {tol}; launches {used}")
        if not worst <= tol:
            raise AssertionError("UNet3D gradients with kernels disagree with the plain impls")


def check_temporal_sr_layers(dev, torch):
    """The temporal-SR layers and the temporal_conv unet on the card (f32,
    the port's TF32-off policy) against the same modules on the CPU in f64:
    f32 math summed in another order, 2e-5 of the output scale (the CPU's
    own f32 error is logged beside it)."""
    import copy

    from dalle2_video_tpu_torch.engine.decoder import build_unet
    from dalle2_video_tpu_torch.models import layers
    from dalle2_video_tpu_torch.models.layers import kernel_init_
    from dalle2_video_tpu_torch.models.unet3d import UNet3DConfig

    torch.manual_seed(0)
    unet_cfg = UNet3DConfig(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, attn_heads=2,
                            attn_dim_head=16, video_embed_dim=16, cond_on_video_embeds=True,
                            arch="temporal_conv", temporal_attention=True, sparse_attn=True,
                            pixel_shuffle_upsample=False)
    unet = build_unet(unet_cfg)
    # the zero-init output conv and temporal conv, redrawn so both count
    kernel_init_(unet.unet2d.to_out.Conv_0.weight, unet.unet2d.to_out.Conv_0.weight[0].numel())
    for p_ in unet.temporal_conv.parameters():
        torch.nn.init.normal_(p_, std=0.1)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 8, 16, 16, 32, generator=g)
    vid, ve = torch.randn(2, 8, 32, 32, 3, generator=g), torch.randn(2, 16, generator=g)
    t = torch.tensor([10, 700])
    cases = {
        "TemporalAttention": (layers.TemporalAttention(32, heads=2, dim_head=16), (x,), {}),
        "LinearAttention": (layers.LinearAttention(32, heads=2, dim_head=16), (x,), {}),
        "NearestUpsample3D": (layers.NearestUpsample3D(32, 16), (x,), {}),
        "UnetTemporalConv": (unet, (vid, t), dict(video_embed=ve)),
    }
    f64 = lambda a: a.double() if a.is_floating_point() else a
    for name, (mod, args, kw) in cases.items():
        with torch.no_grad():
            mod.eval()
            want = copy.deepcopy(mod).double()(*map(f64, args),
                                               **{k: f64(v) for k, v in kw.items()})
            cpu_e = float((mod(*args, **kw).double() - want).abs().max())
            mod.to(dev)
            got = mod(*(a.to(dev) for a in args), **{k: v.to(dev) for k, v in kw.items()}).cpu()
        e = float((got.double() - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        log(f"{name} card (f32) vs CPU (f64): max_abs_err={e:.3e} (tol 2e-5 x scale "
            f"{scale:.2f}); the CPU in f32: {cpu_e:.3e}")
        if not (torch.isfinite(got).all() and e <= 2e-5 * scale):
            raise AssertionError(f"{name} on the card disagrees with the CPU")


# The remat checks' two routes through the conv paths' small UNet3D: the
# conv kernel (pallas_small, bf16) with the plain GroupNorm, and the fused
# blocks (f32: the conv kernel with its statistics epilogue, the GroupNorm
# backward, the conv dx and weight-gradient kernels). Every kernel of
# either route sums in a fixed order (no atomics) and cuDNN is held to
# deterministic algorithms, so every policy must give the unremat gradients
# bit for bit on both. (name, knobs, compute dtype)
REMAT_CASES = [("conv kernel", dict(spatial_conv_impl="pallas_small"), "bfloat16"),
               ("fused blocks", dict(groupnorm_impl="fused"), "float32")]


def check_remat_policies(dev, torch):
    """The conv paths' small UNet3D trained one backward under each remat
    policy (cuDNN held to deterministic algorithms), on each route of
    REMAT_CASES: the gradients of the same unet without remat -- the
    policies change what is saved, not the arithmetic -- and what each
    policy replays: under "nothing" every forward kernel of a checkpointed
    block launches again in the backward, under "conv" the conv kernel
    (its output is saved) does not."""
    from dalle2_video_tpu_torch.models.unet3d import UNet3D, UNet3DConfig

    g = torch.Generator(device=dev).manual_seed(5)
    x, target = (torch.randn(2, 4, 32, 32, 3, generator=g, device=dev) for _ in range(2))
    ve = torch.randn(2, 32, generator=g, device=dev)
    t = torch.tensor([10, 700], device=dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for case, knobs, dtype in REMAT_CASES:
            dtype = getattr(torch, dtype)
            kw = dict(MODULE_CASES["conv paths"]["kw"], **knobs)
            torch.manual_seed(0)
            base = _small_unet(UNet3D, UNet3DConfig, kw, dev)
            results = {}
            for policy in (None, "again", "nothing", "conv", "dots", "conv_attn"):
                cfg = (dict(kw) if policy in (None, "again")
                       else dict(kw, checkpoint_during_training=True, remat_policy=policy))
                unet = UNet3D(UNet3DConfig(**cfg)).to(dev)
                unet.load_state_dict(base.state_dict())
                cast = {k: p.to(dtype) for k, p in unet.named_parameters()}

                def step():
                    out = torch.func.functional_call(unet, cast, (x.to(dtype), t), dict(
                        video_embed=ve.to(dtype), enable_checkpoint=True))
                    ((out.float() - target) ** 2).mean().backward()

                used = _counted(torch, step, (), f"remat {case} {policy}")[1]
                results[policy] = ({k: p.grad for k, p in unet.named_parameters()}, used)
            check_remat_case(case, results)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def check_remat_case(case, results):
    ref, ref_used = results[None]

    def worst(grads):
        return max(float((grads[k] - ref[k]).norm() / ref[k].norm().clamp_min(1e-30))
                   for k in ref)

    for policy, (grads, used) in results.items():
        same = all(grads[k].equal(ref[k]) for k in ref)
        log(f"remat {case} {policy}: gradients vs no remat: bit for bit {same}, worst relative "
            f"L2 {worst(grads):.2e}; launches {used}")
        if not same:
            raise AssertionError(f"remat {case} {policy}: gradients differ from the unremat ones")
    if case == "fused blocks":
        # the fused blocks' forward kernel runs again under "nothing"
        fused = ref_used.get("conv3x3_bias_stats", 0)
        if not 0 < fused < results["nothing"][1].get("conv3x3_bias_stats", 0):
            raise AssertionError("remat nothing: the fused blocks' forward kernel was not replayed")
        return
    # the conv kernel: "nothing" replays every pallas_small forward, "conv"
    # none (its backward is cuDNN's, so every launch here is a forward)
    small = ref_used.get("conv3x3", 0)
    log(f"  conv3x3 forwards: no remat {small}, nothing {results['nothing'][1].get('conv3x3', 0)}, "
        f"conv {results['conv'][1].get('conv3x3', 0)}")
    if small <= 0:
        raise AssertionError(f"remat {case}: no conv kernel site launched")
    if results["conv"][1].get("conv3x3", 0) != small:
        raise AssertionError("remat conv: the conv kernel's forward ran again in the backward")
    if results["nothing"][1].get("conv3x3", 0) != 2 * small:
        raise AssertionError("remat nothing: the conv kernel's forward was not replayed")


# --------------------------------------------------------------- phase 4
# The main paths: the full-width celebv_text cascade at the 90-frame recipe,
# bf16 unets, CFG batch 2, driven through the serving engine. "serve" is
# the kernel path of PRs 1-2 (groupnorm_impl pallas); "serve_conv" the
# opt-in conv paths (groupnorm_impl fused, spatial_conv_impl pallas_small),
# cut to fewer requests and steps to keep the script well inside its limit.
# per_step: each kernel's launches per DDIM step of one group -- one CFG
# forward per unet: flash once (mid_attn); GroupNorm twice per
# ResnetBlock3D (27 / 33 blocks); cross-attention once per conditioned
# block (17 / 22: xattn_rows.SERVE_SITES); on the conv paths the fused block at 44 / 19 sites and
# the conv kernel at 7 / 0 (every other site is the plain conv and the
# plain GroupNorm: tests/test_torch_port_convpaths.py counts them).
# "serve_cascade" is configs/cascade_sr.yaml with the JAX package's recipe
# (16 x 64^2 -> 64 x 128^2): both sampling unets run flash at their joint
# bottleneck (flash_attention_sampling), 16 x 8 x 8 = 1024 tokens (unet 1)
# and 64 x 8 x 8 = 4096 (unet 2, memory-efficient); groupnorm and
# cross-attention are the plain impls, so no other kernel launches.
def both_unets(*knobs):
    return [f"unet{u}.{k}" for u in (1, 2) for k in knobs]


# the celebv_text settings at the 90-frame recipe, bf16 sampling
SERVE_90 = ["frame_numbers=[90,90]", "sample_compute_dtype=bfloat16"]
SERVE_PATHS = {
    "serve": dict(
        overrides=[*SERVE_90, *both_unets("groupnorm_impl=pallas", "cross_attention_impl=flash")],
        requests=REQUESTS, steps=STEPS,
        per_step={"flash_mqa_fwd": 2, "groupnorm_film_silu_fwd": 54 + 66,
                  "cross_attention_fwd": sites_per_step()}),
    "serve_conv": dict(
        overrides=[*SERVE_90, *both_unets("groupnorm_impl=fused", "spatial_conv_impl=pallas_small",
                                          "cross_attention_impl=flash")],
        requests=2, steps=20,
        per_step={"flash_mqa_fwd": 2, "conv3x3_bias_stats": 44 + 19, "conv3x3": 7 + 0,
                  "cross_attention_fwd": sites_per_step()}),
    "serve_cascade": dict(config="configs/cascade_sr.yaml", overrides=cascade_sr_overrides(),
                          requests=1, steps=CASCADE_STEPS, per_step={"flash_mqa_fwd": 2}),
}


def path_config(spec):
    """A path's config (its config file, else the celebv_text settings)
    under the path's overrides, and the overrides."""
    from dalle2_video_tpu_torch.utils.config import load_config

    return load_config(spec.get("config"), spec["overrides"]), spec["overrides"]


def serve(dev, torch, path: str, run_dir: str, profile: bool = False):
    import logging
    from concurrent.futures import wait

    import numpy as np

    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.serve.engine import GenerationEngine, GenRequest
    from dalle2_video_tpu_torch.serve.stack import build_generate_batch

    spec = SERVE_PATHS[path]
    requests, steps = spec["requests"], spec["steps"]
    cfg, knobs = path_config(spec)
    cfg["sample_seed"], cfg["run_dir"] = 0, run_dir
    frames, size = cfg["frame_numbers"][-1], cfg["frame_sizes"][-1]
    t0 = time.time()
    generate_batch = build_generate_batch(cfg, logging.getLogger("chip_smoke"), dev)
    log(f"{path}: stack built in {time.time() - t0:.1f} s "
        f"(frame_sizes {cfg['frame_sizes']}, frame_numbers {cfg['frame_numbers']}, "
        f"unet dims {cfg['unet1']['dim']}/{cfg['unet2']['dim']}, {' '.join(knobs)})")
    engine = GenerationEngine(generate_batch, buckets=(1, 2), max_wait_ms=50.0,
                              default_cond_scale=3.0, default_ddim_steps=steps)
    kernels = all_kernels()
    try:
        for k in kernels:
            k.reset()
        torch.cuda.reset_peak_memory_stats()
        t_submit = time.time()
        with ShapeRecord() as shapes:
            futs = [engine.submit(GenRequest(f"a person smiling #{i}", seed=100 + i,
                                             cond_scale=3.0, ddim_steps=steps))
                    for i in range(requests)]
            done, _ = wait(futs, timeout=900)
            if len(done) != requests:
                raise AssertionError(f"{path}: requests did not finish")
            results = [f.result() for f in futs]
        wall = time.time() - t_submit
        launches = {k.name: k.launches for k in kernels}
        stats = engine.stats()
    finally:
        engine.close()
    # the groups by their CFG batch (2 x the bucket): a group of k requests
    # returns k results that rode in it
    rode = Counter((2 * r["bucket"], r["batch_size"]) for r in results)
    groups_at = Counter()
    for (cfg_batch, k), count in rode.items():
        groups_at[cfg_batch] += count // k
    if sum(groups_at.values()) != stats["batches"] or not set(groups_at) <= set(XA_BATCHES):
        raise AssertionError(f"{path}: groups at CFG batches {dict(groups_at)}, "
                             f"{stats['batches']} groups; check_kernels holds row 5 at {XA_BATCHES}")
    calls = Counter()
    for cfg_batch, count in groups_at.items():
        calls.update({key: n * steps * count for key, n in serve_shapes(cfg_batch).items()})
    shapes.check(path, conv_path_shapes(path, {2 * 90 * r["batch_size"] for r in results}),
                 calls if path in ("serve", "serve_conv") else None,
                 gn_path_calls(path, groups_at, steps))

    for i, res in enumerate(results):
        vid = res["video"]
        if vid.shape != (frames, size, size, 3):
            raise AssertionError(f"{path} request {i}: shape {vid.shape}")
        if not (np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
            raise AssertionError(f"{path} request {i}: values not finite in [0, 1]")
        log(f"{path} request {i}: batch {res['batch_size']} (bucket {res['bucket']}) "
            f"group time {res['device_ms'] / 1e3:.2f} s -> "
            f"{frames / (res['device_ms'] / 1e3):.2f} frames/s; shape {vid.shape} "
            f"mean {float(vid.mean()):.3f} std {float(vid.std()):.3f}")
    groups = stats["batches"]
    want = {k.name: groups * steps * spec["per_step"].get(k.name, 0) for k in kernels}
    log(f"{path}: {requests} requests in {groups} groups, {steps} DDIM steps per stage, "
        f"wall {wall:.2f} s, {frames * requests / wall:.2f} frames/s overall, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{path}: launches {launches} expected {want}")
    if launches != want:
        raise AssertionError(f"{path}: kernel launch counts differ from the unet structure's")
    if requests > 1:
        diff = float(np.mean(results[0]["video"] != results[1]["video"]))
        log(f"{path}: share of values that differ between requests 0 and 1: {diff:.3f}")
    if profile:
        profile_request(cfg, dev, torch, steps=10, label=path)
    return launches


# ------------------------------------------------------- phase 4: options
# serve_options: the request options of scripts/serve.py::generate_batch on
# the serve recipe (celebv_text at 90 frames, bf16 unets, random weights
# from seed 0 with the unets' output convs redrawn, so that conditioning
# moves the output), OPTION_STEPS DDIM steps a stage, one request at a time
# through GenerationEngine. Each request: its name, its stack, its
# GenRequest fields and whether it differentiates the unets (guided
# inpainting). The stacks: "serve" (SERVE_PATHS["serve"]: row 5 and row
# 3), "xla" (the same with cross_attention_impl xla, the train recipe's
# knob: row 5 has no backward) and "dpmpp" (the same as "serve" with
# sampler dpmpp). The extension requests know the first OPTION_KNOWN of 90
# frames; long video asks for OPTION_FRAMES frames at the default overlap.
OPTION_STEPS = 10
OPTION_KNOWN = 22
OPTION_FRAMES = 180
OPTION_STACKS = {
    "serve": SERVE_PATHS["serve"]["overrides"],
    "xla": [*SERVE_PATHS["serve"]["overrides"], *both_unets("cross_attention_impl=xla")],
    "dpmpp": [*SERVE_PATHS["serve"]["overrides"], "sampler=dpmpp"],
}


def option_requests(known, mask):
    """[(name, stack, GenRequest fields, guided)] of serve_options: requests
    (a)-(e), the plain request (a) is compared with, and (c) a second time."""
    inpaint = dict(inpaint_video=known, inpaint_mask=mask)
    return [("plain", "serve", {}, False),
            ("(a) negative prompt", "serve", dict(negative_prompt="a person frowning"), False),
            ("(b) inpainting by replacement", "serve", inpaint, False),
            ("(c) inpainting with guidance", "xla", dict(inpaint, inpaint_method="guided"), True),
            # again, warm: the first pays the backward's first-call costs
            ("(c) again", "xla", dict(inpaint, inpaint_method="guided"), True),
            ("(d) long video", "serve", dict(n_frames=OPTION_FRAMES), False),
            ("(e) DPM++", "dpmpp", {}, False)]


def option_stack(cfg, dev, torch):
    """build_generate_batch on ``cfg`` with its unets' output convs redrawn
    (seeded; the JAX init leaves them at zero, and a zero output ignores the
    conditioning): (generate_batch, the stack's DALLE2Video)."""
    import logging
    from unittest import mock

    from dalle2_video_tpu_torch.serve import stack

    made = {}
    build = stack.build_stack

    def redrawn(cfg_, device, **kw):
        text_enc, wrapper = build(cfg_, device, **kw)
        g = torch.Generator().manual_seed(1)
        for unet in wrapper.decoder.unets:
            w = unet.to_out.Conv_0.weight
            bnd = 1.0 / w[0].numel() ** 0.5
            with torch.no_grad():
                w.copy_(torch.empty(w.shape).uniform_(-bnd, bnd, generator=g))
        made["wrapper"] = wrapper
        return text_enc, wrapper

    with mock.patch.object(stack, "build_stack", redrawn):
        gb = stack.build_generate_batch(cfg, logging.getLogger("chip_smoke"), dev)
    return gb, made["wrapper"]


def option_launches(windows: int, guided: bool) -> dict:
    """One request's launches as the unet structure predicts: per DDIM step
    of both stages and per window, serve's (rows 1, 3 and 5); with guidance
    the xla stack's forward (rows 1 and 3) and its backward, once a site
    (rows 2 and 4)."""
    per = dict(SERVE_PATHS["serve"]["per_step"])
    if guided:
        per.pop("cross_attention_fwd")
        per.update(flash_mqa_bwd=per["flash_mqa_fwd"],
                   groupnorm_film_silu_bwd=per["groupnorm_film_silu_fwd"])
    return {k: windows * OPTION_STEPS * n for k, n in per.items()}


def time_xattn_routes(dev, torch):
    """The three routes of CrossAttention at the 7 serving shapes
    (probes/xattn_rows.py: SERVE_SITES) at each CFG batch: "broadcast"
    (ops/cross_attention.py::broadcast_cross_attention), "xla"
    (cross_attention_reference) and "flash" (row 5's kernel), device ms by
    CUDA events, each step's sum beside it. Printed, not judged."""
    from dalle2_video_tpu_torch.ops import cross_attention as xa

    g = torch.Generator(device=dev).manual_seed(3)
    sc = 64**-0.5
    routes = {"broadcast": xa.broadcast_cross_attention, "xla": xa.cross_attention_reference,
              "flash": lambda q, k, v, s: xa.cross_attention(q, k, v, sm_scale=s)}
    for b in XA_BATCHES:
        step = Counter()
        for unet, n, m, sites in SERVE_SITES:
            q = torch.randn(b, n, 8, 64, generator=g, device=dev).to(torch.bfloat16)
            k, v = (torch.randn(b, m, 8, 64, generator=g, device=dev).to(q.dtype)
                    for _ in range(2))
            ms = {r: time_ms(lambda f=f: f(q, k, v, sc)) for r, f in routes.items()}
            step.update({r: sites * t for r, t in ms.items()})
            log(f"serve_options: cross-attention unet{unet} b={b} n={n} m={m}: "
                + ", ".join(f"{r} {t:.4f} ms" for r, t in ms.items())
                + f" (broadcast / flash {ms['broadcast'] / ms['flash']:.2f}, "
                f"xla / flash {ms['xla'] / ms['flash']:.2f})")
            del q, k, v
        log(f"serve_options: cross-attention, one DDIM step's {sites_per_step()} calls at "
            f"batch {b}: " + ", ".join(f"{r} {t:.3f} ms" for r, t in step.items()))
        torch.cuda.empty_cache()


def serve_options(dev, torch, run_dir: str):
    """serve_options: the refusal of guided inpainting on the serve stack,
    then requests (a)-(e) (option_requests), each alone, checked and timed;
    the path's launch counts and kernel shapes as the structure predicts,
    rows 2 and 4 launched under (c) only and on the tensor-core route; then
    the cross-attention routes timed (time_xattn_routes)."""
    from concurrent.futures import TimeoutError as FutureTimeout

    import numpy as np

    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.ops.flash_mqa import BWD_KERNEL
    from dalle2_video_tpu_torch.ops.video import resize_video
    from dalle2_video_tpu_torch.serve.engine import GenerationEngine, GenRequest
    from dalle2_video_tpu_torch.utils.config import load_config

    card = card_line()
    cfgs = {name: load_config(None, [*knobs, f"run_dir={run_dir}"])
            for name, knobs in OPTION_STACKS.items()}
    t_win, size = cfgs["serve"]["frame_numbers"][-1], cfgs["serve"]["frame_sizes"][-1]
    # the conditioning video at the base stage's size, resized to each stage's
    known = np.random.default_rng(0).random(
        (t_win, *(cfgs["serve"]["frame_sizes"][0],) * 2, 3), dtype=np.float32)
    mask = np.zeros((t_win, 1, 1, 1), np.float32)
    mask[:OPTION_KNOWN] = 1.0
    known_out = resize_video(torch.from_numpy(known[None]), size, clamp_range=(0.0, 1.0))[0]
    known_out = known_out.numpy()
    requests = option_requests(known, mask)
    overlap = t_win // 4
    windows = 1 + -(-(OPTION_FRAMES - t_win) // (t_win - overlap))
    kernels = all_kernels()
    for k in kernels:
        k.reset()
    want, results, passes = Counter(), {}, Counter()
    with ShapeRecord() as shapes:
        for name, cfg in cfgs.items():
            cfg["sample_seed"] = 0
            t0 = time.time()
            gb, wrapper = option_stack(cfg, dev, torch)
            log(f"serve_options: stack {name!r} built in {time.time() - t0:.1f} s "
                f"({' '.join(OPTION_STACKS[name][2:])})")
            engine = GenerationEngine(gb, buckets=(1,), max_wait_ms=5.0,
                                      default_cond_scale=3.0, default_ddim_steps=OPTION_STEPS)
            try:
                if name == "serve":
                    # before any of them: the serve stack (flash cross-attention)
                    # refuses guidance, and launches nothing for it
                    fut = engine.submit(GenRequest("a person smiling", seed=7, cond_scale=3.0,
                                                   ddim_steps=OPTION_STEPS, inpaint_video=known,
                                                   inpaint_mask=mask, inpaint_method="guided"))
                    try:
                        fut.result(timeout=300)
                    except ValueError as exc:
                        if "forward-only" not in str(exc):
                            raise
                        log(f"serve_options: the serve stack refuses guided inpainting: {exc}")
                    except FutureTimeout:
                        raise AssertionError("serve_options: the refusal did not come") from None
                    else:
                        raise AssertionError("serve_options: the serve stack (cross_attention_impl "
                                             "flash) answered guided inpainting")
                    if any(k.launches for k in kernels):
                        raise AssertionError("serve_options: the refused request launched kernels")
                windows_seen = []
                for label, stack_name, fields, guided in requests:
                    if stack_name != name:
                        continue
                    long = "n_frames" in fields
                    if long:
                        sample = wrapper.decoder.sample

                        def recording(*a, _sample=sample, **kw):
                            out = _sample(*a, **kw)
                            windows_seen.append(out)
                            return out

                        wrapper.decoder.sample = recording
                    before = {k.name: k.launches for k in kernels}
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.time()
                    try:
                        res = engine.generate(GenRequest("a person smiling", seed=7,
                                                         cond_scale=3.0, ddim_steps=OPTION_STEPS,
                                                         **fields), timeout=600)
                    finally:
                        if long:
                            del wrapper.decoder.sample
                    wall = time.time() - t0
                    got = {k.name: k.launches - before[k.name] for k in kernels}
                    n = windows if long else 1
                    expect = option_launches(n, guided)
                    if {k: v for k, v in got.items() if v} != expect:
                        raise AssertionError(f"serve_options {label}: launches {got}, the unet "
                                             f"structure gives {expect}")
                    want.update(expect)
                    passes[guided] += n
                    vid = res["video"]
                    frames = OPTION_FRAMES if long else t_win
                    if vid.shape != (frames, size, size, 3):
                        raise AssertionError(f"serve_options {label}: shape {vid.shape}")
                    if not (np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
                        raise AssertionError(f"serve_options {label}: values not finite in [0, 1]")
                    results[label] = vid
                    log(f"serve_options {label}: wall {wall:.3f} s (generate_batch "
                        f"{res['device_ms'] / 1e3:.3f} s), {frames / wall:.2f} frames/s, peak "
                        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
                        f"{expect}; mean {float(vid.mean()):.3f} std {float(vid.std()):.3f}; {card}")
                    if "inpaint_video" in fields:
                        err = float(np.abs(vid[:OPTION_KNOWN] - known_out[:OPTION_KNOWN]).max())
                        log(f"serve_options {label}: known frames vs the conditioning video at "
                            f"{size} px: max |diff| {err:.3e}")
                        if err > 1e-6:
                            raise AssertionError(f"serve_options {label}: the known frames moved "
                                                 f"by {err:.3e}")
                    if long:
                        if len(windows_seen) != windows:
                            raise AssertionError(f"serve_options {label}: {len(windows_seen)} "
                                                 f"windows, expected {windows}")
                        for j, win in enumerate(windows_seen[1:], start=1):
                            start = j * (t_win - overlap)
                            err = float((win[0, :overlap].float().cpu()
                                         - torch.from_numpy(vid[start:start + overlap]))
                                        .abs().max())
                            log(f"serve_options {label}: window {j} reproduces frames "
                                f"{start}-{start + overlap - 1}: max |diff| {err:.3e}")
                            if err > 1e-6:
                                raise AssertionError(f"serve_options {label}: window {j} moved "
                                                     f"frames an earlier window emitted")
            finally:
                engine.close()
            del gb, wrapper, engine
            torch.cuda.empty_cache()
        launches = {k.name: k.launches for k in kernels}
    moved = float(np.mean(results["plain"] != results["(a) negative prompt"]))
    log(f"serve_options: the negative prompt changed {100 * moved:.2f}% of the values")
    if moved == 0.0:
        raise AssertionError("serve_options: the negative prompt did not reach the unets")
    forward = passes[False] + passes[True]
    shapes.check("serve_options", conv_path_shapes("serve_options"),
                 Counter({key: n * OPTION_STEPS * passes[False]
                          for key, n in serve_shapes(2).items()}),
                 gn_path_calls("serve_options", {2: forward}, OPTION_STEPS,
                               backward_at={2: passes[True]}))
    log(f"serve_options: launches {launches} expected {dict(want)}")
    if {k: v for k, v in launches.items() if v} != dict(want):
        raise AssertionError("serve_options: kernel launch counts differ from the unet structure's")
    check_bwd_routes("serve_options", launches, need=True)
    log(f"serve_options: flash backward routes {BWD_KERNEL.routes}")
    time_xattn_routes(dev, torch)
    return launches

# --------------------------------------------------------------- phase 4c
# serve_text / train_text: the celebv_text unets (and, serving, the prior)
# conditioned on the 12 x 512 text tower's (b, 77, 512) encodings, built
# through dataclasses.replace as the JAX tests build them (no config key);
# the decoders' max_text_len is TEXT_LEN (256)
TEXT_UNET = dict(cond_on_text_encodings=True, text_embed_dim=512, max_text_len=TEXT_LEN)
TEXT_STEPS = 10  # DDIM steps a stage of each serve_text request
TEXT_TRAIN_STEPS = 3


def text_decoder(cfg, dev, per_frame: bool):
    """build_decoder's cascade for ``cfg`` with every unet conditioned on
    text encodings (TEXT_UNET); ``per_frame`` builds unet 1 for per-frame
    (b, k, d) video embeds. Weights from torch's default generator."""
    import dataclasses
    from unittest import mock

    from dalle2_video_tpu_torch.engine import decoder as dmod

    with mock.patch.object(dmod, "VideoDecoder", lambda config, device: config):
        dcfg = dmod.build_decoder(cfg, dev)
    dcfg = dataclasses.replace(dcfg, unets=tuple(dataclasses.replace(u, **TEXT_UNET)
                                                 for u in dcfg.unets))
    return dmod.VideoDecoder(dcfg, dev, per_frame_embeds=per_frame)


def serve_text(dev, torch, profile: bool = False):
    """serve_text: the serve recipe with text encodings, TEXT_STEPS DDIM
    steps a stage, cond_scale 3.0, one request at a time through
    DALLE2Video.generate: (a) a global video embed with the encodings of "a
    person smiling" (the prior's network takes them too), then the same
    with the encodings of "a person frowning" as negative_text_encodings;
    (b) temporal_emb on a decoder whose unet 1 takes per-frame embeds: a
    seeded (1, 512, 90) text embed, the same encodings, so 90 prior rows
    (best-of-2) and 93 / 349 context keys at unet 1's sites. Every video
    finite, of its shape, in [0, 1]; the negative and (b) change the video;
    every request's launches (rows 1, 3, 5) as the structure predicts, and
    row 5's shapes exactly TEXT_REQUESTS' at CFG batch 2. With ``profile``,
    (a) and (b) again under torch.profiler."""
    import dataclasses

    import numpy as np

    from dalle2_video_tpu_torch.data.tokenizer import tokenize
    from dalle2_video_tpu_torch.engine.dalle2video import DALLE2Video
    from dalle2_video_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from dalle2_video_tpu_torch.models.prior import DiffusionPrior, prior_from_config
    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.utils.keys import RowKeys

    card = card_line()
    cfg, knobs = path_config(SERVE_PATHS["serve"])
    t0 = time.time()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        text_enc = CLIPTextEncoder(CLIPTextConfig(embed_dim=cfg["dim"])).to(dev).eval()
        pc = prior_from_config(cfg, dev).config
        prior = DiffusionPrior(dataclasses.replace(pc, network=dataclasses.replace(
            pc.network, cond_on_text_encodings=True, text_encoding_dim=text_enc.cfg.width)), dev)
        decoders = {pf: text_decoder(cfg, dev, pf) for pf in (False, True)}
    # the output convs start at zero (the JAX init), which would make the
    # unets ignore their conditioning: redraw them, seeded
    gen = torch.Generator().manual_seed(1)
    for dec in decoders.values():
        for unet in dec.unets:
            w = unet.to_out.Conv_0.weight
            bnd = 1.0 / w[0].numel() ** 0.5
            with torch.no_grad():
                w.copy_(torch.empty(w.shape).uniform_(-bnd, bnd, generator=gen))
    n_params = [sum(p.numel() for p in u.parameters()) for u in decoders[True].unets]
    log(f"serve_text: stack built in {time.time() - t0:.1f} s: text tower 12 x 512, prior with "
        f"encoding tokens ({sum(p.numel() for p in prior.network.parameters()) / 1e6:.2f}M), "
        f"unets with text (per-frame unet 1) {n_params[0] / 1e6:.2f}M / {n_params[1] / 1e6:.2f}M; "
        f"{' '.join(knobs)}")
    tokens = torch.as_tensor(tokenize(["a person smiling", "a person frowning"]), device=dev)
    with torch.no_grad():
        embeds, encs = text_enc(tokens, return_encodings=True)
    enc, neg = encs[:1], encs[1:]
    g = torch.Generator(device=dev).manual_seed(0)
    frame_embed = torch.randn(1, cfg["dim"], cfg["frame_numbers"][0], generator=g, device=dev)
    plain, temporal = DALLE2Video(prior, decoders[False]), DALLE2Video(
        prior, decoders[True], temporal_emb=True)
    requests = [("(a) text encodings", plain, embeds[:1], {}, "a"),
                ("(a) with negative text encodings", plain, embeds[:1],
                 dict(negative_text_encodings=neg), "a"),
                ("(b) temporal_emb, per-frame embeds", temporal, frame_embed, {}, "b")]
    t_win, size = cfg["frame_numbers"][-1], cfg["frame_sizes"][-1]
    kernels = all_kernels()
    for k in kernels:
        k.reset()
    per_step = {"flash_mqa_fwd": 2, "groupnorm_film_silu_fwd": 54 + 66}
    want, want_x, videos = Counter(), Counter(), {}

    def request(wrapper, text_embed, kw):
        return wrapper.generate(RowKeys.from_request_seeds([7]), text_embed, enc,
                                cond_scale=3.0, sample_timesteps=TEXT_STEPS, **kw)

    with ShapeRecord() as shapes:
        for label, wrapper, text_embed, kw, req in requests:
            before = {k.name: k.launches for k in kernels}
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.time()
            video = request(wrapper, text_embed, kw)
            torch.cuda.synchronize()
            wall = time.time() - t0
            got = {k.name: k.launches - before[k.name] for k in kernels}
            xshapes = text_shapes(2, req)
            expect = {k: TEXT_STEPS * n for k, n in per_step.items()}
            expect["cross_attention_fwd"] = TEXT_STEPS * sum(xshapes.values())
            if {k: v for k, v in got.items() if v} != expect:
                raise AssertionError(f"serve_text {label}: launches {got}, the unet structure "
                                     f"gives {expect}")
            want.update(expect)
            want_x.update({key: TEXT_STEPS * n for key, n in xshapes.items()})
            vid = video[0].float().cpu().numpy()
            if vid.shape != (t_win, size, size, 3):
                raise AssertionError(f"serve_text {label}: shape {vid.shape}")
            if not (np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
                raise AssertionError(f"serve_text {label}: values not finite in [0, 1]")
            videos[label] = vid
            log(f"serve_text {label}: wall {wall:.3f} s, {t_win / wall:.2f} frames/s, peak "
                f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {expect}; "
                f"row 5 keys m {sorted({key[-1] for key in xshapes})}; mean {vid.mean():.3f} "
                f"std {vid.std():.3f}; {card}")
        launches = {k.name: k.launches for k in kernels}
    shapes.check("serve_text", conv_path_shapes("serve_text"), want_x,
                 gn_path_calls("serve", {2: len(requests)}, TEXT_STEPS))
    log(f"serve_text: launches {launches} expected {dict(want)}")
    if {k: v for k, v in launches.items() if v} != dict(want):
        raise AssertionError("serve_text: kernel launch counts differ from the unet structure's")
    (a, neg_label, b) = (r[0] for r in requests)
    for other in (neg_label, b):
        moved = float(np.mean(videos[a] != videos[other]))
        log(f"serve_text: {other} changed {100 * moved:.2f}% of (a)'s values")
        if moved == 0.0:
            raise AssertionError(f"serve_text: {other} did not change the video")
    if profile:
        for label, wrapper, text_embed, kw, _ in requests[::2]:
            profile_device(f"serve_text {label}", torch,
                           lambda: request(wrapper, text_embed, kw))
    del decoders, prior, text_enc, plain, temporal
    torch.cuda.empty_cache()
    return launches


def train_text(dev, torch, profile: bool = False):
    """train_text: the "train" recipe (batch 2, bf16 compute,
    cross_attention_impl xla) with both unets conditioned on the frozen text
    tower's encodings of seeded captions and unet 1 on per-frame embeds (a
    seeded (2, 90, 512) on the card), text_cond_drop_prob 0.5:
    TEXT_TRAIN_STEPS steps of each unet, then eval_loss each. Every loss
    finite, every parameter (the text and per-frame ones named) moved, the
    step and EMA counts right, every step's launches (rows 1-4) and the
    GroupNorm calls as the structure predicts. With ``profile``, one step of
    each unet under torch.profiler."""
    import numpy as np

    from dalle2_video_tpu_torch.data.tokenizer import tokenize
    from dalle2_video_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from dalle2_video_tpu_torch.models.layers import kernel_init_
    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.train.__main__ import SyntheticVideos, build_trainer

    n_steps = TEXT_TRAIN_STEPS
    cfg, knobs = path_config(TRAIN_PATHS["train"])
    b = cfg["decoder"]["batch_size"]
    frames, size = cfg["frame_numbers"][-1], cfg["frame_sizes"][-1]
    t0 = time.time()
    data = SyntheticVideos(b * (n_steps + 1), frames, size, cfg["dim"], cfg["channels"], seed=0)
    torch.cuda.reset_peak_memory_stats()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        text_enc = CLIPTextEncoder(CLIPTextConfig(embed_dim=cfg["dim"])).to(dev).eval()
        trainer = build_trainer(cfg, text_decoder(cfg, dev, per_frame=True))
    for unet in trainer.decoder.unets:
        w = unet.to_out.Conv_0.weight
        kernel_init_(w, w[0].numel())
    captions = [f"a person {w}" for w in ("smiling", "frowning", "talking", "laughing",
                                          "nodding", "blinking", "singing", "crying")]
    with torch.no_grad():
        _, encs = text_enc(torch.as_tensor(tokenize(captions[:b * (n_steps + 1)]), device=dev),
                           return_encodings=True)
    g = torch.Generator(device=dev).manual_seed(0)
    frame_embeds = torch.randn(b * (n_steps + 1), frames, cfg["dim"], generator=g, device=dev)
    new = {1: ["text_to_cond.weight", "text_to_cond.bias", "null_text_embed",
               "video_frame_to_token.weight", "video_frame_to_token.bias",
               "null_video_frame_token"],
           2: ["text_to_cond.weight", "text_to_cond.bias", "null_text_embed"]}
    for u, names in new.items():
        missing = set(names) - set(trainer.params(u - 1))
        if missing:
            raise AssertionError(f"train_text: unet {u} has no {sorted(missing)}")
    log(f"train_text: trainer built in {time.time() - t0:.1f} s; batch {b}, encodings "
        f"{tuple(encs.shape[1:])}, per-frame embeds {tuple(frame_embeds.shape[1:])}, "
        f"text_cond_drop_prob {trainer.decoder.config.text_cond_drop_prob}; {' '.join(knobs)}")
    start = [{k: p.detach().clone() for k, p in trainer.params(i).items()} for i in range(2)]
    kernels = all_kernels()
    as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    def run(u, fn, backward):
        for k in kernels:
            k.reset()
        want = {k.name: 0 for k in kernels}
        recompute = backward and cfg[f"unet{u}"].get("checkpoint_during_training", False)
        want.update(train_expected("train", u, backward, recompute))
        torch.cuda.synchronize()
        t = time.time()
        out = float(fn())
        torch.cuda.synchronize()
        ms = (time.time() - t) * 1e3
        got = {k.name: k.launches for k in kernels}
        if got != want:
            raise AssertionError(f"train_text: launches {got}, the unet structure predicts {want}")
        check_bwd_routes("train_text", got)
        if not np.isfinite(out):
            raise AssertionError(f"train_text: unet {u} loss {out}")
        for k, v in got.items():
            totals[k] += v
        return out, ms

    totals = Counter()
    ms = {1: [], 2: []}
    sl = lambda i: slice(i * b, (i + 1) * b)  # noqa: E731
    with ShapeRecord() as shapes:
        for step in range(n_steps):
            vid = as_dev(data.batch_items(np.arange(step * b, (step + 1) * b))["videos"])
            for u in (1, 2):
                loss, t_ms = run(u, lambda: trainer.train_step(
                    vid, video_embed=frame_embeds[sl(step)], text_encodings=encs[sl(step)],
                    unet_number=u), backward=True)
                ms[u].append(t_ms)
                log(f"train_text: step {step} unet {u}: loss {loss:.4f}, {t_ms:.1f} ms")
    shapes.check("train_text", conv_path_shapes("train_text"),
                 want_gn=gn_path_calls("train", steps=n_steps))
    vid = as_dev(data.batch_items(np.arange(n_steps * b, (n_steps + 1) * b))["videos"])
    for u in (1, 2):
        val, t_ms = run(u, lambda: trainer.eval_loss(
            vid, video_embed=frame_embeds[sl(n_steps)], text_encodings=encs[sl(n_steps)],
            unet_number=u), backward=False)
        log(f"train_text: eval_loss unet {u}: {val:.4f}, {t_ms:.1f} ms")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if trainer.steps != [n_steps] * 2 or [e.step for e in trainer.ema] != [n_steps] * 2:
        raise AssertionError(f"train_text: steps {trainer.steps}, EMA steps "
                             f"{[e.step for e in trainer.ema]}")
    for i in range(2):
        still = [k for k, p in trainer.params(i).items() if torch.equal(p.detach(), start[i][k])]
        if still:
            raise AssertionError(f"train_text: unet {i + 1} params that never moved: {still[:5]}")
    steady = {u: sum(ms[u][1:]) / max(len(ms[u]) - 1, 1) for u in (1, 2)}
    log(f"train_text: ms per step (first, then mean of the rest): unet 1 {ms[1][0]:.1f} / "
        f"{steady[1]:.1f}, unet 2 {ms[2][0]:.1f} / {steady[2]:.1f}; samples/s both "
        f"{b / (steady[1] + steady[2]) * 1e3:.2f}; peak memory {peak:.2f} GiB; every parameter "
        f"moved, the new ones {new}; launches {dict(totals)}; {card_line()}")
    if profile:
        vid = as_dev(data.batch_items(np.arange(b))["videos"])
        for u in (1, 2):
            profile_device(f"train_text step unet {u}", torch, lambda: trainer.train_step(
                vid, video_embed=frame_embeds[sl(0)], text_encodings=encs[sl(0)],
                unet_number=u))
    del trainer, text_enc
    torch.cuda.empty_cache()
    return {k.name: totals[k.name] for k in kernels}


# --------------------------------------------------------------- phase 5
TRAIN_BATCH = TRAIN_BT // 90
# The training paths at the same widths and recipe (attention_impl auto ->
# flash at the 5760-token bottlenecks, cross_attention_impl xla, bf16
# compute over f32 masters, batch 2). Each has its overrides, its steps per
# unet, and whether it makes the checkpoint round trip.
TRAIN_90 = ["frame_numbers=[90,90]", "decoder.bf16_compute=true",
            f"decoder.batch_size={TRAIN_BATCH}", *both_unets("cross_attention_impl=xla")]
TRAIN_PATHS = {
    "train": dict(overrides=[*TRAIN_90, *both_unets("groupnorm_impl=pallas")], steps=4,
                  checkpoint=True),
    "train_conv": dict(overrides=[*TRAIN_90, *both_unets("groupnorm_impl=fused",
                                                         "spatial_conv_impl=pallas_small")],
                       steps=3, checkpoint=False),
    # configs/cascade_sr.yaml with the recipe: batch 4, bf16 compute, the SR
    # unet memory-efficient with remat_policy conv (the file's)
    "train_cascade": dict(config="configs/cascade_sr.yaml",
                          overrides=[*cascade_sr_overrides(), "decoder.batch_size=4",
                                     "decoder.bf16_compute=true"],
                          steps=3, checkpoint=False),
}
CONV_SITES = {1: (44, 7), 2: (19, 0)}  # (fused blocks, pallas_small convs) per forward
# The conv paths' sites (dalle2_video_tpu_torch/probes/conv_rows.py owns
# them): the fused Block3D's (H, W, C, Co) per unet (unet 1's 44 sites a
# step, unet 2's 19) and unet 1's 7 pallas_small convs. The weight gradient
# (row 7) takes the fused sites at train_conv's B*T = TRAIN_BT (batch 2 x
# 90 frames); row 8 (conv + bias + statistics) at each path's B*T in its
# batch rows; row 6 the fused sites' dx (H, W, Co -> C) in train_conv's
# backward and the pallas_small forwards. check_conv_kernels holds each
# kernel at every such shape (CONV_SHAPES); the paths' runs fail if
# another reaches a kernel (conv_path_shapes).
CONV_SHAPES = all_shapes()


class ShapeRecord:
    """Counts the calls that reach the conv kernels' wrappers, the
    cross-attention wrapper and the GroupNorm wrappers while it is entered,
    by shape (the callers look each wrapper up by name in its module):
    conv3x3 (x's shape, Co), conv3x3_wgrad (x's shape, Co),
    conv3x3_bias_stats (x's shape, Co, batch rows), cross_attention (q's
    shape, m), groupnorm_film_silu (the kernel row's name, x's shape, G),
    groupnorm_film_bwd (the counting kernel's name, x's shape, G)."""

    def __init__(self):
        from dalle2_video_tpu_torch.models import layers
        from dalle2_video_tpu_torch.ops import fused_block as fb
        from dalle2_video_tpu_torch.ops import groupnorm_film as gn
        from dalle2_video_tpu_torch.ops import spatial_conv as sc

        self.targets = {"conv3x3": (sc, "conv3x3", lambda x, w, **_: (*x.shape, w.shape[0])),
                        "conv3x3_wgrad": (sc, "conv3x3_wgrad",
                                          lambda x, dy, **_: (*x.shape, dy.shape[3])),
                        "conv3x3_bias_stats": (fb, "conv_bias_stats",
                                               lambda x, w, bias, batch, **_: (
                                                   *x.shape, w.shape[0], batch)),
                        "cross_attention": (layers, "cross_attention",
                                            lambda q, k, v, **_: (*q.shape, k.shape[1])),
                        "groupnorm_film_silu": (
                            layers, "groupnorm_film_silu",
                            lambda x, *a, **_: (gn_rows.FWD, *x.shape, a[4])),
                        "groupnorm_film_bwd": (
                            gn, "groupnorm_film_bwd",
                            lambda x, g, av, bv, m, r, groups, kernel=gn.BWD_KERNEL, **_: (
                                kernel.name, *x.shape, groups))}
        self.seen = {k: Counter() for k in self.targets}
        self._orig = {}

    def __enter__(self):
        for name, (mod, attr, key) in self.targets.items():
            orig = self._orig[name] = getattr(mod, attr)

            def recording(*args, _orig=orig, _key=key, _seen=self.seen[name], **kw):
                _seen[_key(*args, **kw)] += 1
                return _orig(*args, **kw)

            setattr(mod, attr, recording)
        return self

    def __exit__(self, *exc):
        for name, (mod, attr, _) in self.targets.items():
            setattr(mod, attr, self._orig[name])

    def check(self, path, want_conv, want_xattn=None, want_gn=None):
        """The conv kernels took exactly the shapes of ``want_conv``, the
        cross-attention wrapper exactly the calls ``want_xattn`` counts, and
        the GroupNorm wrappers (rows 3, 4, 9) exactly the calls ``want_gn``
        counts by (row, b, L, C, G) (none if None)."""
        conv = {k: set(self.seen[k]) for k in KERNELS}
        xattn = self.seen["cross_attention"]
        gn_calls = self.seen["groupnorm_film_silu"] + self.seen["groupnorm_film_bwd"]
        log(f"{path}: conv kernel shapes {({k: len(v) for k, v in conv.items()})}, "
            f"cross-attention calls by (b, n, h, d, m) {dict(xattn)}, GroupNorm calls by "
            f"(row, b, L, C, G) {dict(gn_calls)}")
        if gn_calls != (want_gn or Counter()):
            raise AssertionError(f"{path}: GroupNorm calls {dict(gn_calls)}; the unets give "
                                 f"{dict(want_gn or {})} (probes/gn_rows.py: the map)")
        if conv != want_conv:
            raise AssertionError(f"{path}: the conv kernels took shapes {conv}; "
                                 f"the path gives {want_conv} (check_conv_kernels: CONV_SHAPES)")
        if xattn != (want_xattn or Counter()):
            raise AssertionError(f"{path}: cross-attention calls {dict(xattn)}; the unets give "
                                 f"{dict(want_xattn or {})} (probes/xattn_rows.py: SERVE_SITES)")


def gn_path_calls(path, groups_at=None, steps=0, backward_at=None):
    """Rows 3, 4 and 9's calls by (row, b, L, C, G) over a path's run, from
    the map (probes/gn_rows.py): "serve" and "serve_options" each group's
    DDIM steps at its CFG batch (``groups_at``: groups by batch, a long
    video's window a group), and on "serve_options" row 4 once a site in
    each DDIM step of the groups that differentiate the unets (guided
    inpainting; ``backward_at``, by CFG batch); "train" and "train_conv"
    ``steps`` train steps of both unets at the training batch; none
    elsewhere."""
    out = Counter()
    if path in ("serve", "serve_options"):
        for b, count in groups_at.items():
            out.update({(gn_rows.FWD, *key): n * steps * count
                        for key, n in gn_rows.serve_step(b).items()})
        for b, count in (backward_at or {}).items():
            for u in (1, 2):
                out.update({(gn_rows.BWD, *key): n * steps * count
                            for key, n in gn_rows.calls(gn_rows.BWD, b, u).items()})
    elif path in ("train", "train_conv"):
        for name in (gn_rows.FWD, gn_rows.BWD) if path == "train" else (gn_rows.ROW9,):
            for u in (1, 2):
                out.update({(name, *key): n * steps
                            for key, n in gn_rows.calls(name, TRAIN_BATCH, u).items()})
    return out


def check_bwd_routes(label, launches, need=False):
    """Every flash backward of a main path is bf16 at batch >= 2: the
    tensor-core route (the JAX package's _bwd_pallas arithmetic); with
    ``need``, the path launched it (serve_options: guided inpainting)."""
    from dalle2_video_tpu_torch.ops.flash_mqa import BWD_KERNEL

    n = launches.get(BWD_KERNEL.name, 0)
    if need and not n:
        raise AssertionError(f"{label}: no flash backward launched")
    if n and BWD_KERNEL.routes != {"tensor_cores": n}:
        raise AssertionError(f"{label}: flash backward routes {BWD_KERNEL.routes}, "
                             f"expected {n} on the tensor cores")


def train_expected(path, u, backward, recompute):
    """One forward (and backward) of unet u: flash once (mid_attn) and its
    backward; "train": GroupNorm twice per ResnetBlock3D (27 / 33 blocks)
    and its backward; "train_conv": kernel 8 at each fused site, and in the
    backward the GroupNorm backward (row 9), the conv dx (kernel 6) and the
    weight gradient (kernel 7) there; kernel 6 forward at each pallas_small
    site, whose backward is the plain conv's. A checkpointed block runs its
    forward again in the backward."""
    rf = 2 if recompute else 1
    if path == "train_cascade":
        # flash at the SR unet's 4096-token bottleneck (mid_attn: outside the
        # checkpointed blocks, so never replayed); unet 1's 1024 tokens take
        # the plain attention
        return {"flash_mqa_fwd": int(u == 2), "flash_mqa_bwd": int(u == 2 and backward)}
    want = {"flash_mqa_fwd": 1, "flash_mqa_bwd": int(backward)}
    if path == "train":
        blocks = {1: 27, 2: 33}[u]
        want.update(groupnorm_film_silu_fwd=2 * blocks * rf,
                    groupnorm_film_silu_bwd=2 * blocks * int(backward))
    else:
        fused, small = CONV_SITES[u]
        want.update(conv3x3_bias_stats=fused * rf, fused_block_gn_bwd=fused * int(backward),
                    conv3x3=small * rf + fused * int(backward),
                    conv3x3_wgrad=fused * int(backward))
    return want


def _same_state(a, b, path="state"):
    """Exact equality of two nested state dicts (tensors by value)."""
    import torch

    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"checkpoint: {path} keys differ")
        for k in a:
            _same_state(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"checkpoint: {path} lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_state(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        if not (a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())):
            raise AssertionError(f"checkpoint: {path} differs after reload")
    elif a != b:
        raise AssertionError(f"checkpoint: {path} differs after reload")


def train(dev, torch, path: str, profile: bool = False):
    """A decoder training path at full width on synthetic videos at the
    last stage's frames and size (numpy, seeded): its steps of its batch
    (decoder.batch_size), each training unet 1
    then unet 2 (as train_decoder does), one eval_loss per unet, and (if
    the path says so) one checkpoint save -> load round trip. Every
    kernel's launches are counted per step and must equal what the unet
    structure predicts."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from dalle2_video_tpu_torch.engine.decoder import build_decoder
    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.train import load_checkpoint, save_checkpoint
    from dalle2_video_tpu_torch.train.__main__ import SyntheticVideos, build_trainer

    spec = TRAIN_PATHS[path]
    n_steps = spec["steps"]
    cfg, knobs = path_config(spec)
    b = cfg["decoder"]["batch_size"]
    t0 = time.time()
    data = SyntheticVideos(b * (n_steps + 1), cfg["frame_numbers"][-1],
                           cfg["frame_sizes"][-1], cfg["dim"], cfg["channels"], seed=0)
    torch.cuda.reset_peak_memory_stats()
    trainer = build_trainer(cfg, build_decoder(cfg, dev))
    # the output convs start at zero (the JAX package's init): gradients
    # upstream of them then stay so small for the first steps that Adam's
    # update of some 1-dim params is below one f32 step, and "every
    # parameter moved" could not be checked; redraw them like the others
    from dalle2_video_tpu_torch.models.layers import kernel_init_

    for unet in trainer.decoder.unets:
        w = unet.to_out.Conv_0.weight
        kernel_init_(w, w[0].numel())
    n_params = [sum(p.numel() for p in u.parameters()) for u in trainer.decoder.unets]
    log(f"{path}: data and trainer built in {time.time() - t0:.1f} s; unet params "
        f"{n_params[0] / 1e6:.2f}M / {n_params[1] / 1e6:.2f}M; batch {b} of "
        f"{tuple(data.videos.shape[1:])} videos; {' '.join(knobs)}")
    start = [{k: p.detach().clone() for k, p in trainer.params(i).items()} for i in range(2)]
    kernels = all_kernels()

    def expected(u, backward: bool):
        recompute = backward and cfg[f"unet{u}"].get("checkpoint_during_training", False)
        want = {k.name: 0 for k in kernels}
        want.update(train_expected(path, u, backward, recompute))
        return want

    def run(fn, want):
        for k in kernels:
            k.reset()
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.time() - t) * 1e3
        got = {k.name: k.launches for k in kernels}
        if got != want:
            raise AssertionError(f"{path}: launches {got}, the unet structure predicts {want}")
        check_bwd_routes(path, got)
        return out, ms, got

    as_dev = lambda a: torch.as_tensor(a, device=dev)
    totals = {k.name: 0 for k in kernels}
    ms = {1: [], 2: []}
    with ShapeRecord() as shapes:
        for step in range(n_steps):
            batch = data.batch_items(np.arange(step * b, (step + 1) * b))
            vid, emb = as_dev(batch["videos"]), as_dev(batch["video_embeds"])
            for u in (1, 2):
                loss, t_ms, got = run(
                    lambda: trainer.train_step(vid, video_embed=emb, unet_number=u),
                    expected(u, backward=True))
                loss = float(loss)
                if not np.isfinite(loss):
                    raise AssertionError(f"{path}: unet {u} step {step} loss {loss}")
                ms[u].append(t_ms)
                for k, v in got.items():
                    totals[k] += v
                log(f"{path}: step {step} unet {u}: loss {loss:.4f}, {t_ms:.1f} ms")
    shapes.check(path, conv_path_shapes(path), want_gn=gn_path_calls(path, steps=n_steps))
    batch = data.batch_items(np.arange(n_steps * b, (n_steps + 1) * b))
    vid, emb = as_dev(batch["videos"]), as_dev(batch["video_embeds"])
    for u in (1, 2):
        val, t_ms, _ = run(lambda: trainer.eval_loss(vid, video_embed=emb, unet_number=u),
                           expected(u, backward=False))
        if not np.isfinite(float(val)):
            raise AssertionError(f"{path}: unet {u} eval loss {float(val)}")
        log(f"{path}: eval_loss unet {u}: {float(val):.4f}, {t_ms:.1f} ms")
    peak = torch.cuda.max_memory_allocated() / 2**30

    if trainer.steps != [n_steps] * 2 or [e.step for e in trainer.ema] != [n_steps] * 2:
        raise AssertionError(f"{path}: steps {trainer.steps}, EMA steps "
                             f"{[e.step for e in trainer.ema]}")
    for i in range(2):
        still = [k for k, p in trainer.params(i).items() if torch.equal(p.detach(), start[i][k])]
        if still:
            raise AssertionError(f"{path}: unet {i + 1} params that never moved: {still[:5]}")
    if spec["checkpoint"]:
        with tempfile.TemporaryDirectory() as tmp:
            state = trainer.state_dict()
            t = time.time()
            save_checkpoint(str(Path(tmp) / "ckpt"), state)
            _same_state(state, load_checkpoint(str(Path(tmp) / "ckpt"), map_location=dev))
            log(f"{path}: checkpoint save -> load round trip equal ({time.time() - t:.1f} s)")

    steady = {u: sum(ms[u][1:]) / max(len(ms[u]) - 1, 1) for u in (1, 2)}
    log(f"{path}: ms per step (first, then mean of the rest): unet 1 {ms[1][0]:.1f} / "
        f"{steady[1]:.1f}, unet 2 {ms[2][0]:.1f} / {steady[2]:.1f}; samples/s unet 1 "
        f"{b / steady[1] * 1e3:.2f}, unet 2 {b / steady[2] * 1e3:.2f}, both "
        f"{b / (steady[1] + steady[2]) * 1e3:.2f}; peak memory {peak:.2f} GiB")
    log(f"{path}: launches over {n_steps} + {n_steps} steps {totals} (every flash backward "
        f"on the tensor cores)")
    if profile:
        batch = data.batch_items(np.arange(b))
        vid, emb = as_dev(batch["videos"]), as_dev(batch["video_embeds"])
        for u in (1, 2):
            profile_device(f"{path} step unet {u}", torch, lambda: trainer.train_step(
                vid, video_embed=emb, unet_number=u))
    del trainer
    torch.cuda.empty_cache()
    return totals


# --------------------------------------------------------------- phase 5b
# "train_data": the "train" path's recipe trained from a CelebV-Text store
# through the entry point's own data path (train_decoder with the dataset
# and split that main builds from videos.preprocessed / videos.embed):
# a .vshard store of DATA_RECORDS clips at the preprocessor's output shape
# for celebv_text ((3, seq_len * fps, frame_size, frame_size) f32, 150 x
# 224^2, 90.3 MB a clip), read by DATA_WORKERS worker processes
# (loader: grain), DATA_STEPS steps of each unet at batch 2, the validation
# batch and a checkpoint.
DATA_RECORDS = 10
DATA_STEPS = 3
DATA_WORKERS = 4
DATA_PATH = dict(overrides=[*TRAIN_PATHS["train"]["overrides"], "loader=grain",
                            f"loader_workers={DATA_WORKERS}", "decoder.epochs=1"])


def write_store(cfg, root, n, seed=0):
    """The CLIP stage's store: ``n`` clips of seeded uniform [0, 1) frames
    normalised with the CLIP mean / std, as preprocess_frames leaves them
    (the card's machine has no cv2 to decode mp4s), in a .vshard file, and
    (n, 77) seeded int32 tokens (ids in the tokenizer's range) in a .npy.
    Returns the paths and the clips channels-last (T, S, S, 3), as the
    loader yields them."""
    import numpy as np

    from dalle2_video_tpu_torch.data.preprocess import CLIP_MEAN, CLIP_STD
    from dalle2_video_tpu_torch.data.shards import ShardWriter

    frames, size = cfg["seq_len"] * cfg["fps"], cfg["frame_size"]
    rng = np.random.default_rng(seed)
    clips = []
    store, tokens = f"{root}/videos.vshard", f"{root}/tokens.npy"
    with ShardWriter(store, (3, frames, size, size), np.float32) as w:
        for _ in range(n):
            clip = (rng.random((frames, size, size, 3), dtype=np.float32) - CLIP_MEAN) / CLIP_STD
            w.append(clip.transpose(3, 0, 1, 2))
            clips.append(clip)
    np.save(tokens, rng.integers(1, 49408, (n, 77)).astype(np.int32))
    return store, tokens, clips


class Stages:
    """What the README's stages hand on, under one temporary directory: the
    10-clip store and its tokens (written by train_clip), the run directory
    every stage checkpoints into, the handoff's embeddings (written by
    eval_clip, read by train_prior and train_data); serve_trained serves
    the run directory."""

    def __init__(self, root):
        self.root = root
        self.run_dir = f"{root}/runs"
        self.video_embed = f"{root}/handoff/videos.npy"
        self.text_embed = f"{root}/handoff/texts.npy"
        self.store = self.tokens = self.clips = None

    def args(self, *extra):
        """The stages' entry-point overrides (celebv_text otherwise)."""
        return [f"run_dir={self.run_dir}", f"videos.preprocessed={self.store}",
                f"texts.tokenized={self.tokens}", f"videos.embed={self.video_embed}",
                f"texts.embed={self.text_embed}", *extra]


def check_paired_crop(torch, dev, b, frames, size, crop):
    """ops/video.py::paired_random_crop on the card at offsets drawn there
    equals its CPU result at the same offsets, for the video and the
    low-res conditioning video, bit for bit."""
    from dalle2_video_tpu_torch.ops.video import paired_random_crop

    g = torch.Generator(device=dev).manual_seed(0)
    video = torch.randn(b, frames, size, size, 3, generator=g, device=dev)
    lowres = torch.randn(b, frames, size, size, 3, generator=g, device=dev)
    oh = torch.randint(0, size - crop + 1, (b,), generator=g, device=dev)
    ow = torch.randint(0, size - crop + 1, (b,), generator=g, device=dev)
    got = paired_random_crop(video, crop, lowres, offsets=(oh, ow))
    want = paired_random_crop(video.cpu(), crop, lowres.cpu(), offsets=(oh.cpu(), ow.cpu()))
    if not all(torch.equal(x.cpu(), y) for x, y in zip(got, want)):
        raise AssertionError("paired_random_crop: the card's windows differ from the CPU's")
    log(f"train_data: paired_random_crop of ({b}, {frames}, {size}, {size}, 3) to {crop} at "
        f"offsets {oh.tolist()} / {ow.tolist()}: the card's equals the CPU's bit for bit")


def train_data(dev, torch, stages):
    """Train the decoder from the stages' store and the handoff's video
    embeddings (eval_clip's videos.npy) through the entry point's data path
    (DATA_PATH), into the stages' run directory. Checks: every batch the
    trainer receives (on the device) equals the store's clips and the
    handoff's embeddings in BatchLoader's order (train shuffled by
    seed + epoch, val in order); finite losses; step and EMA counts; every
    step's and eval's kernel launches as train_expected("train", ...);
    the GroupNorm calls as the map's; a checkpoint written. Prints ms per
    step per unet, samples/s, peak memory, and per step the time the loop
    waited on the loader beside the step time."""
    from collections import deque

    import numpy as np

    from dalle2_video_tpu_torch.data.datasets import BatchLoader
    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.train import __main__ as entry
    from dalle2_video_tpu_torch.train import has_checkpoint
    from dalle2_video_tpu_torch.train.trainer import DecoderTrainer

    card = card_line()
    cfg, knobs = path_config(DATA_PATH)
    kernels = all_kernels()
    clips = stages.clips
    cfg = {**cfg, "run_dir": stages.run_dir,
           "videos": {**cfg["videos"], "preprocessed": stages.store,
                      "embed": stages.video_embed}}
    dataset, splits = entry.store_dataset(cfg)
    handoff = np.load(stages.video_embed)
    if not (handoff.shape == (DATA_RECORDS, cfg["dim"])
            and np.array_equal(dataset.video_embeds, handoff)):
        raise AssertionError(f"train_data: the dataset's video embeds are not the "
                             f"handoff's {handoff.shape}")
    log(f"train_data: video embeds from the handoff {stages.video_embed} {handoff.shape}")
    b = cfg["decoder"]["batch_size"]
    order = {"train": BatchLoader(dataset, b, splits["train"], seed=cfg["seed"]),
             "val": BatchLoader(dataset, b, splits["val"], shuffle=False)}
    expect = deque()  # (kind, indices) of the batches the loop will hand on, in order
    for kind in ("train", "val"):
        idx = order[kind]._epoch_indices()
        n = DATA_STEPS if kind == "train" else len(idx) // b
        expect.extend((kind, idx[i * b:(i + 1) * b]) for i in range(n))
    waits, records, seen = {"train": [], "val": []}, [], []

    class Timed:
        """The entry point's loader, timed: ms the loop waits on each
        next batch."""

        def __init__(self, inner, kind):
            self.inner, self.kind = inner, kind

        def __len__(self):
            return len(self.inner)

        def __iter__(self):
            it = iter(self.inner)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    waits[self.kind].append((time.perf_counter() - t0) * 1e3)
                    yield batch
            finally:
                if hasattr(it, "close"):
                    it.close()

    def checked(orig, backward):
        def call(self, video, *, video_embed=None, unet_number=1, **kw):
            u = unet_number
            torch.cuda.synchronize()
            if u == 1:  # the batch this step received: the store's clips in order
                kind, idx = expect.popleft()
                want = torch.from_numpy(np.stack([clips[i] for i in idx])).to(dev)
                emb = torch.from_numpy(dataset.video_embeds[idx]).to(dev)
                if not (torch.equal(video, want) and torch.equal(video_embed, emb)):
                    raise AssertionError(f"train_data: {kind} batch {idx.tolist()} differs "
                                         f"from the store's clips")
                seen.append((kind, idx.tolist()))
                del want
            for k in kernels:
                k.reset()
            t0 = time.perf_counter()
            out = orig(self, video, video_embed=video_embed, unet_number=u, **kw)
            loss = float(out)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = {k.name: k.launches for k in kernels}
            recompute = backward and cfg[f"unet{u}"].get("checkpoint_during_training", False)
            want_l = {k.name: 0 for k in kernels}
            want_l.update(train_expected("train", u, backward, recompute))
            if got != want_l:
                raise AssertionError(f"train_data: unet {u} launches {got}, the unet "
                                     f"structure predicts {want_l}")
            check_bwd_routes("train_data", got)
            if not np.isfinite(loss):
                raise AssertionError(f"train_data: unet {u} loss {loss}")
            records.append(dict(kind="train" if backward else "val", unet=u, ms=ms,
                                loss=loss))
            for k, v in got.items():
                totals[k] += v
            return out
        return call

    def checked_steps(trainer, mesh, u, **kw):
        """The entry point's train step (parallel/sharded.py's, on a
        one-rank mesh here), checked as ``checked`` does."""
        step = saved[1](trainer, mesh, u, **kw)
        call = checked(lambda self, video, *, video_embed=None, unet_number=u: step(
            video, video_embed), backward=True)
        return lambda video, emb: call(trainer, video, video_embed=emb, unet_number=u)

    totals = {k.name: 0 for k in kernels}
    saved = (entry.make_loaders, entry.make_sharded_train_step, DecoderTrainer.eval_loss)
    entry.make_loaders = lambda *a: tuple(
        Timed(loader, kind) for loader, kind in zip(saved[0](*a), ("train", "val")))
    entry.make_sharded_train_step = checked_steps
    DecoderTrainer.eval_loss = checked(saved[2], backward=False)
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    try:
        with ShapeRecord() as shapes:
            summary = entry.train_decoder(cfg, dataset, splits, dev, max_steps=DATA_STEPS)
    finally:
        entry.make_loaders, entry.make_sharded_train_step, DecoderTrainer.eval_loss = saved
    wall = time.time() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer = summary["trainer"]
    log(f"train_data: {' '.join(knobs)}; {len(dataset)} clips, split "
        f"{len(splits['train'])} / {len(splits['val'])}, batches seen {seen}")
    if expect:
        raise AssertionError(f"train_data: batches never reached the trainer: {list(expect)}")
    if trainer.steps != [DATA_STEPS] * 2 or [e.step for e in trainer.ema] != [DATA_STEPS] * 2:
        raise AssertionError(f"train_data: steps {trainer.steps}, EMA steps "
                             f"{[e.step for e in trainer.ema]}")
    if not has_checkpoint(f"{cfg['run_dir']}/decoder_{cfg['train_name']}"):
        raise AssertionError("train_data: no checkpoint written")
    want_gn = gn_path_calls("train", steps=DATA_STEPS)
    for u in (1, 2):  # the validation batch: one forward of each unet
        want_gn.update({(gn_rows.FWD, *key): n
                        for key, n in gn_rows.calls(gn_rows.FWD, TRAIN_BATCH, u).items()})
    shapes.check("train_data", conv_path_shapes("train_data"), want_gn=want_gn)
    del trainer, summary
    steps = [r for r in records if r["kind"] == "train"]
    for i in range(DATA_STEPS):
        u1, u2 = steps[2 * i], steps[2 * i + 1]
        log(f"train_data: step {i}: waited on the loader {waits['train'][i]:.1f} ms, then unet 1 "
            f"{u1['ms']:.1f} ms (loss {u1['loss']:.4f}), unet 2 {u2['ms']:.1f} ms "
            f"(loss {u2['loss']:.4f}) [{card}]")
    steady = {u: [r["ms"] for r in steps if r["unet"] == u][1:] for u in (1, 2)}
    mean = {u: sum(v) / len(v) for u, v in steady.items()}
    log(f"train_data: ms per step (mean after the first): unet 1 {mean[1]:.1f}, unet 2 "
        f"{mean[2]:.1f}; samples/s unet 1 {b / mean[1] * 1e3:.2f}, unet 2 "
        f"{b / mean[2] * 1e3:.2f}, both {b / (mean[1] + mean[2]) * 1e3:.2f}; loader waits "
        f"(ms) train {[round(w, 1) for w in waits['train']]}, val "
        f"{[round(w, 1) for w in waits['val']]}; peak memory {peak:.2f} GiB; "
        f"train_decoder wall {wall:.1f} s [{card}]")
    log(f"train_data: launches over {DATA_STEPS} + {DATA_STEPS} steps and one eval a unet "
        f"{totals}")
    size = cfg["frame_sizes"][-1]
    check_paired_crop(torch, dev, b, cfg["frame_numbers"][-1], size, size * 3 // 4)
    torch.cuda.empty_cache()
    return totals


# --------------------------------------------------------------- phase 5c
# Stages 1 and 2 of the README and serving what the stages trained. No
# kernel lies on them (ViViT's attention and the prior's are plain einsums
# in the JAX package too), so train_clip and train_prior launch none; the
# decoder then trains on the handoff's embeddings (train_data: rows 1-4)
# and serve_trained answers from the checkpoints (rows 1, 3, 5).
#   train_clip: the recipe's ViViT (224^2, patch 56, 150 frames, dim 512,
#     depth 2, 3 heads x 64) and frozen 12 x 512 text tower at clip.batch_size
#     64 on seeded device tensors, CLIP_STEPS steps with the multistep
#     schedule over CLIP_STEPS + 1 steps (a boundary at every step); then
#     python -m ...train.train_clip on the 10-clip store (2 epochs at batch
#     2, the thread loader) and ...train.eval_clip at batch 4 (a tail of 2).
#   train_prior: the recipe's prior (depth 6, dim 512, 8 heads x 64, 1000
#     timesteps) at prior.batch_size 256 on seeded embeddings, PRIOR_STEPS
#     steps; then python -m ...train.train_prior on the handoff (2 epochs
#     at batch 2, EMA blending every 2nd step after the 2nd).
CLIP_STEPS = 3
PRIOR_STEPS = 3
STAGE_CLIP = ["loader=thread", "clip.batch_size=2", "clip.epochs=2"]
STAGE_PRIOR = ["prior.batch_size=2", "prior.epochs=2", "prior.use_ema=true",
               "prior.ema_update_after_step=2", "prior.ema_update_every=2"]


def clip_step_flops(vc, tc, b):
    """Multiply-adds x 2 of one CLIP train step on b clips: the ViViT's
    forward (the patch embed, both transformers' projections, q k^T, p v and
    feed-forwards, the head's two convs and its projection) and its backward
    (twice the forward, but the patch embed's once: its input, the videos,
    takes no gradient), plus the frozen text tower's forward. Returns (step,
    the ViViT forward)."""
    p2c = vc.patch_size ** 2 * vc.in_channels
    n = (vc.frame_size // vc.patch_size) ** 2
    t, d, inner, s = vc.num_frames, vc.dim, vc.heads * vc.dim_head, vc.scale_dim_conv

    def transformer(seqs, tokens):
        per_token = 3 * d * inner + inner * d + 2 * d * d * vc.scale_dim_attn
        return vc.depth * seqs * (tokens * per_token + 2 * tokens * tokens * inner)

    embed = t * n * p2c * d
    vivit = (embed + transformer(t, n) + transformer(1, t)
             + (t // s) * 3 * s * d * d + (t // s // s) * 3 * s * d * d + (t // s // s) * d * d)
    w, m = tc.width, tc.context_length
    text = tc.layers * (m * 12 * w * w + 2 * m * m * w) + w * tc.embed_dim
    return 2 * b * (3 * vivit - embed + text), 2 * b * vivit


def timed_steps(torch, step, n):
    """n calls of step(), each synchronised: ([ms], [its result])."""
    ms, outs = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(step())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, outs


def moved(torch, before, module, label):
    """Every parameter of ``module`` differs from its copy in ``before``."""
    still = [k for k, p in module.named_parameters() if torch.equal(p.detach(), before[k])]
    if still:
        raise AssertionError(f"{label}: parameters did not move: {still[:6]}")


def no_launches(kernels, label):
    launches = {k.name: k.launches for k in kernels}
    if any(launches.values()):
        raise AssertionError(f"{label}: launched kernels {launches}; no kernel lies on it")
    return launches


def train_clip_phase(dev, torch, stages, profile: bool = False):
    """The CLIP stage on the card: the recipe-width step (finite loss, every
    ViViT parameter and the temperature moved, the text tower bit for bit
    unchanged, the lr at each step the schedule's), then the entry points
    on the 10-clip store: train_clip for 2 epochs, eval_clip writing 10 + 10
    embeddings (the tail included, each the towers' output on its clip
    within 1e-4 of the embeddings' scale), eval's frozen text tower bit for
    bit train's, the retrieval logged. No kernel launches."""
    import logging

    import numpy as np

    from dalle2_video_tpu_torch.data import shards
    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.train import eval_clip, train_clip
    from dalle2_video_tpu_torch.train.clip_trainer import ClipTrainer, ClipTrainerConfig, lr_at
    from dalle2_video_tpu_torch.utils.config import load_config

    card = card_line()
    kernels = all_kernels()
    for k in kernels:
        k.reset()
    cfg = load_config(None)
    cc, vc = cfg["clip"], train_clip.vivit_config(cfg)
    ccfg = ClipTrainerConfig(lr=cc["lr"], lr_scheduler=cc["lr_scheduler"],
                             lr_multistep_milestones=tuple(cc["lr_multistep_milestones"]),
                             lr_step_gamma=cc["lr_step_gamma"], total_steps=CLIP_STEPS + 1,
                             init_temperature=cc["init_temperature"])
    with ShapeRecord() as shapes:
        trainer = ClipTrainer(vc, train_clip.text_config(cfg), ccfg, seed=cfg["seed"],
                              device=dev)
        b = cc["batch_size"]
        g = torch.Generator(device=dev).manual_seed(0)
        videos = torch.randn((b, vc.num_frames, vc.frame_size, vc.frame_size, 3), generator=g,
                             device=dev)
        tokens = torch.randint(1, 49408, (b, 77), generator=g, device=dev)
        vivit0 = {k: p.detach().clone() for k, p in trainer.vivit.named_parameters()}
        temp0 = trainer.temperature.detach().clone()
        text0 = {k: v.clone() for k, v in trainer.text_encoder.state_dict().items()}
        torch.cuda.reset_peak_memory_stats()
        lrs = []

        def step():
            lrs.append(lr_at(ccfg, trainer.step))
            m = trainer.train_step(videos, tokens, trainer.dropout_generator)
            if trainer.optimizer.param_groups[0]["lr"] != lrs[-1]:
                raise AssertionError("train_clip: the step's lr is not the schedule's")
            return {k: float(v) for k, v in m.items()}

        ms, metrics = timed_steps(torch, step, CLIP_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        want_lrs = [cc["lr"] * cc["lr_step_gamma"] ** i for i in range(CLIP_STEPS)]
        if not np.allclose(lrs, want_lrs, rtol=1e-12):
            raise AssertionError(f"train_clip: lr {lrs}, the schedule gives {want_lrs}")
        if not all(np.isfinite(m["loss"]) for m in metrics):
            raise AssertionError(f"train_clip: losses {[m['loss'] for m in metrics]}")
        moved(torch, vivit0, trainer.vivit, "train_clip")
        if torch.equal(trainer.temperature.detach(), temp0):
            raise AssertionError("train_clip: the temperature did not move")
        now = trainer.text_encoder.state_dict()
        if not all(torch.equal(now[k], v) for k, v in text0.items()):
            raise AssertionError("train_clip: the frozen text tower changed")
        flops, fwd = clip_step_flops(vc, trainer.text_encoder.cfg, b)
        steady = sum(ms[1:]) / len(ms[1:])
        log(f"train_clip: ViViT {vc.frame_size}^2 patch {vc.patch_size}, {vc.num_frames} frames, "
            f"dim {vc.dim}, depth {vc.depth}, {vc.heads} x {vc.dim_head} heads, text tower "
            f"{trainer.text_encoder.cfg.layers} x {trainer.text_encoder.cfg.width}, batch {b}: "
            f"ms per step {[round(x, 1) for x in ms]} (first apart), mean after the first "
            f"{steady:.1f} ms, {b / steady * 1e3:.1f} samples/s, ~{flops / 1e12:.2f} TFLOP a step "
            f"(the ViViT's forward {fwd / 1e12:.2f}, its backward without the patch embed's "
            f"input gradient, the text tower's forward) -> {flops / steady / 1e9:.1f} TFLOP/s f32; "
            f"peak memory {peak:.2f} GiB; lr {lrs}; losses "
            f"{[round(m['loss'], 4) for m in metrics]}, temperature "
            f"{metrics[-1]['temperature']:.6f}, top1 {metrics[-1]['top1']:.3f} [{card}]")
        if profile:
            profile_device("train_clip step", torch, lambda: trainer.train_step(
                videos, tokens, trainer.dropout_generator))
        del trainer, videos, tokens, vivit0, text0, now
        torch.cuda.empty_cache()

        t = time.time()
        built = not shards.lib_path().exists()
        shards.build_native()
        log(f"train_clip: shard reader (native/shard_reader.cpp) "
            f"{'built by g++' if built else 'already built'} in {time.time() - t:.2f} s")
        t = time.time()
        stages.store, stages.tokens, stages.clips = write_store(cfg, stages.root, DATA_RECORDS)
        clip0 = stages.clips[0]
        log(f"train_clip: wrote {DATA_RECORDS} clips of {clip0.shape} f32 "
            f"({DATA_RECORDS * clip0.nbytes / 1e9:.2f} GB) and (10, 77) tokens in "
            f"{time.time() - t:.1f} s")
        t = time.time()
        trained = train_clip.main(stages.args(*STAGE_CLIP))["trainer"]
        t_train = time.time() - t
        if trained.step != 2 * 4:  # 8 train clips at batch 2, 2 epochs
            raise AssertionError(f"train_clip: {trained.step} steps, expected 8")
        records = []
        handler = logging.Handler()
        handler.emit = lambda rec: records.append(rec.getMessage())
        logging.getLogger("dalle2_video_tpu_torch.eval_clip").addHandler(handler)
        t = time.time()
        try:
            out = eval_clip.main(stages.args(*STAGE_CLIP, "clip.batch_size=4"))
        finally:
            logging.getLogger("dalle2_video_tpu_torch.eval_clip").removeHandler(handler)
        t_eval = time.time() - t
        etr = out["trainer"]
        ve, te = np.load(stages.video_embed), np.load(stages.text_embed)
        if ve.shape != (DATA_RECORDS, vc.dim) or te.shape != (DATA_RECORDS, vc.dim):
            raise AssertionError(f"eval_clip: wrote {ve.shape} and {te.shape}")
        a, c = trained.text_encoder.state_dict(), etr.text_encoder.state_dict()
        if not all(torch.equal(a[k], v) for k, v in c.items()):
            raise AssertionError("eval_clip: its frozen text tower is not train_clip's")
        a, c = trained.vivit.state_dict(), etr.vivit.state_dict()
        if etr.step != trained.step or not all(torch.equal(a[k], v) for k, v in c.items()):
            raise AssertionError("eval_clip: its ViViT is not train_clip's last checkpoint")
        errs = []
        tokens = np.load(stages.tokens)
        for i, clip in enumerate(stages.clips):  # each row: the towers on that clip alone
            v1 = etr.embed_video(torch.from_numpy(clip[None])).cpu().numpy()[0]
            t1 = etr.embed_text(torch.from_numpy(tokens[i:i + 1])).cpu().numpy()[0]
            errs.append((float(np.abs(ve[i] - v1).max() / np.abs(v1).max()),
                         float(np.abs(te[i] - t1).max() / np.abs(t1).max())))
        worst = max(max(e) for e in errs)
        line = [r for r in records if r.startswith("retrieval over")]
        log(f"train_clip: train_clip.main {t_train:.1f} s ({trained.step} steps at batch 2), "
            f"eval_clip.main {t_eval:.1f} s: wrote {ve.shape} video and {te.shape} text "
            f"embeddings (2 batches of 4 and the tail of 2), each row vs the towers on its clip "
            f"alone: worst |diff| / max|row| {worst:.2e}; eval's text tower is train's bit for "
            f"bit; {line} [{card}]")
        if worst > 1e-4 or not line or "over 10 pairs" not in line[0]:
            raise AssertionError(f"eval_clip: rows off their clips by {worst:.2e} (1e-4), or no "
                                 f"retrieval line ({line})")
        del trained, etr, out
        torch.cuda.empty_cache()
    shapes.check("train_clip", conv_path_shapes("train_clip"))
    return no_launches(kernels, "train_clip")


def train_prior_phase(dev, torch, stages, profile: bool = False):
    """The prior's training on the card: the recipe at prior.batch_size
    (finite losses, every parameter moved), then python -m
    ...train.train_prior on the handoff with use_ema: 8 steps, the EMA's,
    and the newest checkpoint loaded into a fresh trainer equal to the
    trained one bit for bit (params, Adam state, EMA shadow, step, the
    draw generator). No kernel launches."""
    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.train import load_latest, train_prior
    from dalle2_video_tpu_torch.utils.config import load_config

    card = card_line()
    kernels = all_kernels()
    for k in kernels:
        k.reset()
    cfg = load_config(None)
    pc = cfg["prior"]
    with ShapeRecord() as shapes:
        trainer = train_prior.build_prior_trainer(cfg, dev)
        b, d = pc["batch_size"], cfg["dim"]
        g = torch.Generator(device=dev).manual_seed(1)
        ve = torch.randn(b, d, generator=g, device=dev)
        te = torch.randn(b, d, generator=g, device=dev)
        before = {k: p.detach().clone() for k, p in trainer.prior.network.named_parameters()}
        torch.cuda.reset_peak_memory_stats()
        ms, losses = timed_steps(torch, lambda: float(trainer.train_step(ve, te)), PRIOR_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train_prior: losses {losses}")
        moved(torch, before, trainer.prior.network, "train_prior")
        steady = sum(ms[1:]) / len(ms[1:])
        n_params = sum(p.numel() for p in trainer.prior.network.parameters())
        log(f"train_prior: prior depth {pc['depth']}, dim {d}, {pc['heads']} x {pc['dim_head']} "
            f"heads, {pc['timesteps']} timesteps ({n_params / 1e6:.1f}M params), batch {b}: ms "
            f"per step {[round(x, 2) for x in ms]} (first apart), mean after the first "
            f"{steady:.2f} ms, {b / steady * 1e3:.0f} samples/s; peak memory {peak:.3f} GiB; "
            f"losses {[round(x, 4) for x in losses]} [{card}]")
        if profile:
            profile_device("train_prior step", torch, lambda: trainer.train_step(ve, te))
        del trainer, before

        t = time.time()
        summary = train_prior.main(stages.args(*STAGE_PRIOR))
        wall = time.time() - t
        trained = summary["trainer"]
        if trained.step != 2 * 4 or trained.ema.step != 2 * 4:
            raise AssertionError(f"train_prior: steps {trained.step}, EMA {trained.ema.step}")
        ckpt = f"{stages.run_dir}/prior_default"
        fresh = train_prior.build_prior_trainer(load_config(None, stages.args(*STAGE_PRIOR)), dev)
        fresh.load_state_dict(load_latest(ckpt, map_location=dev))
        _same_state(trained.state_dict(), fresh.state_dict(), "prior")
        shadow_is_online = all(torch.equal(trained.ema.params[k], p)
                               for k, p in trained.prior.network.named_parameters())
        if shadow_is_online:
            raise AssertionError("train_prior: the EMA shadow equals the online params")
        log(f"train_prior: train_prior.main on the handoff {wall:.1f} s: {trained.step} steps "
            f"at batch 2, EMA step {trained.ema.step}, train loss "
            f"{summary['train_loss']:.4f}, val loss {summary.get('val_loss')}; {ckpt} reloaded "
            f"into a fresh trainer: params, Adam state, EMA shadow, step and generator equal "
            f"bit for bit [{card}]")
        del trained, fresh, summary
        torch.cuda.empty_cache()
    shapes.check("train_prior", conv_path_shapes("train_prior"))
    return no_launches(kernels, "train_prior")


def serve_trained(dev, torch, stages):
    """The serve recipe built from the stages' run directory: the served
    prior's parameters equal its checkpoint's EMA shadow (and not its
    online params), the served unets the decoder's best state's EMA
    shadows; one request at OPTION_STEPS DDIM steps a stage through the
    engine: a finite (90, 128, 128, 3) video in [0, 1], the launches of
    serve_options' plain request (rows 1, 3, 5), the kernel shapes the
    map's."""
    import logging
    from unittest import mock

    import numpy as np

    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.serve import stack
    from dalle2_video_tpu_torch.serve.engine import GenerationEngine, GenRequest
    from dalle2_video_tpu_torch.train import load_best, load_params_subtree
    from dalle2_video_tpu_torch.utils.config import load_config

    card = card_line()
    cfg = load_config(None, [*SERVE_PATHS["serve"]["overrides"], f"run_dir={stages.run_dir}"])
    cfg["sample_seed"] = 0
    made = {}
    build = stack.build_stack

    def keep(cfg_, device, **kw):
        made["stack"] = build(cfg_, device, **kw)
        return made["stack"]

    t0 = time.time()
    with mock.patch.object(stack, "build_stack", keep):
        gb = stack.build_generate_batch(cfg, logging.getLogger("chip_smoke"), dev)
    t_build = time.time() - t0
    wrapper = made["stack"][1]
    prior_ckpt, dec_ckpt = f"{stages.run_dir}/prior_default", f"{stages.run_dir}/decoder_default"
    shadow = load_params_subtree(prior_ckpt, map_location=dev)
    served = dict(wrapper.prior.network.named_parameters())
    if set(served) != set(shadow) or not all(torch.equal(served[k], v) for k, v in shadow.items()):
        raise AssertionError("serve_trained: the served prior is not its checkpoint's EMA shadow")
    online = load_best(prior_ckpt, map_location=dev)["params"]
    if all(torch.equal(served[k], v) for k, v in online.items()):
        raise AssertionError("serve_trained: the served prior is the online params, not the EMA")
    state = load_best(dec_ckpt, map_location=dev)
    for i, unet in enumerate(wrapper.decoder.unets):
        ema = state["ema"][i]["params"]
        if not all(torch.equal(p, ema[k]) for k, p in unet.named_parameters()):
            raise AssertionError(f"serve_trained: unet {i + 1} is not the best state's EMA shadow")
    log(f"serve_trained: stack built from {stages.run_dir} in {t_build:.1f} s: the prior equals "
        f"{prior_ckpt}'s EMA shadow (step {load_best(prior_ckpt)['ema']['step']}), unets 1 and 2 "
        f"the best decoder state's EMA shadows (step {state['steps']}), bit for bit")
    del state, shadow, online
    engine = GenerationEngine(gb, buckets=(1,), max_wait_ms=5.0, default_cond_scale=3.0,
                              default_ddim_steps=OPTION_STEPS)
    kernels = all_kernels()
    try:
        for k in kernels:
            k.reset()
        torch.cuda.reset_peak_memory_stats()
        with ShapeRecord() as shapes:
            t0 = time.time()
            res = engine.generate(GenRequest("a person smiling", seed=7, cond_scale=3.0,
                                             ddim_steps=OPTION_STEPS), timeout=600)
            wall = time.time() - t0
        launches = {k.name: k.launches for k in kernels}
    finally:
        engine.close()
    vid = res["video"]
    frames, size = cfg["frame_numbers"][-1], cfg["frame_sizes"][-1]
    if vid.shape != (frames, size, size, 3) or not (
            np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
        raise AssertionError(f"serve_trained: video {vid.shape} not finite in [0, 1]")
    shapes.check("serve_trained", conv_path_shapes("serve_trained"),
                 Counter({key: n * OPTION_STEPS for key, n in serve_shapes(2).items()}),
                 gn_path_calls("serve", {2: 1}, OPTION_STEPS))
    want = option_launches(1, False)
    log(f"serve_trained: one request, {OPTION_STEPS} DDIM steps a stage: wall {wall:.3f} s, "
        f"{frames / wall:.2f} frames/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; mean {float(vid.mean()):.3f} std "
        f"{float(vid.std()):.3f}; launches {launches} expected {want} [{card}]")
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError("serve_trained: kernel launch counts differ from the unet structure's")
    del gb, wrapper, made, engine
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- import_reference
# The reference's torch checkpoints (models/torch_import.py) at full width,
# drawn from the importers' walks (each reference key's shape; the port
# parameter it fills): a ViViT at the CLIP recipe (150 x 224^2, 25.5M)
# through train_clip / eval_clip's torch_vivit_ckpt; a decoder at the
# serve recipe (celebv_text, 90 frames), with non-parameter buffers among
# its keys, loaded into a serving stack that answers one request; the
# trainer bundle (EMA shadows the parameters + 1, steps set) into the
# "train" recipe's trainer, then one step per unet. Walls from
# utils/profiling.StepTimer; flops_of of one CLIP step beside
# clip_step_flops.
IMPORT_BUFFERS = {"noise_schedulers.0.betas": (1000,), "noise_schedulers.1.betas": (1000,),
                  "lowres_conds.1.blur_kernel": (3, 3)}
FLOP_RATIO_FAIL = 0.10  # flops_of vs clip_step_flops: a larger gap means one count is wrong


def import_reference(dev, torch, stages):
    """See above. Returns the launches of the imported decoder's request
    and the bundle's train steps."""
    import logging
    from unittest import mock

    import numpy as np

    from dalle2_video_tpu_torch.engine.decoder import build_decoder
    from dalle2_video_tpu_torch.models import torch_import
    from dalle2_video_tpu_torch.models.vivit import ViViT
    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.serve import stack
    from dalle2_video_tpu_torch.serve.engine import GenerationEngine, GenRequest
    from dalle2_video_tpu_torch.train import eval_clip, train_clip
    from dalle2_video_tpu_torch.train.__main__ import SyntheticVideos, build_trainer
    from dalle2_video_tpu_torch.train.clip_trainer import ClipTrainer
    from dalle2_video_tpu_torch.utils.config import load_config
    from dalle2_video_tpu_torch.utils.profiling import StepTimer, flops_of

    card = card_line()
    root = f"{stages.root}/import"
    gen = torch.Generator().manual_seed(0)
    kernels = all_kernels()
    for k in kernels:
        k.reset()

    def same(got, want, label):
        bad = [k for k, v in want.items() if not torch.equal(got[k], v.to(got[k].device))]
        if set(got) != set(want) or bad:
            raise AssertionError(f"import_reference: {label} differs from the drawn tensors "
                                 f"under the walk's conversions: {bad[:6]}")

    def timed(fn):
        timer = StepTimer()
        timer.start()
        out = fn()
        return out, timer.stop(out if isinstance(out, torch.Tensor) else None)

    # ---- the ViViT through the CLIP entry points
    cfg = load_config(None)
    vc = train_clip.vivit_config(cfg)
    with torch.device("meta"):
        walk = torch_import.vivit_walk(ViViT(vc))
    sd = torch_import.draw_walk(walk, gen)
    want = {e.port_key: e.convert(sd[e.ref_key]) for e in walk}
    import os

    os.makedirs(root, exist_ok=True)
    vivit_ckpt = f"{root}/video_encoder_last.pt"
    torch.save(sd, vivit_ckpt)
    args = [f"run_dir={root}/runs", f"videos.preprocessed={stages.store}",
            f"texts.tokenized={stages.tokens}", f"videos.embed={root}/videos.npy",
            f"texts.embed={root}/texts.npy", *STAGE_CLIP, f"torch_vivit_ckpt={vivit_ckpt}"]
    first = []
    step = ClipTrainer.train_step

    def recording_step(self, *a, **kw):
        if not first:
            first.append({k: v.detach().clone() for k, v in self.vivit.state_dict().items()})
        return step(self, *a, **kw)

    with mock.patch.object(ClipTrainer, "train_step", recording_step):
        trained, t_train = timed(lambda: train_clip.main(args))
    same(first[0], want, "train_clip's ViViT at its first step")
    if trained["trainer"].step != 8 or not math.isfinite(trained["train"]["loss"]):
        raise AssertionError(f"import_reference: train_clip took {trained['trainer'].step} "
                             f"steps, loss {trained['train'].get('loss')}")
    evald, t_eval = timed(lambda: eval_clip.main(args + ["clip.batch_size=4"]))
    same(dict(evald["trainer"].vivit.state_dict()), want, "eval_clip's ViViT")
    log(f"import_reference: a reference ViViT ({sum(v.numel() for v in sd.values()) / 1e6:.1f}M, "
        f"{vc.num_frames} x {vc.frame_size}^2, {len(sd)} keys drawn from the walk): "
        f"train_clip.main with torch_vivit_ckpt {t_train:.2f} s ({trained['trainer'].step} "
        f"steps at batch 2; the ViViT at its first step the converted tensors bit for bit), "
        f"eval_clip.main {t_eval:.2f} s (its ViViT the converted tensors bit for bit, over the "
        f"run's checkpoint) [{card}]")
    del trained, evald, first
    torch.cuda.empty_cache()

    # flops_of of one recipe step beside clip_step_flops
    b = cfg["clip"]["batch_size"]
    trainer = ClipTrainer(vc, train_clip.text_config(cfg), seed=cfg["seed"], device=dev)
    trainer.vivit.load_state_dict(want, strict=True)
    g = torch.Generator(device=dev).manual_seed(0)
    videos = torch.randn((b, vc.num_frames, vc.frame_size, vc.frame_size, 3), generator=g,
                         device=dev)
    tokens = torch.randint(1, 49408, (b, 77), generator=g, device=dev)
    counted = flops_of(trainer.train_step, videos, tokens, trainer.dropout_generator)
    formula, _ = clip_step_flops(vc, trainer.text_encoder.cfg, b)
    ratio = counted / formula
    log(f"import_reference: flops_of(one train_clip step at batch {b}) {counted / 1e12:.4f} "
        f"TFLOP (FlopCounterMode: matmuls and convolutions, forward and backward), "
        f"clip_step_flops {formula / 1e12:.4f} TFLOP, ratio {ratio:.5f} [{card}]")
    if abs(ratio - 1.0) > FLOP_RATIO_FAIL:
        raise AssertionError(f"import_reference: flops_of / clip_step_flops = {ratio:.4f}, more "
                             f"than {FLOP_RATIO_FAIL:.0%} apart: one of the counts is wrong")
    del trainer, videos, tokens
    torch.cuda.empty_cache()

    # ---- the decoder, served
    scfg = load_config(None, [*SERVE_PATHS["serve"]["overrides"], f"run_dir={root}/no_runs"])
    scfg["sample_seed"] = 0
    made = {}
    build = stack.build_stack

    def keep(cfg_, device, **kw):
        made["stack"] = build(cfg_, device, **kw)
        return made["stack"]

    with mock.patch.object(stack, "build_stack", keep):
        gb = stack.build_generate_batch(scfg, logging.getLogger("chip_smoke"), dev)
    decoder = made["stack"][1].decoder
    dwalk = torch_import.decoder_walk(decoder)
    dsd = torch_import.draw_walk(dwalk, gen)
    for key, shape in IMPORT_BUFFERS.items():
        dsd[key] = torch.rand(shape, generator=gen)
    dec_ckpt = f"{root}/decoder_last.pt"
    torch.save(dsd, dec_ckpt)
    skipped, t_load = timed(lambda: torch_import.load_decoder_torch_ckpt(dec_ckpt, decoder))
    if sorted(skipped) != sorted(IMPORT_BUFFERS):
        raise AssertionError(f"import_reference: skipped {skipped}, the buffers are "
                             f"{sorted(IMPORT_BUFFERS)}")
    own = {f"{i}.{k}": v for i, u in enumerate(decoder.unets) for k, v in u.state_dict().items()}
    dwant = {e.port_key: e.convert(dsd[e.ref_key]) for e in dwalk if e.port_key is not None}
    same(own, dwant, "the served decoder")
    n_drop = sum(e.port_key is None for e in dwalk)
    log(f"import_reference: a reference decoder ({sum(v.numel() for v in dsd.values()) / 1e6:.1f}M"
        f", {len(dsd)} keys: {len(dwalk)} from the walk, {n_drop} of them nulls no port "
        f"parameter takes, and {len(IMPORT_BUFFERS)} buffers) loaded in {t_load:.2f} s into the "
        f"serve recipe's unets, bit for bit; skipped exactly {sorted(skipped)}")
    del own, dwant
    engine = GenerationEngine(gb, buckets=(1,), max_wait_ms=5.0, default_cond_scale=3.0,
                              default_ddim_steps=OPTION_STEPS)
    try:
        for k in kernels:
            k.reset()
        torch.cuda.reset_peak_memory_stats()
        with ShapeRecord() as shapes:
            res, wall = timed(lambda: engine.generate(GenRequest(
                "a person smiling", seed=7, cond_scale=3.0, ddim_steps=OPTION_STEPS),
                timeout=600))
        served = {k.name: k.launches for k in kernels}
    finally:
        engine.close()
    vid = res["video"]
    frames, size = scfg["frame_numbers"][-1], scfg["frame_sizes"][-1]
    if vid.shape != (frames, size, size, 3) or not (
            np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
        raise AssertionError(f"import_reference: video {vid.shape} not finite in [0, 1]")
    shapes.check("import_reference", conv_path_shapes("serve_trained"),
                 Counter({key: n * OPTION_STEPS for key, n in serve_shapes(2).items()}),
                 gn_path_calls("serve", {2: 1}, OPTION_STEPS))
    want_served = option_launches(1, False)
    log(f"import_reference: the imported decoder served one request, {OPTION_STEPS} DDIM steps a "
        f"stage: wall {wall:.3f} s, {frames / wall:.2f} frames/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; mean {float(vid.mean()):.3f} std "
        f"{float(vid.std()):.3f}; launches {served} expected {want_served} [{card}]")
    if {k: v for k, v in served.items() if v} != want_served:
        raise AssertionError("import_reference: the request's launches differ from the unet "
                             "structure's")
    del gb, made, engine, decoder
    torch.cuda.empty_cache()

    # ---- the trainer bundle, then a step per unet
    tcfg, _ = path_config(TRAIN_PATHS["train"])
    trainer = build_trainer(tcfg, build_decoder(tcfg, dev))
    ema_sd = {}
    for i in range(2):
        pref = f"unets.{i}."
        for k, v in dsd.items():
            if k.startswith(pref):
                ema_sd[f"{i}.ema_model.{k[len(pref):]}"] = v + 1.0
        ema_sd[f"{i}.initted"] = torch.tensor(True)
        ema_sd[f"{i}.step"] = torch.tensor(120 + i)
    bundle = {"model": dsd, "version": "0.0.0", "steps": torch.tensor([1200, 340]),
              "optim0": {"state": {}, "param_groups": []}, "sched0": {}, "ema": ema_sd}
    bundle_ckpt = f"{root}/trainer.pt"
    torch.save(bundle, bundle_ckpt)
    del bundle, ema_sd
    _, t_load = timed(lambda: torch_import.load_trainer_torch_ckpt(bundle_ckpt, trainer))
    steps, ema_steps = list(trainer.steps), [e.step for e in trainer.ema]
    if steps != [1200, 340] or ema_steps != [120, 121]:
        raise AssertionError(f"import_reference: steps {steps}, EMA steps {ema_steps}")
    for i in range(2):
        ents = [e for e in dwalk if e.port_key is not None and e.port_key.startswith(f"{i}.")]
        same(trainer.params(i), {e.port_key.split(".", 1)[1]: e.convert(dsd[e.ref_key])
                                 for e in ents}, f"unet {i + 1}'s parameters")
        same(trainer.ema[i].params, {e.port_key.split(".", 1)[1]: e.convert(dsd[e.ref_key] + 1.0)
                                     for e in ents}, f"unet {i + 1}'s EMA shadow")
    bt = tcfg["decoder"]["batch_size"]
    data = SyntheticVideos(bt, tcfg["frame_numbers"][-1], tcfg["frame_sizes"][-1], tcfg["dim"],
                           tcfg["channels"], seed=0)
    vid = torch.as_tensor(data.videos, device=dev)
    emb = torch.as_tensor(data.embeds, device=dev)
    totals = Counter(served)
    torch.cuda.reset_peak_memory_stats()
    ms = {}
    for u in (1, 2):
        for k in kernels:
            k.reset()
        loss, dt = timed(lambda: trainer.train_step(vid, video_embed=emb, unet_number=u))
        ms[u] = dt * 1e3
        got = {k.name: k.launches for k in kernels}
        want_step = {k.name: 0 for k in kernels}
        want_step.update(train_expected("train", u, backward=True, recompute=False))
        if got != want_step or not math.isfinite(float(loss)):
            raise AssertionError(f"import_reference: unet {u} step from the bundle: loss "
                                 f"{float(loss)}, launches {got}, expected {want_step}")
        check_bwd_routes(f"import_reference unet {u}", got, need=True)
        totals.update(got)
    log(f"import_reference: the trainer bundle ({os.path.getsize(bundle_ckpt) / 1e6:.0f} MB) "
        f"loaded in {t_load:.2f} s: parameters and EMA shadows (+1) bit for bit, steps "
        f"{steps}, EMA steps {ema_steps}, fresh Adam state; one step "
        f"per unet on the train recipe at batch {bt}: {ms[1]:.1f} / {ms[2]:.1f} ms (first "
        f"calls), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, rows 1-4 as "
        f"train predicts [{card}]")
    del trainer, vid, emb
    torch.cuda.empty_cache()
    return {k.name: totals[k.name] for k in kernels}


# --------------------------------------------------------------- phase 5e
# Progressive distillation (train/distill.py) on the "train" recipe's
# decoder (TRAIN_90, groupnorm_impl pallas, cross_attention_impl xla: row
# 5 has no backward and a trainer refuses it), the teacher from seed 0
# with its output convs redrawn (as train's), bf16 sampling unets, batch 2
# of synthetic 90 x 128^2 videos: unet 1 DISTILL_STEPS steps at 32 student
# steps under guidance 2.0, then DISTILL_STEPS at 16 and w 1 with the EMA
# student as teacher; unet 2 (the SR stage: _lowres_cond_kwargs)
# DISTILL_STEPS at 32; then python -m ...train.distill on the stages' store
# and handoff (the teacher: train_data's checkpoint) at --steps
# DISTILL_ENTRY_STEPS a phase. A step is two teacher forwards (2x batched
# under guidance), one student forward and its backward, so rows 1 and 3
# launch three times a forward's and rows 2 and 4 once a backward's.
DISTILL_STEPS = 3
DISTILL_ENTRY_STEPS = 2
DISTILL_PATH = dict(overrides=TRAIN_PATHS["train"]["overrides"])
# the entry point's scoring, cut as its phases are: N_EVAL 4 held-out clips
# (the scoring's least: the 10-clip store split 6 / 4 by train_ratio 0.6,
# which costs the loader one epoch start more than 0.8; 4 / 6 cost two) at
# EVAL_BATCH 2, each student sampled at its own step count, unguided, so
# every forward is one batch-2 forward of unet 1 on the serve recipe's
# kernels (rows 1, 3, 5)
DISTILL_N_EVAL = 4
DISTILL_EVAL_BATCH = 2
DISTILL_TRAIN_RATIO = 0.6


def score_expected(phases):
    """The scoring's launches: N_EVAL / EVAL_BATCH batches of each phase's
    step count of unet-1 forwards at batch EVAL_BATCH: row 1 once, row 3 at
    every GroupNorm site, row 5 at every cross-attention site."""
    forwards = DISTILL_N_EVAL // DISTILL_EVAL_BATCH * sum(phases)
    gn = sum(gn_rows.calls(gn_rows.FWD, DISTILL_EVAL_BATCH, 1).values())
    xattn = sum(sites for u, _, _, sites in SERVE_SITES if u == 1)
    return {"flash_mqa_fwd": forwards, "groupnorm_film_silu_fwd": gn * forwards,
            "cross_attention_fwd": xattn * forwards}


def distill_expected(u):
    """One distill step of unet u: three forwards and one backward of
    train_expected("train", ...)."""
    fwd = train_expected("train", u, backward=False, recompute=False)
    bwd = train_expected("train", u, backward=True, recompute=False)
    return {k: 3 * fwd.get(k, 0) + (bwd[k] - fwd.get(k, 0)) for k in bwd}


def distill_phase(dev, torch, stages, profile: bool = False):
    """Distill unets 1 and 2 at full width (see above): every loss finite,
    every student parameter moved (the null embeddings, unread at
    cond_scale 1, excepted), the teacher's bit for bit unchanged, the EMA
    d * e + (1 - d) * p exactly after every step, every step's
    launches as distill_expected (the flash backward on the tensor
    cores); then the entry point's four phases with their checkpoints.
    Prints ms per step, samples/s and peak memory per unet."""
    from unittest import mock

    import numpy as np

    from dalle2_video_tpu_torch.engine.decoder import build_decoder
    from dalle2_video_tpu_torch.models.layers import kernel_init_
    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.train import distill
    from dalle2_video_tpu_torch.train.__main__ import SyntheticVideos
    from dalle2_video_tpu_torch.utils.profiling import StepTimer

    card = card_line()
    cfg, knobs = path_config(DISTILL_PATH)
    b = cfg["decoder"]["batch_size"]
    data = SyntheticVideos(b * DISTILL_STEPS, cfg["frame_numbers"][-1], cfg["frame_sizes"][-1],
                           cfg["dim"], cfg["channels"], seed=0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        decoder = build_decoder(cfg, dev)
        for unet in decoder.unets:
            w = unet.to_out.Conv_0.weight
            kernel_init_(w, w[0].numel())
    kernels = all_kernels()
    totals = Counter()
    as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    def run(label, u, dcfg, teacher=None):
        tr = distill.DistillTrainer(decoder, dcfg, seed=0)
        tr.init_state(teacher)
        start = {k: v.detach().clone() for k, v in tr.student.items()}
        teacher0 = {k: v.clone() for k, v in tr.teacher.items()}
        want = {k.name: 0 for k in kernels}
        want.update(distill_expected(u))
        d = dcfg.ema_decay
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for step in range(DISTILL_STEPS):
            batch = data.batch_items(np.arange(step * b, (step + 1) * b))
            vid, emb = as_dev(batch["videos"]), as_dev(batch["video_embeds"])
            ema0 = [v.clone() for v in tr.ema.values()]
            for k in kernels:
                k.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(tr.distill_step(vid, video_embed=emb))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            got = {k.name: k.launches for k in kernels}
            if got != want:
                raise AssertionError(f"distill {label}: launches {got}, the structure predicts "
                                     f"{want} (two teacher forwards, a student forward and "
                                     f"its backward)")
            check_bwd_routes(f"distill {label}", got, need=True)
            totals.update(got)
            if not math.isfinite(loss):
                raise AssertionError(f"distill {label}: step {step} loss {loss}")
            blend = torch._foreach_mul(ema0, d)
            torch._foreach_add_(blend, torch._foreach_mul(
                [v.detach() for v in tr.student.values()], 1.0 - d))
            if not all(torch.equal(a, e) for a, e in zip(blend, tr.ema.values())):
                raise AssertionError(f"distill {label}: the EMA is not d * e + (1 - d) * p")
            log(f"distill {label}: step {step}: loss {loss:.5f}, {ms[-1]:.1f} ms")
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the unguided student never reads the CFG null embeddings: those
        # stay as they were, every other parameter moves
        still = {k for k, v in tr.student.items() if torch.equal(v.detach(), start[k])}
        nulls = {k for k in start if k.startswith("null_")}
        if still != nulls:
            raise AssertionError(f"distill {label}: parameters that never moved "
                                 f"{sorted(still)[:6]}, the null embeddings {sorted(nulls)}")
        if not all(torch.equal(tr.teacher[k], v) for k, v in teacher0.items()):
            raise AssertionError(f"distill {label}: the teacher's parameters changed")
        steady = sum(ms[1:]) / len(ms[1:])
        log(f"distill {label}: ms per step {[round(x, 1) for x in ms]} (first apart), mean "
            f"after the first {steady:.1f} ms, {b / steady * 1e3:.2f} samples/s, peak memory "
            f"{peak:.2f} GiB; launches a step {dict((k, v) for k, v in want.items() if v)}; "
            f"the teacher bit for bit unchanged, every student parameter moved but the null "
            f"embeddings {sorted(nulls)} (unread at cond_scale 1), the EMA exact [{card}]")
        if profile:
            batch = data.batch_items(np.arange(b))
            vid, emb = as_dev(batch["videos"]), as_dev(batch["video_embeds"])
            profile_device(f"distill {label} step", torch,
                           lambda: tr.distill_step(vid, video_embed=emb))
        return tr

    log(f"distill: {' '.join(knobs)}; batch {b} of {tuple(data.videos.shape[1:])} videos, "
        f"sample_compute_dtype {cfg['sample_compute_dtype']}")
    tr = run("unet 1 at 32 steps, w 2", 1,
             distill.DistillConfig(student_steps=32, teacher_cond_scale=2.0))
    ema = {k: v.clone() for k, v in tr.ema.items()}
    del tr
    tr = run("unet 1 at 16 steps, w 1, the EMA student as teacher", 1,
             distill.DistillConfig(student_steps=16, teacher_cond_scale=1.0), ema)
    if not all(torch.equal(tr.teacher[k], v) for k, v in ema.items()):
        raise AssertionError("distill: the second phase's teacher is not the first's EMA")
    del tr, ema
    run("unet 2 (SR) at 32 steps, w 1", 2, distill.DistillConfig(student_steps=32, unet_number=2))
    del decoder
    torch.cuda.empty_cache()

    run_dir = f"{stages.root}/distill"
    for k in kernels:
        k.reset()
    timer = StepTimer()
    timer.start()
    with mock.patch.object(distill, "N_EVAL", DISTILL_N_EVAL), \
            mock.patch.object(distill, "EVAL_BATCH", DISTILL_EVAL_BATCH):
        out = distill.main(stages.args(*DISTILL_PATH["overrides"], "loader=grain",
                                       f"loader_workers={DATA_WORKERS}",
                                       f"train_ratio={DISTILL_TRAIN_RATIO}")
                           + ["--run", run_dir, "--steps", str(DISTILL_ENTRY_STEPS)])
    wall = timer.stop()
    got = {k.name: k.launches for k in kernels}
    n = len(distill.PHASES) * DISTILL_ENTRY_STEPS
    want = {k.name: 0 for k in kernels}
    want.update({k: n * v for k, v in distill_expected(1).items()})
    for k, v in score_expected(distill.PHASES).items():
        want[k] += v
    if got != want:
        raise AssertionError(f"distill entry point: launches {got}, the structure predicts "
                             f"{want} (the phases' steps and the scoring's forwards)")
    check_bwd_routes("distill entry point", got, need=True)
    totals.update(got)
    import os

    missing = [s for s in distill.PHASES
               if not os.path.exists(f"{run_dir}/student_{s}/done")]
    if missing or out["trainer"].step != DISTILL_ENTRY_STEPS:
        raise AssertionError(f"distill entry point: phases {missing} unfinished, last step "
                             f"{out['trainer'].step}")
    losses = {s: out[f"phase{s}_losses"] for s in distill.PHASES}
    if not all(math.isfinite(x) for v in losses.values() for x in v):
        raise AssertionError(f"distill entry point: losses {losses}")
    log(f"distill: python -m dalle2_video_tpu_torch.train.distill on {stages.store} (teacher "
        f"{stages.run_dir}/decoder_default, {DATA_WORKERS} loader workers) at --steps "
        f"{DISTILL_ENTRY_STEPS}: phases {distill.PHASES} and the scoring in {wall:.1f} s, ms "
        f"per step {({s: round(out[f'phase{s}_ms_per_step'], 1) for s in distill.PHASES})}, "
        f"last losses {({s: float(f'{v[-1]:.4g}') for s, v in losses.items()})}; "
        f"student_<n>/state and done written [{card}]")
    anchor = out["fvd_real_vs_real_splithalf"]
    fvds = {s: out[f"fvd_student{s}"] for s in distill.PHASES}
    walls = {s: out[f"sample_s_student{s}"] for s in distill.PHASES}
    floor = -1e-6 * abs(anchor)
    if not all(math.isfinite(v) and v >= floor for v in (anchor, *fvds.values(), *walls.values())):
        raise AssertionError(f"distill scoring: anchor {anchor}, FVDs {fvds}, walls {walls}: "
                             f"not all finite and >= {floor}")
    log(f"distill scoring (a random teacher's students under a random extractor: these numbers "
        f"show that the harness runs, not a quality): {DISTILL_N_EVAL} held-out clips at "
        f"batch {DISTILL_EVAL_BATCH}, extractor {out['extractor']!r}; anchor (real vs real, "
        f"split half) {anchor!r}; FVD per student {fvds}; sampling wall s per student {walls}; "
        f"launches of the scoring {score_expected(distill.PHASES)} [{card}]")
    del out
    torch.cuda.empty_cache()
    return {k.name: totals[k.name] for k in kernels}


# "serve_student": the serve recipe (flash cross-attention) with
# serve_distill pointing at the entry point's 4-step student: stage 1 the
# EMA student at 4 DDIM steps, stage 2 (the decoder checkpoint's) at
# OPTION_STEPS; one request at cond_scale 1, so every forward is one
# unguided batch-1 forward: rows 1, 3 and 5 at batch 1 (held there in
# phase 2: check_student_kernels).
STUDENT_STEPS = 4


def student_launches():
    """One serve_student request's launches: per forward row 1 once, row 3
    at every GroupNorm site (54 / 66), row 5 at every cross-attention site;
    STUDENT_STEPS forwards of unet 1, OPTION_STEPS of unet 2."""
    steps = {1: STUDENT_STEPS, 2: OPTION_STEPS}
    xattn = sum(steps[u] * sites for u, _, _, sites in SERVE_SITES)
    gn = sum(n * sum(gn_rows.calls(gn_rows.FWD, STUDENT_BATCH, u).values())
             for u, n in steps.items())
    return {"flash_mqa_fwd": sum(steps.values()), "groupnorm_film_silu_fwd": gn,
            "cross_attention_fwd": xattn}


def serve_student(dev, torch, stages):
    """build_generate_batch with serve_distill {ckpt: the entry point's
    student_4/state, steps 4, unet 1}: slot 1 the checkpoint's EMA student
    bit for bit, slot 2 the decoder checkpoint's EMA shadow, the grid
    pinned to (4, OPTION_STEPS); one request at cond_scale 1 through the
    engine: a finite (90, 128, 128, 3) video in [0, 1], launches and
    kernel shapes as the structure predicts. Prints wall, frames/s and
    peak memory."""
    import logging
    from unittest import mock

    import numpy as np

    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.serve import stack
    from dalle2_video_tpu_torch.serve.engine import GenerationEngine, GenRequest
    from dalle2_video_tpu_torch.train import load_best, load_checkpoint
    from dalle2_video_tpu_torch.utils.config import load_config

    card = card_line()
    ckpt = f"{stages.root}/distill/student_{STUDENT_STEPS}/state"
    cfg = load_config(None, [*SERVE_PATHS["serve"]["overrides"], f"run_dir={stages.run_dir}",
                             f"sample_timesteps=[{OPTION_STEPS},{OPTION_STEPS}]"])
    cfg.update(sample_seed=0, serve_distill={"ckpt": ckpt, "steps": STUDENT_STEPS, "unet": 1})
    made = {}
    build = stack.build_stack

    def keep(cfg_, device, **kw):
        made["stack"] = build(cfg_, device, **kw)
        return made["stack"]

    t0 = time.time()
    with mock.patch.object(stack, "build_stack", keep):
        gb = stack.build_generate_batch(cfg, logging.getLogger("chip_smoke"), dev)
    t_build = time.time() - t0
    dec = made["stack"][1].decoder
    if dec.sample_timesteps != (STUDENT_STEPS, OPTION_STEPS):
        raise AssertionError(f"serve_student: sample_timesteps {dec.sample_timesteps}")
    student = load_checkpoint(ckpt, map_location=dev)["ema"]
    if not all(torch.equal(p, student[k]) for k, p in dec.unets[0].named_parameters()):
        raise AssertionError("serve_student: slot 1 is not the student's EMA")
    ema2 = load_best(f"{stages.run_dir}/decoder_default", map_location=dev)["ema"][1]["params"]
    if not all(torch.equal(p, ema2[k]) for k, p in dec.unets[1].named_parameters()):
        raise AssertionError("serve_student: slot 2 is not the decoder checkpoint's EMA shadow")
    log(f"serve_student: stack built in {t_build:.1f} s: slot 1 {ckpt}'s EMA student, slot 2 "
        f"the decoder checkpoint's EMA shadow, bit for bit; sample_timesteps "
        f"{dec.sample_timesteps}")
    del student, ema2
    engine = GenerationEngine(gb, buckets=(1,), max_wait_ms=5.0, default_cond_scale=1.0,
                              default_ddim_steps=None)
    kernels = all_kernels()
    totals = Counter()
    try:
        walls = []
        for seed in (7, 8):  # the second warm: the first pays the stack's first calls
            for k in kernels:
                k.reset()
            torch.cuda.reset_peak_memory_stats()
            with ShapeRecord() as shapes:
                t0 = time.time()
                res = engine.generate(GenRequest("a person smiling", seed=seed, cond_scale=1.0,
                                                 ddim_steps=None), timeout=600)
                walls.append(time.time() - t0)
            launches = {k.name: k.launches for k in kernels}
            totals.update(launches)
            want = student_launches()
            if {k: v for k, v in launches.items() if v} != want:
                raise AssertionError(f"serve_student: launches {launches}, the structure "
                                     f"predicts {want}")
            steps = {1: STUDENT_STEPS, 2: OPTION_STEPS}
            xattn = Counter()
            for u, n, m, sites in SERVE_SITES:
                xattn[(STUDENT_BATCH, n, 8, 64, m)] += sites * steps[u]
            gn = Counter()
            for u, n in steps.items():
                gn.update({(gn_rows.FWD, *key): c * n
                           for key, c in gn_rows.calls(gn_rows.FWD, STUDENT_BATCH, u).items()})
            shapes.check("serve_student", conv_path_shapes("serve_student"), xattn, gn)
            vid = res["video"]
            frames, size = cfg["frame_numbers"][-1], cfg["frame_sizes"][-1]
            if vid.shape != (frames, size, size, 3) or not (
                    np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
                raise AssertionError(f"serve_student: video {vid.shape} not finite in [0, 1]")
            log(f"serve_student: request (seed {seed}) at cond_scale 1, DDIM {STUDENT_STEPS} + "
                f"{OPTION_STEPS}: wall {walls[-1]:.3f} s, {frames / walls[-1]:.2f} frames/s, "
                f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; mean "
                f"{float(vid.mean()):.3f} std {float(vid.std()):.3f}; launches rows 1 / 3 / 5 "
                f"{launches['flash_mqa_fwd']} / {launches['groupnorm_film_silu_fwd']} / "
                f"{launches['cross_attention_fwd']} [{card}]")
    finally:
        engine.close()
    del gb, made, engine, dec
    torch.cuda.empty_cache()
    return {k.name: totals[k.name] for k in kernels}


# "train_vqgan": python -m ...train.train_vqgan on the stages' 10-clip store
# at the vqgan section's full widths (VQVAE base 64, f 4, latent 4, 512
# codes; discriminator base 64, 3 layers) and batch 8: 8 train clips, one
# batch an epoch, each sized on the card to the recipe's 4 x 64 x 64.
# Reduced: disc_start 1000 -> 2 (the gate opens at the run's third step),
# epochs 10 -> 3, then resume=true to 5. No kernel lies on it: the VAE's and
# the discriminator's convs run through cuDNN, as the JAX package runs them
# outside any Pallas kernel.
VQGAN_ARGS = ["vqgan.disc_start=2", "vqgan.batch_size=8"]
VQGAN_EPOCHS = (3, 5)
VQGAN_REDUCED = ["disc_start 1000 -> 2", "epochs 10 -> 3 (+ 2 on resume)"]


def check_vq_and_disc(dev, torch, trainer, video):
    """One PatchDiscriminator forward and one VectorQuantizer forward on the
    card against a CPU copy on the same inputs (the phase's batch): the
    logits f32 within 1e-4 of their scale (cuDNN and the CPU sum in other
    orders); the codes equal but where the two nearest codes lie within
    1e-4 (relative) of each other, the quantised latents equal where the
    codes are."""
    import copy

    disc_cpu = copy.deepcopy(trainer.disc).cpu()
    vq_cpu = copy.deepcopy(trainer.vae.vq).cpu()
    with torch.no_grad():
        got = trainer.disc(video)
        want = disc_cpu(video.cpu())
        e, _ = check("PatchDiscriminator", f"logits {tuple(got.shape)}", got.cpu(), want,
                     atol=1e-4 * float(want.abs().max()), rtol=0.0)
        z = trainer.vae.encoder(video)
        q, idx, loss = trainer.vae.vq(z)
        q_c, idx_c, loss_c = vq_cpu(z.cpu())
    differ = idx.cpu() != idx_c
    if bool(differ.any()):
        flat = z.cpu().double().reshape(-1, z.shape[-1])[differ.reshape(-1)]
        cb = vq_cpu.codebook.double()
        d = (flat[:, None, :] - cb[None]).pow(2).sum(-1)
        top2 = d.topk(2, largest=False).values
        gap = (top2[:, 1] - top2[:, 0]) / top2[:, 0].clamp_min(1e-30)
        if float(gap.max()) > 1e-4:
            raise AssertionError(f"VectorQuantizer: {int(differ.sum())} codes differ from the "
                                 f"CPU's, not all near ties (gap {float(gap.max()):.2e})")
    same = ~differ
    if not torch.equal(q.cpu()[same], q_c[same]):
        raise AssertionError("VectorQuantizer: quantised latents differ where the codes agree")
    log(f"train_vqgan: PatchDiscriminator on {tuple(video.shape)} max |card - CPU| {e:.3e}; "
        f"VectorQuantizer on z {tuple(z.shape)}: {int(differ.sum())} of {differ.numel()} codes "
        f"differ (near ties), loss card {float(loss):.6f} CPU {float(loss_c):.6f}")


def train_vqgan_phase(dev, torch, stages):
    """The VQGAN stage through its entry point on the stages' store
    (VQGAN_ARGS, VQGAN_EPOCHS): finite metrics, the gate open in the last
    epoch (lambda > 0, a D loss), a checkpoint at step 3 that resume=true
    carries on to step 5 (both Adam counts 5), the VAE moved; then
    check_vq_and_disc at the phase's batch. Prints walls, ms per step and
    peak memory. No kernel launches."""
    import numpy as np

    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.ops.video import resize_video, resize_video_time
    from dalle2_video_tpu_torch.train import load_latest, train_vqgan

    card = card_line()
    kernels = all_kernels()
    for k in kernels:
        k.reset()
    run = f"{stages.run_dir}/vqgan_default"
    with ShapeRecord() as shapes:
        walls = []
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        first = train_vqgan.main(stages.args(*VQGAN_ARGS, f"vqgan.epochs={VQGAN_EPOCHS[0]}"))
        walls.append(time.time() - t)
        tr = first["trainer"]
        if tr.step != VQGAN_EPOCHS[0] or load_latest(run)["step"] != tr.step:
            raise AssertionError(f"train_vqgan: step {tr.step}, checkpoint "
                                 f"{load_latest(run)['step']}")
        if not (first["train"]["lambda_adapt"] > 0 and first["train"]["loss/d"] > 0
                and all(math.isfinite(v) for v in first["train"].values())):
            raise AssertionError(f"train_vqgan: last epoch's metrics {first['train']}")
        vae0 = {k: v.clone() for k, v in tr.vae.state_dict().items()}
        t = time.time()
        second = train_vqgan.main(stages.args(*VQGAN_ARGS, f"vqgan.epochs={VQGAN_EPOCHS[1]}",
                                              "resume=true"))
        walls.append(time.time() - t)
        tr2 = second["trainer"]
        counts = {int(opt.state[next(iter(m.parameters()))]["step"])
                  for opt, m in ((tr2.opt_g, tr2.vae), (tr2.opt_d, tr2.disc))}
        if tr2.step != VQGAN_EPOCHS[1] or counts != {VQGAN_EPOCHS[1]}:
            raise AssertionError(f"train_vqgan: resumed to step {tr2.step}, Adam counts {counts}")
        if all(torch.equal(v, vae0[k]) for k, v in tr2.vae.state_dict().items()):
            raise AssertionError("train_vqgan: the VAE did not move on resume")
        steps = (tr.step, tr2.step)
        peak = torch.cuda.max_memory_allocated() / 2**30
        vq = load_config_vqgan()
        clips = torch.as_tensor(np.stack(stages.clips[:vq["batch_size"]]), device=dev)
        video = resize_video_time(resize_video(clips, vq["frame_size"]), vq["frames"])
        ms, _ = timed_steps(torch, lambda: tr2.train_step(video), 3)  # past the run: timing only
        check_vq_and_disc(dev, torch, tr2, video)
        log(f"train_vqgan: VQVAE base {vq['base_dim']}, {vq['num_down']} downs, latent "
            f"{vq['latent_dim']}, {vq['codebook_size']} codes; discriminator base "
            f"{vq['disc_base_dim']}, {vq['disc_layers']} layers; batch {tuple(video.shape)}; "
            f"reduced: {VQGAN_REDUCED}; entry point walls {[round(w, 2) for w in walls]} s "
            f"(steps {steps[0]} then {steps[1]}); last epoch lambda "
            f"{second['train']['lambda_adapt']:.4f} loss/rec {second['train']['loss/rec']:.4f} "
            f"loss/d {second['train']['loss/d']:.4f}; ms per step {[round(x, 2) for x in ms]}; "
            f"peak memory {peak:.2f} GiB [{card}]")
        del first, second, tr, tr2, video, clips
        torch.cuda.empty_cache()
    shapes.check("train_vqgan", conv_path_shapes("train_vqgan"))
    return no_launches(kernels, "train_vqgan")


def load_config_vqgan():
    from dalle2_video_tpu_torch.utils.config import load_config

    return dict(load_config(None, VQGAN_ARGS)["vqgan"])


# "latent": the VQVAE restored from train_vqgan's checkpoint as the frozen
# stage-1 VAE of scripts/train_latent90.py's decoder (90 frames at 128 px,
# 90 x 32 x 32 x 4 latents; unet dim 64, mults (1, 2, 4), 2 blocks, 8 x 32
# heads, video embed 512; predict_x_start_for_latent_diffusion) at
# celebv_text's kernel settings (attention_impl auto: flash at the 5,760
# joint tokens; groupnorm_impl pallas; cross_attention_impl xla to train,
# flash to sample): LATENT_STEPS bf16 train steps at batch 2, then one DDIM
# request at CFG 2 and LATENT_DDIM steps and one inpainting request (the
# first LATENT_KNOWN frames known) on a sampling decoder that loads the
# trainer's sampling params (the VAE rides in them). Reduced: 400 steps ->
# 4, DDIM 64 -> 10.
LATENT_STEPS = 4
LATENT_DDIM = 10
LATENT_KNOWN = 30
LATENT_BATCH = 2


def latent_launches(train_steps, ddim_steps):
    """Rows 1-5's launches: per unet forward row 1 once and row 3 at every
    GroupNorm site, per backward rows 2 and 4 likewise; per sampling step
    also row 5 at every cross-attention site (the trainer's unet takes the
    plain one)."""
    gn_sites, xa_sites = gn_rows.latent_sites()
    g, x = sum(gn_sites.values()), sum(xa_sites.values())
    fwd = train_steps + ddim_steps
    return {"flash_mqa_fwd": fwd, "flash_mqa_bwd": train_steps,
            "groupnorm_film_silu_fwd": g * fwd, "groupnorm_film_silu_bwd": g * train_steps,
            "cross_attention_fwd": x * ddim_steps}


def latent_phase(dev, torch, stages):
    """The latent stage on the card (see LATENT_STEPS): finite losses, the
    unet moved and the VAE bit for bit unchanged; the sampling decoder's VAE
    equal to the trainer's; a request decoded to a finite (90, 128, 128, 3)
    video equal to the VAE's decode of the sampled latents; the inpainting
    request's latents equal to the known video's encoding wherever the
    min-pooled mask is 1; every kernel launch counted exactly
    (latent_launches) and every GroupNorm / cross-attention shape the map's
    (gn_rows.latent_sites). Prints walls, peak memory and launches by row."""
    from unittest import mock

    from dalle2_video_tpu_torch.engine.decoder import latent90_decoder
    from dalle2_video_tpu_torch.models.layers import kernel_init_
    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.train import DecoderTrainer, DecoderTrainerConfig, train_vqgan
    from dalle2_video_tpu_torch.utils.keys import RowKeys

    card = card_line()
    vae = train_vqgan.load_vqvae(f"{stages.run_dir}/vqgan_default", load_config_vqgan(), dev)
    knobs = dict(attention_impl="auto", groupnorm_impl="pallas")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        dec = latent90_decoder(vae, dev, cross_attention_impl="xla", **knobs)
    w = dec.unets[0].to_out.Conv_0.weight
    kernel_init_(w, w[0].numel())
    trainer = DecoderTrainer(dec, DecoderTrainerConfig(lr=3e-4, use_ema=True, bf16_compute=True))
    frames, size = dec.config.frame_numbers[0], dec.config.frame_sizes[0]
    g = torch.Generator(device=dev).manual_seed(0)
    videos = torch.rand(LATENT_BATCH, frames, size, size, 3, generator=g, device=dev)
    embeds = torch.randn(LATENT_BATCH, dec.unet_configs[0].video_embed_dim, generator=g,
                         device=dev)
    vae_before = {k: v.clone() for k, v in vae.state_dict().items()}
    unet_before = {k: p.detach().clone() for k, p in dec.unets[0].named_parameters()}
    kernels = all_kernels()
    for k in kernels:
        k.reset()
    gn_sites, xa_sites = gn_rows.latent_sites()
    with ShapeRecord() as shapes:
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        ms, losses = timed_steps(torch, lambda: float(trainer.train_step(
            videos, video_embed=embeds)), LATENT_STEPS)
        t_train, peak_train = time.time() - t, torch.cuda.max_memory_allocated() / 2**30
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"latent: losses {losses}")
        moved(torch, unet_before, dec.unets[0], "latent")
        if not all(torch.equal(v, vae_before[k]) for k, v in vae.state_dict().items()):
            raise AssertionError("latent: the frozen VAE changed in training")
        train_launches = {k.name: k.launches for k in kernels if k.launches}

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            sdec = latent90_decoder(train_vqgan.build_vqvae(load_config_vqgan(), dev), dev,
                                    cross_attention_impl="flash", **knobs)
        sdec.load_sampling_params(trainer.sampling_params())
        if not all(torch.equal(v, vae_before[k]) for k, v in sdec.vaes[0].state_dict().items()):
            raise AssertionError("latent: the sampling decoder's VAE is not the trainer's")
        seen = {}
        loop = sdec.p_sample_loop_ddim

        def spy(*a, **kw):
            seen["latents"] = loop(*a, **kw)
            seen["inpaint"] = kw.get("inpaint")
            return seen["latents"]

        walls, outs = [], []
        mask = torch.zeros(1, frames, 1, 1, 1, device=dev)
        mask[:, :LATENT_KNOWN] = 1.0
        requests = [dict(), dict(inpaint_video=videos[:1], inpaint_mask=mask)]
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(sdec, "p_sample_loop_ddim", spy):
            for seed, extra in enumerate(requests):
                torch.cuda.synchronize()
                t0 = time.time()
                vid = sdec.sample(RowKeys.from_request_seeds([seed]), video_embed=embeds[:1],
                                  cond_scale=2.0, sample_timesteps=LATENT_DDIM, **extra)
                torch.cuda.synchronize()
                walls.append(time.time() - t0)
                if vid.shape != (1, frames, size, size, 3) or not bool(torch.isfinite(vid).all()):
                    raise AssertionError(f"latent: video {tuple(vid.shape)} not finite")
                with torch.no_grad():
                    if not torch.equal(vid, sdec.vaes[0].decode(seen["latents"])):
                        raise AssertionError("latent: the video is not the VAE's decode")
                outs.append((float(vid.min()), float(vid.max())))
        peak_sample = torch.cuda.max_memory_allocated() / 2**30
        inp = seen["inpaint"]
        known = inp.mask.expand_as(seen["latents"]) > 0
        if (tuple(inp.mask.shape[2:4]) != (gn_rows.LATENT_GRID,) * 2
                or not torch.equal(seen["latents"][known], inp.x0k.expand_as(
                    seen["latents"])[known])):
            raise AssertionError("latent: the inpainted latents are not the known encoding")
    launches = {k.name: k.launches for k in kernels if k.launches}
    want = latent_launches(LATENT_STEPS, LATENT_DDIM * len(requests))
    if launches != want:
        raise AssertionError(f"latent: launches {launches}, the structure predicts {want}")
    check_bwd_routes("latent", launches, need=True)
    gn_want = Counter()
    for name, n in ((gn_rows.FWD, LATENT_STEPS), (gn_rows.BWD, LATENT_STEPS)):
        gn_want.update({(name, LATENT_BATCH, *key): c * n for key, c in gn_sites.items()})
    gn_want.update({(gn_rows.FWD, gn_rows.LATENT_SERVE_BATCH, *key): c * LATENT_DDIM
                    * len(requests) for key, c in gn_sites.items()})
    xa_want = Counter({(gn_rows.LATENT_SERVE_BATCH, *key): c * LATENT_DDIM * len(requests)
                       for key, c in xa_sites.items()})
    shapes.check("latent", conv_path_shapes("latent"), xa_want, gn_want)
    log(f"latent: {frames} frames at {size} px -> latents {tuple(seen['latents'].shape)}; "
        f"{LATENT_STEPS} bf16 train steps at batch {LATENT_BATCH}: ms per step "
        f"{[round(x, 1) for x in ms]}, {t_train:.2f} s, losses {[round(x, 4) for x in losses]}, "
        f"peak {peak_train:.2f} GiB, launches {train_launches}; requests (DDIM {LATENT_DDIM}, "
        f"CFG 2; then inpainting {LATENT_KNOWN} of {frames} frames): walls "
        f"{[round(x, 3) for x in walls]} s, video ranges {outs}, peak {peak_sample:.2f} GiB; "
        f"launches by row {launches} [{card}]")
    del trainer, dec, sdec, vae, videos
    torch.cuda.empty_cache()
    return {k.name: launches.get(k.name, 0) for k in kernels}


# --------------------------------------------------------------- phase 5i'
# "parallel": the data and model axes (dalle2_video_tpu_torch/parallel/) on
# the one card. PAR_RANKS ranks share it over gloo (NCCL refuses two ranks
# on one GPU; this torch's gloo carries all-reduce, all-gather and
# broadcast for CUDA tensors, staged through the host), each started as
# `chip_smoke.py --parallel-rank DIR` after the kernels are built (they
# load the built libraries):
#   train_dp: the train path's unet 1 (the 90-frame recipe at full width,
#     bf16, attention_impl auto, cross_attention_impl xla) at mesh {data 2,
#     model 1}, global batch 2 (one row a rank), the sharded step's reduced
#     gradient once, then PAR_DP_STEPS steps (ZeRO-1 moments);
#   train_sp: the same unet at mesh {data 1, model 2} with attention_impl
#     sp, batch 2, the gradient once, then PAR_SP_STEPS steps: rows 1 and 2
#     at one rank's query shard q (2, 46080, 32) against kv (2, 5761, 32);
#   serve_dp: a group of 2 requests of the serve recipe at OPTION_STEPS
#     DDIM steps split over the ranks (serve/stack.py::DataParallelGenerate:
#     rank 0 the engine's callable, rank 1 in serve_worker). Each rank
#     samples its request as a one-request group at CFG batch 2, so each row
#     must equal, bit for bit, that request served alone by one process; the
#     one process's group of 2 (CFG batch 4: other kernel shapes, whose bf16
#     roundings flip saturated pixels) is logged beside it.
# This process computes the one-process references meanwhile (the same
# unet, batch 2, the same draws; the serve stack's group of 2), and runs the
# decoder's entry point under torchrun --nproc_per_node=1 with NCCL
# (smoke=true, mesh.data=-1: one batch through both unets). The walls of
# the shared-card runs time gloo's host-staged collectives on one card, not
# multi-GPU training.
PAR_RANKS = 2
PAR_DP_STEPS = 3
PAR_SP_STEPS = 2
# a rank's query shard at unet 1's 5,760-token mid attention, 16 heads,
# against the gathered kv and the null kv
PAR_SP_SHAPES = [[[2, 90 * 8 * 8 // PAR_RANKS * 16, 32], [2, 90 * 8 * 8 + 1, 32]]]
# bf16, two batchings (one row a rank against two in one process): the
# holds of the losses, the gradient's and the parameters' worst per-tensor
# relative L2 after the steps, each a few times the worst of train_dp's and
# train_sp's readings on an H100 (3.0e-5, 3.9e-3 and 7.1e-2: a bias that
# starts at zero, whose Adam steps flip sign where its gradient is near
# zero). A block of a ZeRO-1 leaf gathered into another rank's slice puts
# unrelated values there (for two independent blocks of one norm, sqrt(2)
# relative L2).
PAR_LOSS_RTOL = 3e-4
PAR_GRAD_RTOL = 2e-2
PAR_PARAM_RTOL = 0.25


def par_config(impl: str):
    return path_config(dict(overrides=[*TRAIN_PATHS["train"]["overrides"],
                                       f"unet1.attention_impl={impl}"]))[0]


def par_trainer(torch, impl: str, unet1_state, dev, decoder=None):
    """The train path's trainer (on ``decoder`` when given: its joint
    attention set to ``impl``) with unet 1 at ``unet1_state`` and its EMA
    shadow restarted from it."""
    from dalle2_video_tpu_torch.engine.decoder import build_decoder
    from dalle2_video_tpu_torch.models.layers import JointSpaceTimeAttention
    from dalle2_video_tpu_torch.train.__main__ import build_trainer

    cfg = par_config(impl)
    decoder = build_decoder(cfg, dev) if decoder is None else decoder
    for m in decoder.unets[0].modules():
        if isinstance(m, JointSpaceTimeAttention):
            m.impl = impl
    decoder.unets[0].load_state_dict(unet1_state)
    return build_trainer(cfg, decoder)


def par_rank(rank_dir: str) -> int:
    """One rank of the shared-card runs (RANK / WORLD_SIZE / MASTER_* set by
    the parent): every run's loss, launches, walls and moment bytes to
    rank<r>.json; rank 0's gradients, its unet-1 parameters after the steps
    and its videos to .pt files."""
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from dalle2_video_tpu_torch.ops import flash_mqa as fm
    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.parallel.collectives import all_gather_cat
    from dalle2_video_tpu_torch.parallel.mesh import (
        active_mesh,
        create_mesh,
        maybe_init_distributed,
        shard_batch,
    )
    from dalle2_video_tpu_torch.parallel.sharded import (
        all_reduce_mean,
        make_sharded_train_step,
        reduce_gradients,
        shard_draws,
        shard_state,
    )
    from dalle2_video_tpu_torch.serve.stack import DataParallelGenerate, serve_worker
    from dalle2_video_tpu_torch.utils.device import resolve_device

    root = Path(rank_dir)
    dev = resolve_device("cuda:0")  # every rank on the one card
    maybe_init_distributed(True, device=dev, backend="gloo")
    rank = dist.get_rank()
    inp = torch.load(root / "inputs.pt", weights_only=False)
    kernels = all_kernels()
    out = {"launches": {}, "routes": {}, "walls": {}, "flash_shapes": {}}
    shapes = []
    real_fwd = fm.flash_mqa_fwd

    def recording_fwd(q, k, v, **kw):
        shapes.append((tuple(q.shape), tuple(k.shape)))
        return real_fwd(q, k, v, **kw)

    fm.flash_mqa_fwd = recording_fwd

    def run(name, fn):
        for k in kernels:
            k.reset()
        shapes.clear()
        torch.cuda.synchronize()
        t = time.time()
        res = fn()
        torch.cuda.synchronize()
        out["walls"][name] = time.time() - t
        out["launches"][name] = {k.name: k.launches for k in kernels}
        out["routes"][name] = dict(fm.BWD_KERNEL.routes)
        out["flash_shapes"][name] = sorted(set(shapes))
        return res

    video, embed = inp["video"], inp["embed"]
    decoder = None
    for name, impl, shape, steps in (("train_dp", "auto", (2, 1), PAR_DP_STEPS),
                                     ("train_sp", "sp", (1, 2), PAR_SP_STEPS)):
        mesh = create_mesh(*shape, device=dev, backend="gloo")
        trainer = shard_state(par_trainer(torch, impl, inp["unet1"], dev, decoder), mesh)
        decoder = trainer.decoder
        params = list(trainer.decoder.unets[0].parameters())
        vid, emb = shard_batch(mesh, (video, embed))

        def grads():
            with active_mesh(mesh):
                loss = trainer.backward(vid, video_embed=emb, unet_number=1,
                                        draws=shard_draws(inp["draws"][0], mesh))
                loss = all_reduce_mean(loss, mesh.data_group)
                reduce_gradients(params, mesh.data_group)
            return float(loss)

        step = make_sharded_train_step(trainer, mesh, 1)
        out[name] = {"grad_loss": run(f"{name} gradient", grads)}
        if rank == 0:
            torch.save({k: p.grad.float().cpu() for k, p in
                        trainer.decoder.unets[0].named_parameters()}, root / f"{name}_grads.pt")
        trainer.optimizers[0].zero_grad()
        out[name]["losses"] = run(name, lambda: [
            float(step(vid, emb, draws=inp["draws"][j])) for j in range(steps)])
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        every = all_gather_cat(flat, mesh.world_group, 0).view(mesh.world, -1)
        out[name]["ranks_equal"] = all(torch.equal(every[0], every[r])
                                       for r in range(1, mesh.world))
        if rank == 0:
            torch.save({k: p.detach().float().cpu() for k, p in
                        trainer.decoder.unets[0].named_parameters()}, root / f"{name}_params.pt")
        out[name]["moment_bytes"] = trainer.optimizers[0].moment_bytes()
        out[name]["moment_bytes_whole"] = sum(8 * p.numel() for p in params)
        del trainer, params, flat, every
        torch.cuda.empty_cache()
    del decoder

    mesh = create_mesh(PAR_RANKS, 1, device=dev, backend="gloo")
    cfg, _ = path_config(SERVE_PATHS["serve"])
    cfg["sample_seed"], cfg["run_dir"] = 0, str(root / "no_checkpoints")
    generate_batch, _ = option_stack(cfg, dev, torch)
    dp = DataParallelGenerate(generate_batch, mesh)
    if rank == 0:
        videos = run("serve_dp", lambda: dp(*inp["requests"], cond_scale=3.0,
                                            ddim_steps=OPTION_STEPS))
        dp.stop()
        torch.save(videos, root / "serve_dp_videos.pt")
    else:
        out["served"] = run("serve_dp", lambda: serve_worker(dp))
    del dp, generate_batch
    torch.cuda.empty_cache()
    from dalle2_video_tpu_torch.parallel.collectives import all_gather_list

    for kind in PRIOR_PAR:
        mesh = create_mesh(1, PAR_RANKS, device=dev, backend="gloo")
        res = prior_par_run(torch, dev, kind, mesh, run)
        every = all_gather_list(res.pop("replicated"), mesh.model_group)
        out[kind] = {"losses": res["losses"], "grad_loss": res["grad_loss"],
                     "bytes": list(res["bytes"]),
                     "replicated_equal": all(torch.equal(every[0], e) for e in every[1:])}
        if rank == 0:
            torch.save({k: res[k] for k in ("grads", "params", "sample") if k in res},
                       root / f"{kind}.pt")
    dist.destroy_process_group()
    (root / f"rank{rank}.json").write_text(json.dumps(out))
    return 0


def par_expected(path: str) -> dict:
    """One rank's launches on each run: rows 1-4 per unet-1 forward and
    backward as train_expected (one flash forward launch at the global
    batch's route, one backward on the tensor cores), serve's per DDIM step
    of a one-request group."""
    if path == "serve_dp":
        return {k: OPTION_STEPS * n for k, n in SERVE_PATHS["serve"]["per_step"].items()}
    steps = {"train_dp": PAR_DP_STEPS, "train_sp": PAR_SP_STEPS}[path.split()[0]]
    n = 1 if path.endswith("gradient") else steps
    recompute = par_config("auto")["unet1"].get("checkpoint_during_training", False)
    return {k: n * v for k, v in train_expected("train", 1, True, recompute).items()}


def par_rel_l2(torch, got, want, start=None):
    """The worst per-tensor relative L2 distance of two tensor dicts (of
    their changes from ``start`` when given)."""
    worst, name = 0.0, ""
    for k, w in want.items():
        g = got[k]
        if start is not None:
            g, w = g - start[k].float(), w - start[k].float()
        if float(w.norm()) == 0:
            continue
        err = float((g - w).norm() / w.norm())
        if err > worst:
            worst, name = err, k
    return worst, name


# The prior's model axis on the shared card (the same 2 ranks over gloo):
#   prior_pp: the recipe's prior (dim 512, depth 6, 8 x 64 heads) in the
#     stacked layout, pipelined over 2 stages at PRIOR_PP_MICROBATCHES
#     microbatches (configs/celebv_text.yaml's commented settings), each
#     rank holding 3 of the 6 layers;
#   prior_ep: the same prior with prior.ff_experts 8 at expert_parallel 2,
#     each rank holding 4 of the 8 experts of every layer.
# Each takes the loss's gradient once (draws from its own stream), then
# PRIOR_PAR_STEPS Adam steps at prior.batch_size 256 on seeded device
# embeddings, every rank on the whole batch with the same draws; prior_pp
# then samples PRIOR_PP_SAMPLE rows at cond_scale 2 (the CFG-doubled batch
# through the pipeline) over the recipe's 64 DDIM steps. Each is held to
# the same network in one process (the pipeline's local loop, the experts
# whole): losses (PRIOR_PAR_LOSS_RTOL), the gradient and the parameters
# after the steps per tensor by relative L2 (PRIOR_PAR_GRAD_RTOL,
# PRIOR_PAR_PARAM_RTOL), the sample by relative L2 (PRIOR_PAR_SAMPLE_RTOL);
# the replicated parameters must be bit for bit equal on the two ranks, and
# each rank's parameter and moment bytes are logged beside the whole's. No
# kernel lies on the prior: each run must launch none.
PRIOR_PAR = {"prior_pp": dict(scan_layers=True, pipeline_microbatches=4),
             "prior_ep": dict(ff_experts=8)}
PRIOR_PP_MICROBATCHES = 4
PRIOR_PAR_STEPS = 3
PRIOR_PP_SAMPLE = 8
# f32, holds set before the first reading on the card: the pipeline and the
# experts change only the order of sums (microbatched matmuls, the psum
# over the model axis)
PRIOR_PAR_LOSS_RTOL = 1e-5
PRIOR_PAR_GRAD_RTOL = 1e-4
PRIOR_PAR_PARAM_RTOL = 1e-4
PRIOR_PAR_SAMPLE_RTOL = 1e-4


def prior_par_trainer(torch, dev, kind: str, mesh=None):
    """The recipe's prior with ``kind``'s options (placed on ``mesh`` when
    given: a rank's stage or experts), its trainer (the entry point's init
    and draw streams), seeded (batch_size, dim) embeddings and a third
    stream for the gradient check's draws."""
    from dalle2_video_tpu_torch.models.prior import (
        DiffusionPrior,
        DiffusionPriorConfig,
        PriorNetworkConfig,
    )
    from dalle2_video_tpu_torch.train.train_prior import PriorTrainer
    from dalle2_video_tpu_torch.utils.config import load_config
    from dalle2_video_tpu_torch.utils.keys import derive_generator, init_from

    cfg = load_config(None)
    pc = cfg["prior"]
    pcfg = DiffusionPriorConfig(
        network=PriorNetworkConfig(dim=cfg["dim"], depth=pc["depth"], heads=pc["heads"],
                                   dim_head=pc["dim_head"], **PRIOR_PAR[kind]),
        timesteps=pc["timesteps"], sample_timesteps=pc["sample_timesteps"])
    with init_from(derive_generator(cfg["seed"], 4, 0)):
        prior = DiffusionPrior(pcfg, dev, mesh=mesh)
    trainer = PriorTrainer(prior, float(pc["lr"]),
                           generator=derive_generator(cfg["seed"], 4, 1, device=dev))
    g = torch.Generator(device=dev).manual_seed(2)
    ve, te = (torch.randn(pc["batch_size"], cfg["dim"], generator=g, device=dev)
              for _ in range(2))
    return trainer, ve, te, derive_generator(cfg["seed"], 4, 2, device=dev)


def prior_par_run(torch, dev, kind: str, mesh=None, timed=lambda name, fn: fn()):
    """``kind``'s gradient once, then PRIOR_PAR_STEPS steps (and for prior_pp
    a sample): losses, the whole gradient and parameters on the host
    (gathered from every rank's blocks: collective), each rank's bytes, the
    replicated parameters' flat vector."""
    from dalle2_video_tpu_torch.parallel.mesh import active_mesh
    from dalle2_video_tpu_torch.utils.keys import RowKeys

    trainer, ve, te, grad_draws = prior_par_trainer(torch, dev, kind, mesh)
    prior, net = trainer.prior, trainer.prior.network
    out = {}

    def grad():
        net.train()
        with active_mesh(mesh):
            loss = prior.loss(ve, te, generator=grad_draws)
            loss.backward()
        return float(loss.detach())

    out["grad_loss"] = timed(f"{kind} gradient", grad)
    out["grads"] = {k: trainer.whole(k, p.grad).float().cpu() for k, p in
                    net.named_parameters() if p.grad is not None}
    trainer.optimizer.zero_grad(set_to_none=True)
    out["losses"] = timed(kind, lambda: [float(trainer.train_step(ve, te))
                                         for _ in range(PRIOR_PAR_STEPS)])
    out["params"] = {k: trainer.whole(k, p.detach()).float().cpu() for k, p in
                     net.named_parameters()}
    out["replicated"] = torch.cat([p.detach().reshape(-1) for k, p in net.named_parameters()
                                   if not trainer.specs.get(k)])
    out["bytes"] = trainer.param_bytes()
    if kind == "prior_pp":
        g = torch.Generator(device=dev).manual_seed(5)
        noise = torch.randn(PRIOR_PP_SAMPLE, ve.shape[1], generator=g, device=dev)
        net.eval()

        def sample():
            with active_mesh(mesh):
                return prior.sample_loop(RowKeys(list(range(PRIOR_PP_SAMPLE))),
                                         te[:PRIOR_PP_SAMPLE], cond_scale=2.0,
                                         init_noise=noise).float().cpu()

        out["sample"] = timed(f"{kind} sample", sample)
    del trainer, prior, net
    torch.cuda.empty_cache()
    return out


# rows of the prior's NCCL run's handoff (half train, half val: 2 steps at
# the recipe's batch of 256)
PRIOR_NCCL_ROWS = 1024


def prior_par_hold(torch, kind, ranks, ref, got, walls, card) -> None:
    """Hold ``kind``'s shared-card run (``ranks``: each rank's numbers;
    ``got``: rank 0's gathered gradient, parameters and sample) to the one
    process's ``ref``, and log it."""
    losses = [ranks[0]["grad_loss"], *ranks[0]["losses"]]
    want = [ref["grad_loss"], *ref["losses"]]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    g_worst, g_which = par_rel_l2(torch, got["grads"], ref["grads"])
    p_worst, p_which = par_rel_l2(torch, got["params"], ref["params"])
    whole = ref["bytes"]
    line = (f"parallel {kind}: losses {[round(x, 6) for x in losses]} vs one process "
            f"{[round(x, 6) for x in want]} (worst relative {loss_err:.2e}, hold "
            f"{PRIOR_PAR_LOSS_RTOL}); gradient vs one process: worst relative L2 {g_worst:.3e} "
            f"({g_which}; hold {PRIOR_PAR_GRAD_RTOL}); parameters after {PRIOR_PAR_STEPS} steps: "
            f"worst relative L2 {p_worst:.3e} ({p_which}; hold {PRIOR_PAR_PARAM_RTOL}); "
            f"replicated parameters equal on the ranks: "
            f"{all(r['replicated_equal'] for r in ranks)}; bytes per rank (parameters, Adam "
            f"moments) {[tuple(r['bytes']) for r in ranks]} of {tuple(whole)} whole; walls per "
            f"rank (s) {[round(w[kind], 3) for w in walls]} for {PRIOR_PAR_STEPS} steps, "
            f"gradient {[round(w[kind + ' gradient'], 3) for w in walls]}")
    ok = (loss_err <= PRIOR_PAR_LOSS_RTOL and g_worst <= PRIOR_PAR_GRAD_RTOL
          and p_worst <= PRIOR_PAR_PARAM_RTOL and all(r["replicated_equal"] for r in ranks)
          and all(r["losses"] == ranks[0]["losses"] for r in ranks))
    if "sample" in ref:
        s_err = float((got["sample"] - ref["sample"]).norm() / ref["sample"].norm())
        line += (f"; sample of {PRIOR_PP_SAMPLE} rows at cond_scale 2 over 64 DDIM steps: "
                 f"relative L2 {s_err:.3e} (hold {PRIOR_PAR_SAMPLE_RTOL}), walls per rank (s) "
                 f"{[round(w[kind + ' sample'], 3) for w in walls]}")
        ok = ok and s_err <= PRIOR_PAR_SAMPLE_RTOL and bool(torch.isfinite(got["sample"]).all())
    log(line + f" (gloo, host-staged, {PAR_RANKS} ranks on one card) [{card}]")
    if not ok:
        raise AssertionError(f"parallel {kind}: differs from the one-process run")


def parallel_phase(dev, torch, root: str):
    """See the comment above PAR_RANKS. Returns {run: launches summed over
    the ranks} and {run: [each rank's launches]}."""
    import os
    import socket
    import subprocess
    from pathlib import Path

    import numpy as np

    from dalle2_video_tpu_torch.engine.decoder import build_decoder
    from dalle2_video_tpu_torch.models.layers import kernel_init_
    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.train import load_latest
    from dalle2_video_tpu_torch.train.__main__ import SyntheticVideos

    out_dir = Path(root) / "parallel"
    out_dir.mkdir()
    cfg = par_config("auto")
    torch.manual_seed(0)
    decoder = build_decoder(cfg, dev)
    w = decoder.unets[0].to_out.Conv_0.weight  # redrawn, as the train path's
    kernel_init_(w, w[0].numel())
    unet1 = {k: v.detach().cpu() for k, v in decoder.unets[0].state_dict().items()}
    del decoder
    data = SyntheticVideos(2, cfg["frame_numbers"][-1], cfg["frame_sizes"][-1], cfg["dim"],
                           cfg["channels"], seed=3)
    g = torch.Generator().manual_seed(4)
    size1 = cfg["frame_sizes"][0]
    draws = [{"times": torch.randint(0, 1000, (2,), generator=g),
              "noise": torch.randn(2, cfg["frame_numbers"][0], size1, size1, 3, generator=g),
              "video_keep": torch.tensor([True, False])} for _ in range(PAR_DP_STEPS)]
    requests = (["a person smiling", "a person talking"], np.array([7, 8], dtype=np.uint32))
    torch.save({"unet1": unet1, "video": torch.from_numpy(data.videos),
                "embed": torch.from_numpy(data.embeds), "draws": draws,
                "requests": requests}, out_dir / "inputs.pt")

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    env = dict(os.environ, WORLD_SIZE=str(PAR_RANKS), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    logs = [open(out_dir / f"rank{r}.log", "w") for r in range(PAR_RANKS)]
    t0 = time.time()
    ranks = [subprocess.Popen([sys.executable, __file__, "--parallel-rank", str(out_dir)],
                              env=dict(env, RANK=str(r), LOCAL_RANK="0"), stdout=log,
                              stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    nccl_log = open(out_dir / "nccl.log", "w")
    nccl = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
         "-m", "dalle2_video_tpu_torch.train", "smoke=true", "mesh.data=-1",
         f"run_dir={out_dir / 'nccl_run'}", "log_level=INFO"],
        stdout=nccl_log, stderr=subprocess.STDOUT)
    # the prior's entry point under torchrun at world size 1 (NCCL): the
    # pipeline's fallback, the recipe's prior at M = 4 on a handoff of
    # seeded embeddings
    emb = np.random.default_rng(6).standard_normal((2, PRIOR_NCCL_ROWS, cfg["dim"]))
    for name, a in zip(("video", "text"), emb.astype(np.float32)):
        np.save(out_dir / f"prior_{name}.npy", a)
    prior_log = open(out_dir / "nccl_prior.log", "w")
    nccl_prior = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
         "-m", "dalle2_video_tpu_torch.train.train_prior",
         f"videos.embed={out_dir / 'prior_video.npy'}",
         f"texts.embed={out_dir / 'prior_text.npy'}", f"run_dir={out_dir / 'nccl_prior'}",
         f"prior.pipeline_microbatches={PRIOR_PP_MICROBATCHES}", "prior.epochs=1",
         "train_ratio=0.5", "log_level=INFO"], stdout=prior_log, stderr=subprocess.STDOUT)
    try:
        # the one-process references, meanwhile
        refs = {}
        trainer = par_trainer(torch, "auto", unet1, dev)
        vid, emb = torch.from_numpy(data.videos).to(dev), torch.from_numpy(data.embeds).to(dev)
        refs["grad_loss"] = float(trainer.backward(vid, video_embed=emb, unet_number=1,
                                                   draws=draws[0]))
        refs["grads"] = {k: p.grad.float().cpu() for k, p in
                         trainer.decoder.unets[0].named_parameters()}
        trainer.optimizers[0].zero_grad()
        refs["losses"], refs["params"] = [], {}
        for j in range(PAR_DP_STEPS):
            refs["losses"].append(float(trainer.train_step(vid, video_embed=emb, unet_number=1,
                                                           draws=draws[j])))
            refs["params"][j + 1] = {k: p.detach().float().cpu() for k, p in
                                     trainer.decoder.unets[0].named_parameters()}
        del trainer, vid, emb
        torch.cuda.empty_cache()
        scfg, _ = path_config(SERVE_PATHS["serve"])
        scfg["sample_seed"], scfg["run_dir"] = 0, str(out_dir / "no_checkpoints")
        generate_batch, _ = option_stack(scfg, dev, torch)
        refs["videos"] = generate_batch(*requests, cond_scale=3.0, ddim_steps=OPTION_STEPS)
        refs["alone"] = np.concatenate([generate_batch(
            requests[0][i:i + 1], requests[1][i:i + 1], cond_scale=3.0,
            ddim_steps=OPTION_STEPS) for i in range(len(requests[0]))])
        del generate_batch
        torch.cuda.empty_cache()
        for kind in PRIOR_PAR:  # the priors in one process
            refs[kind] = prior_par_run(torch, dev, kind)
        for p in (*ranks, nccl, nccl_prior):
            p.wait(timeout=600)
    finally:
        for p in (*ranks, nccl, nccl_prior):
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in (*logs, nccl_log, prior_log):
            f.close()
    wall = time.time() - t0
    for r, p in enumerate(ranks):
        if p.returncode != 0:
            raise AssertionError(f"parallel: rank {r} exited {p.returncode}:\n"
                                 + (out_dir / f"rank{r}.log").read_text()[-3000:])
    results = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(PAR_RANKS)]
    kernels = all_kernels()
    runs, by_rank = {}, {}
    for name in ("train_dp gradient", "train_dp", "train_sp gradient", "train_sp", "serve_dp",
                 *(f"{kind}{part}" for kind in PRIOR_PAR
                   for part in (" gradient", "", " sample") if kind == "prior_pp"
                   or part != " sample")):
        want = {k.name: 0 for k in kernels}
        if not name.startswith("prior"):  # no kernel lies on the prior
            want.update(par_expected(name))
        for r, res in enumerate(results):
            got = res["launches"][name]
            if got != want:
                raise AssertionError(f"parallel {name}: rank {r} launches {got}, the structure "
                                     f"predicts {want}")
            bwd = got.get("flash_mqa_bwd", 0)
            if bwd and res["routes"][name] != {"tensor_cores": bwd}:
                raise AssertionError(f"parallel {name}: rank {r} backward routes "
                                     f"{res['routes'][name]} (the global batch's: tensor cores)")
        if name.startswith("train_sp"):
            for r, res in enumerate(results):
                if res["flash_shapes"][name] != PAR_SP_SHAPES:
                    raise AssertionError(f"parallel {name}: rank {r} flash shapes "
                                         f"{res['flash_shapes'][name]}, want {PAR_SP_SHAPES}")
        by_rank[name] = [res["launches"][name] for res in results]
        runs[name] = {k.name: sum(res["launches"][name][k.name] for res in results)
                      for k in kernels}
    card = card_line()
    for name in ("train_dp", "train_sp"):
        r0 = results[0][name]
        if not all(res[name]["ranks_equal"] for res in results):
            raise AssertionError(f"parallel {name}: the ranks' parameters differ")
        if any(res[name]["losses"] != r0["losses"] for res in results):
            raise AssertionError(f"parallel {name}: the ranks' losses differ")
        worst, which = par_rel_l2(torch, torch.load(out_dir / f"{name}_grads.pt"),
                                  refs["grads"])
        got_params = torch.load(out_dir / f"{name}_params.pt")
        want_params = refs["params"][len(r0["losses"])]
        p_worst, p_which = par_rel_l2(torch, got_params, want_params)
        u_worst, u_which = par_rel_l2(torch, got_params, want_params, unet1)
        losses = [r0["grad_loss"], *r0["losses"]]
        want = [refs["grad_loss"], *refs["losses"][:len(r0["losses"])]]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        log(f"parallel {name}: losses {[round(x, 5) for x in losses]} vs one process "
            f"{[round(x, 5) for x in want]} (worst relative {loss_err:.2e}, hold "
            f"{PAR_LOSS_RTOL}); gradient vs one process: worst relative L2 {worst:.3e} "
            f"({which}; hold {PAR_GRAD_RTOL}); unet-1 parameters after the steps vs one "
            f"process: worst relative L2 {p_worst:.3e} ({p_which}; hold {PAR_PARAM_RTOL}), "
            f"of their change from the start {u_worst:.3e} ({u_which}); Adam moments per rank "
            f"{[res[name]['moment_bytes'] for res in results]} B of "
            f"{r0['moment_bytes_whole']} B whole; walls per rank (s) "
            f"{[round(res['walls'][name], 2) for res in results]} for {len(r0['losses'])} "
            f"steps, gradient {[round(res['walls'][name + ' gradient'], 2) for res in results]}"
            f" (gloo, host-staged, {PAR_RANKS} ranks on one card) [{card}]")
        if not (loss_err <= PAR_LOSS_RTOL and worst <= PAR_GRAD_RTOL
                and p_worst <= PAR_PARAM_RTOL):
            raise AssertionError(f"parallel {name}: differs from the one-process steps")
    videos = torch.load(out_dir / "serve_dp_videos.pt", weights_only=False)
    alone = refs["alone"]
    if videos.shape != alone.shape or not np.isfinite(videos).all():
        raise AssertionError(f"parallel serve_dp: videos {videos.shape}, want {alone.shape}")
    diff = np.abs(alone - refs["videos"])
    log(f"parallel serve_dp: 2 requests over {PAR_RANKS} ranks equal each request served "
        f"alone by one process: {bool(np.array_equal(videos, alone))}; one process's group "
        f"of 2 against its requests alone: max |diff| {float(diff.max()):.3e}, mean "
        f"{float(diff.mean()):.3e}, share differing {float((diff > 0).mean()):.4f}; walls "
        f"per rank (s) {[round(res['walls']['serve_dp'], 2) for res in results]} [{card}]")
    if not np.array_equal(videos, alone):
        raise AssertionError("parallel serve_dp: a row's video depends on the rank that "
                             "sampled it")
    for kind in PRIOR_PAR:
        prior_par_hold(torch, kind, [res[kind] for res in results], refs[kind],
                       torch.load(out_dir / f"{kind}.pt"),
                       [res["walls"] for res in results], card)
    nccl_text = (out_dir / "nccl.log").read_text()
    if nccl.returncode != 0:
        raise AssertionError(f"parallel: the NCCL entry point exited {nccl.returncode}:\n"
                             + nccl_text[-3000:])
    nccl_state = load_latest(str(out_dir / "nccl_run" / "decoder_default"))
    if nccl_state["steps"] != [1, 1] or "backend nccl" not in nccl_text:
        raise AssertionError(f"parallel: the NCCL run took steps {nccl_state['steps']}; "
                             f"its log:\n{nccl_text[-2000:]}")
    prior_text = (out_dir / "nccl_prior.log").read_text()
    if nccl_prior.returncode != 0:
        raise AssertionError(f"parallel: the prior's NCCL entry point exited "
                             f"{nccl_prior.returncode}:\n" + prior_text[-3000:])
    prior_state = load_latest(str(out_dir / "nccl_prior" / "prior_default"))
    prior_steps = PRIOR_NCCL_ROWS // 2 // int(cfg["prior"]["batch_size"])
    if prior_state["step"] != prior_steps or "backend nccl" not in prior_text:
        raise AssertionError(f"parallel: the prior's NCCL run took {prior_state['step']} "
                             f"steps, want {prior_steps}; its log:\n{prior_text[-2000:]}")
    log(f"parallel: the decoder's entry point under torchrun --nproc_per_node=1 "
        f"(process group backend nccl) trained one batch through both unets, the prior's "
        f"(pipeline_microbatches {PRIOR_PP_MICROBATCHES}, its local loop at world size 1) "
        f"{prior_steps} steps; phase wall {wall:.1f} s; launches by run {runs}")
    return runs, by_rank


# "sample_cli": python -m dalle2_video_tpu_torch.serve.sample (the README's
# stage 5) at the serve recipe, its config asking SAMPLE_CLI_STEPS DDIM
# steps a stage: the plain request through the CLI's main, then (through
# the CLI's request handling on one generate_batch) the same request,
# inpainting of frames SAMPLE_CLI_KNOWN of a 64 px known clip, a negative
# prompt and a long video of SAMPLE_CLI_FRAMES frames (2 windows).
SAMPLE_CLI_STEPS = OPTION_STEPS
SAMPLE_CLI_KNOWN = (0, 1)
SAMPLE_CLI_FRAMES = 158  # 90 + (90 - 22): two windows at the default overlap
SAMPLE_CLI_SEED = 7


def sample_cli(dev, torch, root: str):
    """The CLI's .npy files: float32 (1, T, 128, 128, 3), finite, in [0,
    1]; the plain one bit for bit build_generate_batch's video for the same
    prompt and seed at batch 1; the known frames the known clip resized to
    128 px within 1e-6; every request's launches of rows 1, 3 and 5 as the
    unet structure predicts (option_launches). The guided route of the same
    callable is serve_options' (c)."""
    import logging

    import numpy as np

    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.ops.video import resize_video
    from dalle2_video_tpu_torch.serve import sample
    from dalle2_video_tpu_torch.serve.stack import build_generate_batch
    from dalle2_video_tpu_torch.utils.config import config_from_argv

    card = card_line()
    prompt = "a person smiling"
    argv = [*SERVE_PATHS["serve"]["overrides"],
            f"sample_timesteps=[{SAMPLE_CLI_STEPS},{SAMPLE_CLI_STEPS}]",
            f"run_dir={root}/no_checkpoints", f"sample_seed={SAMPLE_CLI_SEED}",
            f"prompt={prompt}", "cond_scale=3.0"]
    cfg = config_from_argv(argv)
    t_win, size = cfg["frame_numbers"][-1], cfg["frame_sizes"][-1]
    known = np.random.default_rng(0).random((t_win, cfg["frame_sizes"][0],
                                             cfg["frame_sizes"][0], 3), dtype=np.float32)
    np.save(f"{root}/sample_known.npy", known)
    known_out = resize_video(torch.from_numpy(known[None]), size, clamp_range=(0.0, 1.0))[0]
    kernels = all_kernels()
    totals, results = Counter(), {}

    def request(label, windows, fn):
        for k in kernels:
            k.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        vid = fn()
        wall = time.time() - t0
        got = {k.name: k.launches for k in kernels if k.launches}
        want = option_launches(windows, guided=False)
        if got != want:
            raise AssertionError(f"sample_cli {label}: launches {got}, the unet structure "
                                 f"gives {want}")
        totals.update(got)
        frames = SAMPLE_CLI_FRAMES if windows > 1 else t_win
        if vid.dtype != np.float32 or vid.shape != (1, frames, size, size, 3):
            raise AssertionError(f"sample_cli {label}: {vid.dtype} {vid.shape}")
        if not (np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
            raise AssertionError(f"sample_cli {label}: values not finite in [0, 1]")
        results[label] = vid
        log(f"sample_cli {label}: {wall:.3f} s ({frames / wall:.2f} frames/s, the stack's "
            f"build included where the CLI builds it), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {got}; mean "
            f"{float(vid.mean()):.3f} std {float(vid.std()):.3f} [{card}]")
        return vid

    out = f"{root}/sample_plain.npy"
    cli = request("python -m ...serve.sample (plain)", 1,
                  lambda: sample.main([*argv, f"out={out}"]))
    if not np.array_equal(np.load(out), cli):
        raise AssertionError("sample_cli: the .npy is not the video the CLI returned")
    t0 = time.time()
    gb = build_generate_batch(cfg, logging.getLogger("chip_smoke"), dev)
    log(f"sample_cli: generate_batch built in {time.time() - t0:.1f} s")
    served = request("build_generate_batch, the same prompt and seed", 1,
                     lambda: gb([prompt], [SAMPLE_CLI_SEED], cond_scale=3.0, ddim_steps=None))
    if not np.array_equal(cli, served):
        raise AssertionError(f"sample_cli: the CLI's video differs from the server's by up to "
                             f"{float(np.abs(cli - served).max()):.3e}")
    frames = ",".join(map(str, SAMPLE_CLI_KNOWN))
    vid = request(f"inpaint_frames={frames}", 1, lambda: sample.sample(
        {**cfg, "inpaint_video": f"{root}/sample_known.npy", "inpaint_frames": frames,
         "out": f"{root}/sample_inpaint.npy"}, generate_batch=gb))
    idx = list(SAMPLE_CLI_KNOWN)
    err = float(np.abs(vid[0, idx] - known_out[idx].numpy()).max())
    log(f"sample_cli inpaint_frames={frames}: known frames vs the known clip at {size} px: "
        f"max |diff| {err:.3e}")
    if err > 1e-6:
        raise AssertionError(f"sample_cli: the known frames moved by {err:.3e}")
    request("negative_prompt", 1, lambda: sample.sample(
        {**cfg, "negative_prompt": "a person frowning", "out": f"{root}/sample_negative.npy"},
        generate_batch=gb))
    request(f"n_frames={SAMPLE_CLI_FRAMES}", 2, lambda: sample.sample(
        {**cfg, "n_frames": SAMPLE_CLI_FRAMES, "out": f"{root}/sample_long.npy"},
        generate_batch=gb))
    log(f"sample_cli: the CLI's plain video equals build_generate_batch's bit for bit; "
        f"launches {dict(totals)}")
    del gb
    torch.cuda.empty_cache()
    return {k.name: totals[k.name] for k in kernels}


# "curve": train/train_curve.py's recipe at full width (the unets 50.2M and
# 14.1M parameters), cut to CURVE_STEPS steps a stage (the recipe: 600) and
# an end sample of CURVE_SAMPLE_STEPS DDIM steps a stage (the recipe: 64);
# then on that teacher eval_quality at CURVE_N clips with CURVE_LADDER and
# its cascade grid, demo_inpaint's extension, demo_longvideo at
# CURVE_LONG_FRAMES frames, distill --curve at CURVE_DISTILL_PHASES (one step
# each) and the SR witness at CURVE_SR_STEPS steps; the cascade grid, the
# demos and the witness's reference sample at CURVE_SAMPLING_STEPS DDIM
# steps (the scripts: 64). Unet 1 (xla attention, GroupNorm and
# cross-attention) launches no kernel; unet 2 launches row 1 at every
# forward (fwd_residuals: twice where it is differentiated at batch 1) and
# row 2 at every backward, all held in phase 2 (check_curve_kernels).
CURVE_STEPS = 50
CURVE_SAMPLE_STEPS = 4
CURVE_SAMPLING_STEPS = 16
CURVE_N = 16
CURVE_LADDER = (8, 16)
CURVE_LONG_FRAMES = 32
CURVE_LONG_N = 4
CURVE_DISTILL_PHASES = (32, 16)
CURVE_SR_STEPS = 2


def curve_launches(train_steps=0, sr_forwards=0, sr_samples=0, witness_steps=0):
    """Rows 1 and 2 of a curve run: per SR-unet train step (batch 1) two
    forwards and a backward; one forward per SR sampling step; per SR
    witness step two teacher forwards, the student's two and a backward."""
    fwd = 2 * train_steps + sr_forwards + sr_samples + 4 * witness_steps
    return {k: v for k, v in (("flash_mqa_fwd", fwd),
                              ("flash_mqa_bwd", train_steps + witness_steps)) if v}


def curve_phase(dev, torch, root: str):
    """The curve run: per stage the losses finite and the last 10 steps'
    mean below the first 10's, the mid-run reload equal to the state saved
    before it exactly, ms a step and peak memory printed; the end sample
    finite in [0, 1]. Then the scripts on its teacher, each result finite
    (the inpainting's known region within 1e-6). Every run's launches of
    rows 1 and 2 exact (curve_launches), every backward on the CUDA cores."""
    import copy
    import dataclasses
    from pathlib import Path
    from unittest import mock

    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.ops.flash_mqa import BWD_KERNEL
    from dalle2_video_tpu_torch.train import (demo_inpaint, demo_longvideo, distill,
                                              distill_sr_demo, eval_quality, train_curve)

    card = card_line()
    kernels = all_kernels()
    totals = Counter()
    run = Path(root) / "r2_curve"

    def counted(label, want, fn):
        for k in kernels:
            k.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = fn()
        wall = time.time() - t0
        got = {k.name: k.launches for k in kernels if k.launches}
        if got != want:
            raise AssertionError(f"curve {label}: launches {got}, the structure gives {want}")
        if want.get("flash_mqa_bwd") and BWD_KERNEL.routes != {
                "cuda_cores": want["flash_mqa_bwd"]}:
            raise AssertionError(f"curve {label}: flash backward routes {BWD_KERNEL.routes}, "
                                 "the JAX rule gives the CUDA cores at batch 1")
        totals.update(got)
        log(f"curve {label}: {wall:.1f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {got} [{card}]")
        return out

    saved, loaded = [], []
    save, load = train_curve.save_checkpoint, train_curve.load_checkpoint

    def saving(path, state):
        if not loaded:  # the last save before the reload; its tensors live on in the trainer
            saved[:] = [copy.deepcopy(state)]
        return save(path, state)

    def loading(path, **kw):
        state = load(path, **kw)
        loaded.append(copy.deepcopy(state))  # the optimiser may keep these tensors
        return state

    with mock.patch.object(train_curve, "save_checkpoint", saving), \
            mock.patch.object(train_curve, "load_checkpoint", loading):
        out = counted(f"train_curve ({CURVE_STEPS} steps a stage)",
                      curve_launches(CURVE_STEPS, sr_samples=CURVE_SAMPLE_STEPS),
                      lambda: train_curve.train_curve(run, CURVE_STEPS, dev,
                                                      sample_steps=CURVE_SAMPLE_STEPS))
    if len(loaded) != 1:
        raise AssertionError(f"curve: {len(loaded)} reloads, the run exercises one")
    _same_state(loaded[0], saved[0], "the mid-run reload")
    summary = json.loads((run / "summary.json").read_text())
    for u in ("1", "2"):
        first, last = summary["loss_first10_mean"][u], summary["loss_last10_mean"][u]
        if not (math.isfinite(first) and math.isfinite(last) and last < first):
            raise AssertionError(f"curve stage {u}: loss of the first 10 steps {first}, of the "
                                 f"last 10 {last}")
    sample_range = summary["sample_range"]
    if not (sample_range[0] >= 0.0 and sample_range[1] <= 1.0):
        raise AssertionError(f"curve: the end sample's range {sample_range}")
    log(f"curve train_curve: {CURVE_STEPS} steps a stage, the mid-run reload (stage 1 step "
        f"{CURVE_STEPS // 2}) equal to the saved state; ms a step "
        f"{ {u: round(v, 2) for u, v in summary['ms_per_step'].items()} }, peak memory GiB "
        f"{ {u: round(v, 2) for u, v in summary['peak_memory_gib'].items()} }, loss first 10 "
        f"{summary['loss_first10_mean']} last 10 {summary['loss_last10_mean']}; end sample "
        f"{summary['sample_shape']} at {CURVE_SAMPLE_STEPS} DDIM steps a stage in "
        f"{summary['sample_s']:.1f} s [{card}]")
    del out

    steps = (CURVE_SAMPLING_STEPS,) * 2
    grid_config = dataclasses.replace(eval_quality.eval_config(), sample_timesteps=steps)
    with mock.patch.object(eval_quality, "eval_config", lambda: grid_config):
        res = counted(f"eval_quality (N {CURVE_N}, ladder {CURVE_LADDER}, the cascade grid)",
                      curve_launches(sr_samples=CURVE_SAMPLING_STEPS),
                      lambda: eval_quality.eval_quality(run, Path(root) / "eval_quality",
                                                        CURVE_N, CURVE_LADDER, device=dev))
    finite_results("eval_quality", res)
    log(f"curve eval_quality: anchors {res['fvd_real_vs_real_splithalf']!r} (real vs real) "
        f"{res['fvd_real_vs_noise']!r} (real vs noise); "
        + ", ".join(f"DDIM-{st} FVD {res[f'fvd_ddim{st}']!r} in {res[f'sample_s_ddim{st}']:.2f} s"
                    for st in CURVE_LADDER)
        + f"; cascade grid {res['cascade_sample_shape']} in {res['cascade_sample_s']:.2f} s")
    with mock.patch.object(demo_inpaint, "STEPS", CURVE_SAMPLING_STEPS):
        res = counted("demo_inpaint (extend)", {},
                      lambda: demo_inpaint.demo_inpaint(run, Path(root) / "demo_inpaint",
                                                        CURVE_N, (("extend", "replace"),), dev))
    finite_results("demo_inpaint", res)
    if not res["extend_known_max_err"] <= 1e-6:
        raise AssertionError(f"demo_inpaint: the known frames moved by "
                             f"{res['extend_known_max_err']}")
    log(f"curve demo_inpaint extend: known region max |err| {res['extend_known_max_err']:.3e}, "
        f"FVD {res['extend_fvd']!r}, {res['extend_sample_s']:.2f} s")
    with mock.patch.object(demo_longvideo, "STEPS", CURVE_SAMPLING_STEPS):
        res = counted(f"demo_longvideo ({CURVE_LONG_N} clips of {CURVE_LONG_FRAMES} frames)",
                      {}, lambda: demo_longvideo.demo_longvideo(
                          run, Path(root) / "demo_longvideo", CURVE_LONG_N, CURVE_LONG_FRAMES,
                          CURVE_N, dev))
    finite_results("demo_longvideo", res)
    log(f"curve demo_longvideo: FVD windows {res['fvd_windows']!r}, first "
        f"{res['fvd_first_window']!r}, last {res['fvd_last_window']!r}; seam flicker ratio "
        f"{res['ratio']!r}; {res['sample_s']:.2f} s")
    with mock.patch.object(distill, "PHASES", CURVE_DISTILL_PHASES), \
            mock.patch.object(distill, "N_EVAL", CURVE_N):
        res = counted(f"distill --curve (phases {CURVE_DISTILL_PHASES}, one step each)", {},
                      lambda: distill.distill_curve(run, Path(root) / "distill_curve", 1, dev))
    finite_results("distill --curve", res)
    log("curve distill --curve: " + ", ".join(
        f"student {s} FVD {res[f'fvd_student{s}']!r}" for s in CURVE_DISTILL_PHASES)
        + f"; anchor {res['fvd_real_vs_real_splithalf']!r}")
    sr = distill_sr_demo.STUDENT_STEPS
    with mock.patch.object(distill_sr_demo, "REF_STEPS", CURVE_SAMPLING_STEPS):
        res = counted(f"distill_sr_demo ({CURVE_SR_STEPS} steps)",
                      curve_launches(sr_samples=CURVE_SAMPLING_STEPS + 2 * sr,
                                     witness_steps=CURVE_SR_STEPS),
                      lambda: distill_sr_demo.distill_sr_demo(run, Path(root) / "distill_sr",
                                                              CURVE_SR_STEPS, dev))
    finite_results("distill_sr_demo", res)
    log(f"curve distill_sr_demo: PSNR vs the teacher's {CURVE_SAMPLING_STEPS}-step SR: "
        f"teacher {sr} steps {res['psnr_teacher8_vs_ref64']!r}, student "
        f"{res['psnr_student8_vs_ref64']!r}; SR sampling s {res['sr_sample_s']}")
    torch.cuda.empty_cache()
    return {k.name: totals[k.name] for k in kernels}


def finite_results(label, res):
    """Every number of a script's results finite (FVDs not below -1e-6)."""
    bad = {k: v for k, v in res.items() if isinstance(v, float) and not (
        math.isfinite(v) and (v >= -1e-6 or not k.startswith("fvd")))}
    if bad:
        raise AssertionError(f"{label}: results {bad}")


# "train_prior_moe": the recipe's prior (depth 6, dim 512, 8 x 64 heads)
# with a top-2 mixture of 8 experts in every layer (prior.ff_experts 8)
# and self-conditioning (neither has a config key the JAX prior_from_config
# reads with it: the network config is built here), at prior.batch_size;
# then one best-of-2 64-step sample.
# No kernel lies on it.
MOE_EXPERTS = 8


def train_prior_moe(dev, torch):
    """PRIOR_STEPS Adam steps of the MoE + self-conditioned prior on seeded
    device embeddings: finite losses and load-balance aux, every parameter
    moved; one best-of-2 DDIM sample at the recipe's 64 steps: finite
    (b, dim) embeds. No kernel launches. Prints ms per step, samples/s,
    peak memory."""
    from dalle2_video_tpu_torch.models.prior import (
        DiffusionPrior,
        DiffusionPriorConfig,
        PriorNetworkConfig,
    )
    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.train.train_prior import PriorTrainer
    from dalle2_video_tpu_torch.utils.config import load_config
    from dalle2_video_tpu_torch.utils.keys import RowKeys, derive_generator, init_from

    card = card_line()
    kernels = all_kernels()
    for k in kernels:
        k.reset()
    cfg = load_config(None)
    pc = cfg["prior"]
    pcfg = DiffusionPriorConfig(
        network=PriorNetworkConfig(dim=cfg["dim"], depth=pc["depth"], heads=pc["heads"],
                                   dim_head=pc["dim_head"], ff_experts=MOE_EXPERTS,
                                   self_cond=True),
        timesteps=pc["timesteps"], sample_timesteps=pc["sample_timesteps"])
    with init_from(derive_generator(cfg["seed"], 4, 0)):
        prior = DiffusionPrior(pcfg, dev)
    trainer = PriorTrainer(prior, float(pc["lr"]),
                           generator=derive_generator(cfg["seed"], 4, 1, device=dev))
    b, d = pc["batch_size"], cfg["dim"]
    g = torch.Generator(device=dev).manual_seed(2)
    ve, te = (torch.randn(b, d, generator=g, device=dev) for _ in range(2))
    before = {k: p.detach().clone() for k, p in prior.network.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    ms, losses = timed_steps(torch, lambda: float(trainer.train_step(ve, te)), PRIOR_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        t = torch.randint(0, pc["timesteps"], (b,), generator=g, device=dev)
        _, aux = prior.network(ve * prior.embed_scale, t, text_embed=te, return_aux=True)
    if not (all(math.isfinite(x) for x in losses) and math.isfinite(float(aux))):
        raise AssertionError(f"train_prior_moe: losses {losses}, aux {float(aux)}")
    moved(torch, before, prior.network, "train_prior_moe")
    steady = sum(ms[1:]) / len(ms[1:])
    n_params = sum(p.numel() for p in prior.network.parameters())
    log(f"train_prior_moe: prior depth {pc['depth']}, dim {d}, {MOE_EXPERTS} experts top-2 "
        f"(capacity factor {pcfg.network.moe_capacity_factor}), self_cond, {n_params / 1e6:.1f}M "
        f"params, batch {b}: ms per step {[round(x, 2) for x in ms]} (first apart), mean after "
        f"the first {steady:.2f} ms, {b / steady * 1e3:.0f} samples/s; peak memory {peak:.3f} "
        f"GiB; losses {[round(x, 4) for x in losses]}, load-balance aux {float(aux):.4f} "
        f"[{card}]")
    prior.network.eval()
    t0 = time.time()
    embeds = prior.sample(RowKeys([1, 2]), te[:2], num_samples_per_batch=2, cond_scale=1.0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    if embeds.shape != (2, d) or not bool(torch.isfinite(embeds).all()):
        raise AssertionError(f"train_prior_moe: sample {tuple(embeds.shape)} not finite")
    log(f"train_prior_moe: best-of-2 sample of 2 rows at {pcfg.sample_timesteps} DDIM steps: "
        f"{wall:.2f} s [{card}]")
    del trainer, prior, before
    torch.cuda.empty_cache()
    return no_launches(kernels, "train_prior_moe")


# --------------------------------------------------------------- phase 6
def probes(dev, torch):
    """The flash probes' rows (dalle2_video_tpu_torch/probes), counts set to
    0 before them and read after: each timed call runs 2 warm-up calls and
    ITERS (the VJP 5) timed ones."""
    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.probes import ITERS, perf_r3_probe8, perf_r3_probe9

    calls = ITERS + 2
    kernels = all_kernels()
    for k in kernels:
        k.reset()
    card = card_line()
    records = perf_r3_probe8.rows(dev, card) + perf_r3_probe9.rows(dev, card)
    launches = {k.name: k.launches for k in kernels}
    failed = [r["name"] for r in records if "error" in r]
    if failed:
        raise AssertionError(f"probe rows failed: {failed}")
    # r2 once; the fused forward: probe 8's two rows and the VJP's forward,
    # probe 9's control and wide2048; the backward in the VJP; inner x 4
    want = {k.name: 0 for k in kernels}
    want.update(flash_r2_fwd=calls, flash_inner_fwd=4 * calls, flash_mqa_fwd=4 * calls + 7,
                flash_mqa_bwd=7)
    log(f"probes: launches {launches} expected {want}")
    if launches != want:
        raise AssertionError("probes: kernel launch counts differ from the rows'")
    check_bwd_routes("probes", launches)
    torch.cuda.empty_cache()
    return launches


def profile_device(label, torch, fn):
    """fn under torch.profiler: wall time, device busy time and idle share,
    the top kernels, and the share of each of the port's kernel families."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if getattr(ev, "device_type", None) == cuda and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    log(f"profile: {label}: wall {wall_ms:.1f} ms, device busy {total:.1f} ms, idle share "
        f"{100 * max(0.0, 1 - total / wall_ms):.1f}% ({sum(r[1] for r in rows)} kernel launches)")
    for ms, count, key in rows[:15]:
        log(f"  {ms:9.2f} ms {100 * ms / total:5.1f}% x{count:5d} {key[:100]}")
    # each device kernel counts in the first family it matches
    # (the profiled paths run the wgmma mainloop only as row 1)
    groups = {"flash_mqa_fwd": ("flash_mqa_fwd", "flash_fwd_wgmma_kernel"),
              "flash_mqa_bwd": ("flash_mqa_bwd", "tc::dq_kernel", "tc::dkv_kernel"),
              "groupnorm_film_silu_fwd": ("gn_fwd_kernel",),
              "groupnorm_film_silu_bwd / fused_block_gn_bwd": ("gn_bwd_",),
              "cross_attention_fwd": ("cross_attention_",),
              "conv3x3 / conv3x3_bias_stats": ("conv3x3_bf16_kernel", "conv3x3_f32_kernel",
                                               "stats_reduce_kernel"),
              "conv3x3_wgrad": ("wgrad_bf16_kernel", "wgrad_f32_kernel", "wgrad_reduce_kernel"),
              "convolution (cuDNN / cutlass)": ("cudnn", "conv2d", "xmma_fprop", "implicit_gemm",
                                                "convolve", "dgrad", "wgrad")}
    family = {}
    for _, _, key in rows:
        family[key] = next((n for n, pats in groups.items() if any(p in key for p in pats)), None)
    for name in groups:
        ms = sum(r[0] for r in rows if family[r[2]] == name)
        log(f"  {name}: {ms:.2f} ms ({100 * ms / max(total, 1e-9):.1f}% of device time)")


def profile_request(cfg, dev, torch, steps: int, label: str):
    """One request (CFG batch 2) at the serving config: wall time of each
    layer (text tower, prior, each cascade stage), then the cascade under
    torch.profiler -- device time by kernel and the device's idle share."""
    from dalle2_video_tpu_torch.data.tokenizer import tokenize
    from dalle2_video_tpu_torch.serve.stack import build_stack
    from dalle2_video_tpu_torch.utils.keys import RowKeys

    text_enc, wrapper = build_stack(cfg, dev)
    dec = wrapper.decoder
    tokens = torch.as_tensor(tokenize(["a person smiling"]), device=dev)
    keys = RowKeys.from_request_seeds([7])

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.time() - t0) * 1e3

    with torch.no_grad():
        wrapper.generate(keys, text_enc(tokens), cond_scale=3.0, sample_timesteps=2)
        embed, t_text = timed(lambda: text_enc(tokens))
        k_prior, k_dec = keys.split()
        vemb, t_prior = timed(lambda: wrapper._prior_embeds(k_prior, embed, 1.0, None)[0])
        k0, k1 = k_dec.split(2)
        v0, t_s0 = timed(lambda: dec.sample_stage(0, k0, batch_size=1, video_embed=vemb,
                                                   cond_scale=3.0, sample_timesteps=steps))
        _, t_s1 = timed(lambda: dec.sample_stage(1, k1, batch_size=1, prev_video=v0,
                                                  cond_scale=3.0, sample_timesteps=steps))
        log(f"profile: {label}: 1 request, {steps} DDIM steps per stage: text tower "
            f"{t_text:.1f} ms, "
            f"prior ({cfg['prior']['sample_timesteps']} DDIM steps, best-of-2) {t_prior:.1f} ms, "
            f"stage 1 (64 px) "
            f"{t_s0:.1f} ms = {t_s0 / steps:.1f} ms/step, stage 2 (128 px) {t_s1:.1f} ms "
            f"= {t_s1 / steps:.1f} ms/step")
        profile_device(f"{label} cascade", torch, lambda: dec.sample(
            k_dec, video_embed=vemb, cond_scale=3.0, sample_timesteps=steps))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one request and one train step per unet by kernel")
    ap.add_argument("--parallel-rank", metavar="DIR",
                    help="(internal) run one rank of the parallel phase's shared-card runs")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if args.parallel_rank:
        return par_rank(args.parallel_rank)
    from dalle2_video_tpu_torch.ops import _cuda
    from dalle2_video_tpu_torch.utils.device import resolve_device

    t_start = time.time()
    dev = resolve_device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    for mod in ("yaml", "regex", "triton"):
        try:
            __import__(mod)
            log(f"module {mod}: present")
        except ImportError:
            log(f"module {mod}: absent")

    t0 = time.time()
    built = _cuda.build_all()
    log(f"kernels built in {time.time() - t0:.1f} s (parallel nvcc): "
        + ", ".join(f"{k} {v:.1f}s" for k, v in built.items()))
    for src, text in _cuda.BUILD_LOG.items():
        fn = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line or "wgmma" in line:
                log(f"  ptxas {src} {fn}: {line.split(':', 1)[-1].strip()}")

    phases = {}

    def phase(name, fn, *a):
        t = time.time()
        out = fn(*a)
        phases[name] = time.time() - t
        log(f"phase {name}: {phases[name]:.1f} s")
        return out

    rows = phase("kernels", lambda: check_curve_kernels(dev, torch, check_probe_kernels(
        dev, torch, check_conv_kernels(dev, torch, check_backward_kernels(
            dev, torch, check_student_kernels(dev, torch, check_kernels(dev, torch)))))))

    def module_checks():
        for case in MODULE_CASES:
            check_modules(dev, torch, case)
            check_module_grads(dev, torch, case)
        check_temporal_sr_layers(dev, torch)
        check_remat_policies(dev, torch)
        check_resize_and_adapters(dev, torch)

    phase("module checks", module_checks)
    # each main path's own run: its counts set to 0 before it, read after it
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        # the random-weight paths serve from a run_dir that holds no stage
        # checkpoint; only serve_trained serves what the stages write
        empty = f"{root}/no_checkpoints"
        for path in SERVE_PATHS:
            runs[path] = phase(path, serve, dev, torch, path, empty, args.profile)
        runs["serve_options"] = phase("serve_options", serve_options, dev, torch, empty)
        runs["serve_text"] = phase("serve_text", serve_text, dev, torch, args.profile)
        for path in TRAIN_PATHS:
            runs[path] = phase(path, train, dev, torch, path, args.profile)
        runs["train_text"] = phase("train_text", train_text, dev, torch, args.profile)
        stages = Stages(root)
        runs["train_clip"] = phase("train_clip", train_clip_phase, dev, torch, stages,
                                   args.profile)
        runs["train_prior"] = phase("train_prior", train_prior_phase, dev, torch, stages,
                                    args.profile)
        runs["train_data"] = phase("train_data", train_data, dev, torch, stages)
        runs["serve_trained"] = phase("serve_trained", serve_trained, dev, torch, stages)
        runs["import_reference"] = phase("import_reference", import_reference, dev, torch,
                                         stages)
        runs["distill"] = phase("distill", distill_phase, dev, torch, stages, args.profile)
        runs["serve_student"] = phase("serve_student", serve_student, dev, torch, stages)
        runs["train_vqgan"] = phase("train_vqgan", train_vqgan_phase, dev, torch, stages)
        runs["latent"] = phase("latent", latent_phase, dev, torch, stages)
        par_runs, par_by_rank = phase("parallel", parallel_phase, dev, torch, root)
        runs.update(par_runs)
        runs["sample_cli"] = phase("sample_cli", sample_cli, dev, torch, root)
        runs["curve"] = phase("curve", curve_phase, dev, torch, root)
    runs["train_prior_moe"] = phase("train_prior_moe", train_prior_moe, dev, torch)
    runs["probes"] = phase("probes", probes, dev, torch)
    log("phase times (s): " + ", ".join(f"{k} {v:.1f}" for k, v in phases.items())
        + f"; total since start {time.time() - t_start:.1f}")
    out = []
    for k in _cuda.all_kernels():
        r = rows[k.name]
        # launches: over every main path's run, each run's count beside it
        row = {"name": k.name, "route": "cuda",
               "source": f"dalle2_video_tpu_torch/csrc/{k.source}",
               "replaces": k.replaces,
               "launches": sum(counts[k.name] for counts in runs.values()),
               "launches_by_run": {path: counts[k.name] for path, counts in runs.items()},
               # the shared-card runs: each rank's count beside the sum
               "launches_by_rank": {path: [c[k.name] for c in counts]
                                    for path, counts in par_by_rank.items()},
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"],
               "check": "ok", "tolerance": r["tolerance"], "shape": r["shape"]}
        for extra in ("conv_alone_ms", "variants", "library_fwd_bwd_ms", "probe_geometry",
                      "serve_step", "block_k_2048", "text", "student_step", "latent",
                      "curve"):
            if extra in r:
                row[extra] = r[extra]
        out.append(row)
    log(json.dumps({"kernels": out}))
    log(card_line())  # name, power limit -- as nvidia-smi prints them
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # noqa: BLE001 -- any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
