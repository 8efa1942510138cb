#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py             # all phases, one card
    python3 chip_smoke.py --profile   # and a per-layer / per-kernel profile

Phases (any failure exits non-zero and prints no result line):
  1. environment: card name and power limit, torch / CUDA versions, and the
     parallel nvcc build of every kernel under dalle2_video_tpu_torch/csrc/;
  2. kernels: each hand-written kernel against its plain PyTorch version on
     the card, in bf16, at the shapes the serving path gives it, with
     kernel / plain / library times and the card's lower bound;
     The backward kernels are checked the same way at the training shapes
     (bf16, and one f32 case each), and so are the opt-in conv paths'
     kernels (the 3x3 conv and its dx, its weight gradient, the conv + bias
     + statistics forward, the fused block's GroupNorm backward) at the
     slice's shapes;
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
  5. train: the decoder training path at the same widths and recipe
     (attention_impl auto -> flash at the 5760-token bottlenecks,
     cross_attention_impl xla, bf16 compute, batch 2) on synthetic
     90x128x128 videos, on each path of TRAIN_PATHS: "train" (groupnorm_impl
     pallas, with a checkpoint round trip) and "train_conv" (the conv
     paths): its steps of each unet, one eval_loss each; finite losses,
     every parameter moved, EMA step counts, and every step's launch counts
     as the unet structure predicts. Prints ms per step, samples/s and peak
     memory.
Then it prints the {"kernels": [...]} line, the card line, and as the last
line {"ok": true, "device": {...}}.

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
anywhere; atol covers the f32 work before the rounding near zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

REQUESTS = 3  # served as a group of 2 and a group of 1
STEPS = 50  # DDIM steps per stage, sized to the 1200 s limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
EXP_PER_S = 132 * 16 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device time per call: CUDA events around ``iters`` back-to-back calls.
    A ~50 ms spin kernel is queued first so the host has enqueued every call
    before the device reaches them; the events then time the device, not
    the wrappers' host cost."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_time(name: str, fn):
    """Time a PyTorch yardstick call; None (and a log line) if it refuses."""
    try:
        return time_ms(fn)
    except RuntimeError as exc:
        log(f"library call for {name} failed: {exc}")
        return None


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
def check_kernels(dev, torch):
    """Each kernel vs its plain version at serving shapes (bf16)."""
    import torch.nn.functional as F

    from dalle2_video_tpu_torch.ops import cross_attention as xa
    from dalle2_video_tpu_torch.ops import flash_mqa as fm
    from dalle2_video_tpu_torch.ops import groupnorm_film as gn

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    rows = {}

    # flash-MQA: joint bottleneck of both unets at 90 frames, CFG batch 2
    b, n, h, d = 2, 90 * 8 * 8, 16, 32
    q = torch.randn(b, n * h, d, generator=g, device=dev).to(bf)
    k = torch.randn(b, n + 1, d, generator=g, device=dev).to(bf)
    v = torch.randn(b, n + 1, d, generator=g, device=dev).to(bf)
    sc = d**-0.5
    out = fm.flash_mqa_fwd(q, k, v, sm_scale=sc)
    ref = fm.flash_mqa_reference(q, k, v, sc)
    # |out| ~ 0.02 here; the kernel's bf16 P costs ~5e-5 before the rounding,
    # while one dropped or mis-scaled kv tile of 64 keys moves it by ~1e-3
    e, tol = check("flash_mqa_fwd", f"b={b} n_q={n * h} n_kv={n + 1} d={d}", out, ref,
                   atol=5e-4, rtol=1e-2)
    qh = q.view(b, n, h, d).transpose(1, 2)
    # the library yardstick gets the kv expanded per head (no MQA entry)
    kh = k[:, None].expand(b, h, n + 1, d).contiguous()
    vh = v[:, None].expand(b, h, n + 1, d).contiguous()
    bnd, by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                    flops=4.0 * b * n * h * (n + 1) * d, exps=float(b * n * h * (n + 1)))
    rows["flash_mqa_fwd"] = dict(
        max_abs_err=e, tolerance=tol, shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16",
        ms=time_ms(lambda: fm.flash_mqa_fwd(q, k, v, sm_scale=sc)),
        plain_ms=time_ms(lambda: fm.flash_mqa_reference(q, k, v, sc), iters=3),
        library_ms=library_time("flash_mqa_fwd", lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=sc)),
        bound_ms=bnd, bound_by=by)
    del q, k, v, out, ref, qh, kh, vh

    # GroupNorm-FiLM-SiLU: largest L of each unet, C = 8 and the widest C
    gn_cases = [("unet2 stage 0", 2, 90 * 128 * 128, 8),
                ("unet1 stage 0", 2, 90 * 64 * 64, 64),
                ("unet1 bottleneck", 2, 90 * 8 * 8, 512)]
    for i, (label, b, l, c) in enumerate(gn_cases):
        x = (torch.randn(b, l, c, generator=g, device=dev) * 2 + 0.3).to(bf)
        gamma = (1 + 0.1 * torch.randn(c, generator=g, device=dev)).to(bf)
        beta = (0.1 * torch.randn(c, generator=g, device=dev)).to(bf)
        s_ = (0.1 * torch.randn(b, c, generator=g, device=dev)).to(bf)
        t_ = (0.1 * torch.randn(b, c, generator=g, device=dev)).to(bf)
        out = gn.groupnorm_film_silu(x, gamma, beta, s_, t_, 8)
        ref = gn.groupnorm_film_reference(x, gamma, beta, s_, t_, 8, 1e-5)
        # the statistics are f32 sums over up to 1.5M values in another order
        e, tol = check("groupnorm_film_silu_fwd", f"{label} B={b} L={l} C={c}", out, ref,
                       atol=2e-2, rtol=1e-2)
        if i == 0:
            bnd, by = bound(2 * x.numel() * 2)
            rows["groupnorm_film_silu_fwd"] = dict(
                max_abs_err=e, tolerance=tol,
                shape=f"x{tuple(x.shape)} bf16",
                ms=time_ms(lambda: gn.groupnorm_film_silu(x, gamma, beta, s_, t_, 8)),
                plain_ms=time_ms(lambda: gn.groupnorm_film_reference(
                    x, gamma, beta, s_, t_, 8, 1e-5), iters=3),
                library_ms=None, bound_ms=bnd, bound_by=by)
        else:
            kms = time_ms(lambda: gn.groupnorm_film_silu(x, gamma, beta, s_, t_, 8))
            log(f"  ms={kms:.4f} bound_ms={bound(2 * x.numel() * 2)[0]:.4f}")
        del x, out, ref

    # cross-attention: unet1 (m = 7) at 90x32x32, unet2 (m = 3) at 90x64x64
    xa_cases = [("unet2 stage 1", 2, 90 * 64 * 64, 3), ("unet1 stage 1", 2, 90 * 32 * 32, 7)]
    for i, (label, b, n, m) in enumerate(xa_cases):
        h, d = 8, 64
        q = torch.randn(b, n, h, d, generator=g, device=dev).to(bf)
        k = torch.randn(b, m, h, d, generator=g, device=dev).to(bf)
        v = torch.randn(b, m, h, d, generator=g, device=dev).to(bf)
        out = xa.cross_attention(q, k, v, sm_scale=d**-0.5)
        # the plain version runs in its input dtype: an f32-math oracle is
        # f32 copies of the same bf16 inputs, rounded once at the end
        ref = xa.cross_attention_reference(q.float(), k.float(), v.float(), d**-0.5).to(bf)
        # f32 math on the same bf16 inputs: only the output rounding differs
        e, tol = check("cross_attention_fwd", f"{label} b={b} n={n} m={m}", out, ref,
                       atol=1e-3, rtol=1e-2)
        bnd, by = bound(2 * (2 * q.numel() + 2 * k.numel()), flops=4.0 * b * h * n * m * d)
        if i == 0:
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            rows["cross_attention_fwd"] = dict(
                max_abs_err=e, tolerance=tol, shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16",
                ms=time_ms(lambda: xa.cross_attention(q, k, v, sm_scale=d**-0.5)),
                plain_ms=time_ms(lambda: xa.cross_attention_reference(
                    q.float(), k.float(), v.float(), d**-0.5).to(bf), iters=3),
                library_ms=library_time("cross_attention_fwd",
                                        lambda: F.scaled_dot_product_attention(qt, kt, vt)),
                bound_ms=bnd, bound_by=by)
        else:
            kms = time_ms(lambda: xa.cross_attention(q, k, v, sm_scale=d**-0.5))
            log(f"  ms={kms:.4f} bound_ms={bnd:.4f}")
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return rows


def check_backward_kernels(dev, torch, rows):
    """The two backward kernels vs their plain versions at the training
    shapes, bf16 (one f32 case each). Inputs that come from the forward
    (out, lse, mean, rstd) are the forward kernels' own, handed to both."""
    from dalle2_video_tpu_torch.ops import flash_mqa as fm
    from dalle2_video_tpu_torch.ops import groupnorm_film as gn

    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16

    # flash backward: the joint bottleneck of either unet at 90 frames, batch 2
    for dtype, (b, n_q, n_kv) in ((torch.float32, (2, 333, 65)),
                                  (bf, (2, 90 * 8 * 8 * 16, 90 * 8 * 8 + 1))):
        d = 32
        q = torch.randn(b, n_q, d, generator=g, device=dev).to(dtype)
        k = torch.randn(b, n_kv, d, generator=g, device=dev).to(dtype)
        v = torch.randn(b, n_kv, d, generator=g, device=dev).to(dtype)
        go = torch.randn(b, n_q, d, generator=g, device=dev).to(dtype)
        sc = d**-0.5
        out, lse = fm.flash_mqa_fwd(q, k, v, sm_scale=sc, save_lse=True)
        got = fm.flash_mqa_bwd(q, k, v, out, lse, go, sm_scale=sc)
        want = fm.flash_mqa_bwd_reference(q, k, v, out, lse, go, sc)
        # f32: same f32 math in another summation order (sums of up to 92k
        # terms): 1e-5 of the largest value. bf16: both sides round the f32
        # result once (rtol 1e-2 admits one flip, 2^-7 of the value); atol
        # 1e-3 of the largest value covers the f32 sums near zero.
        e, tol = rel("flash_mqa_bwd", f"{dtype} b={b} n_q={n_q} n_kv={n_kv} d={d}",
                     ("dq", "dk", "dv"), got, want, rtol=0.0 if dtype == torch.float32 else 1e-2,
                     atol_frac=1e-5 if dtype == torch.float32 else 1e-3)
        if dtype == bf:
            # five (n_q x n_kv x d) products; P formed once
            bnd, by = bound(2 * (4 * q.numel() + 4 * k.numel()) + 8 * b * n_q,
                            flops=5 * 2.0 * b * n_q * n_kv * d, exps=float(b * n_q * n_kv))
            h = 16
            qh = q.view(b, n_q // h, h, d).transpose(1, 2).detach().requires_grad_()
            kh = k[:, None].expand(b, h, n_kv, d).contiguous().requires_grad_()
            vh = v[:, None].expand(b, h, n_kv, d).contiguous().requires_grad_()
            goh = go.view(b, n_q // h, h, d).transpose(1, 2)
            import torch.nn.functional as F

            def sdpa_bwd():
                o = F.scaled_dot_product_attention(qh, kh, vh, scale=sc)
                torch.autograd.grad(o, (qh, kh, vh), goh)

            rows["flash_mqa_bwd"] = dict(
                max_abs_err=e, tolerance=tol,
                shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16",
                ms=time_ms(lambda: fm.flash_mqa_bwd(q, k, v, out, lse, go, sm_scale=sc)),
                plain_ms=time_ms(lambda: fm.flash_mqa_bwd_reference(q, k, v, out, lse, go, sc),
                                 iters=2),
                # forward + backward of SDPA with kv expanded per head: a
                # yardstick only (it recomputes the forward)
                library_ms=library_time("flash_mqa_bwd", sdpa_bwd),
                bound_ms=bnd, bound_by=by)
        del q, k, v, go, out, lse, got, want

    # GroupNorm backward: the training path's largest L at C = 8, C = 64 and
    # the widest C
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
        e, tol = rel("groupnorm_film_silu_bwd", f"{label} {dtype} B={b} L={l} C={c}",
                     ("dx", "dA", "dB"), got, want, rtol=0.0 if dtype == torch.float32 else 1e-2,
                     atol_frac=1e-5 if dtype == torch.float32 else 1e-3)
        if dtype == bf:
            kms = time_ms(lambda: gn.groupnorm_film_bwd(*args))
            bnd, by = bound(3 * x.numel() * 2)  # read x and g, write dx
            if "groupnorm_film_silu_bwd" not in rows:
                rows["groupnorm_film_silu_bwd"] = dict(
                    max_abs_err=e, tolerance=tol, shape=f"x{tuple(x.shape)} bf16", ms=kms,
                    plain_ms=time_ms(lambda: gn.groupnorm_film_bwd_reference(*args), iters=3),
                    library_ms=None, bound_ms=bnd, bound_by=by)
            else:
                log(f"  ms={kms:.4f} bound_ms={bnd:.4f}")
        del x, gy, got, want
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
    # its dx (every fused site; the dx of the 64-wide stage is this shape)
    for dtype, label, shape in ((torch.float32, "f32 check", (6, 16, 16, 64, 128)),
                                (bf, "unet1 mid (pallas_small)", (180, 8, 8, 512, 512)),
                                (bf, "unet1 stage 0 (dx)", stage0)):
        x, wt = inputs(dtype, *shape)
        e, tl = rel("conv3x3", f"{label} {dtype} {shape}", ("y",), [sc.conv3x3(x, wt)],
                    [sc.conv3x3_reference(x, wt)], **tol[dtype])
        if dtype == bf:
            n, h, w, c, co = shape
            bnd, by = bound(2 * (x.numel() + wt.numel() + n * h * w * co),
                            flops=conv_flops(*shape))
            kms = time_ms(lambda: sc.conv3x3(x, wt))
            xc, wc = cl(x, wt)
            lib = library_time("conv3x3", lambda: F.conv2d(xc, wc, padding=1))
            log(f"  ms={kms:.4f} bound_ms={bnd:.4f} ({by}) cudnn_ms={lib}")
            if shape == stage0:
                rows["conv3x3"] = dict(
                    max_abs_err=e, tolerance=tl, shape=f"x{tuple(x.shape)} w{tuple(wt.shape)} bf16",
                    ms=kms, plain_ms=time_ms(lambda: sc.conv3x3_reference(x, wt), iters=3),
                    library_ms=lib, bound_ms=bnd, bound_by=by)
        del x, wt

    # row 7: the weight gradient of every fused site. Its oracle is the
    # plain version on f64 copies: over the 737,280 pixels of the 64x64
    # stage the f32 plain version (cuDNN, one long sum per value) is itself
    # off by ~1e-4 of the largest value, the kernel (split-K, short f32
    # sums) by ~1e-5 (both logged below), so 1e-5 of the largest value.
    for dtype, label, shape in ((torch.float32, "f32 check", (6, 16, 16, 64, 128)),
                                (bf, "unet1 stage 2", (180, 16, 16, 256, 256)),
                                (bf, "unet1 stage 0", stage0)):
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
            log(f"  ms={kms:.4f} bound_ms={bnd:.4f} ({by}) library_ms={lib}")
            if shape == stage0:
                rows["conv3x3_wgrad"] = dict(
                    max_abs_err=e, tolerance=tl, shape=f"x, dy{tuple(x.shape)} bf16 -> dW f32",
                    ms=kms, plain_ms=time_ms(lambda: sc.conv3x3_wgrad_reference(x, dy), iters=3),
                    library_ms=lib, bound_ms=bnd, bound_by=by)
        del x, dy, got

    # row 8: conv + bias + statistics of the fused forward, batch 2 rows
    for dtype, label, shape in ((torch.float32, "f32 check (147-pixel rows)", (6, 7, 7, 64, 64)),
                                (bf, "unet1 stage 0", stage0)):
        x, wt = inputs(dtype, *shape)
        bias = 0.5 * torch.randn(shape[4], generator=g, device=dev)
        got, want = fb.conv_bias_stats(x, wt, bias, 2), fb.conv_bias_stats_reference(x, wt, bias, 2)
        e, tl = rel("conv3x3_bias_stats", f"{label} {dtype} {shape} y", ("y",), got[:1],
                    want[:1], **tol[dtype])
        rel("conv3x3_bias_stats", f"{label} {dtype} {shape}", ("sum", "sum of squares"),
            got[1:], want[1:], rtol=0.0, atol_frac=1e-5)
        if not all(torch.equal(a, b) for a, b in zip(got, fb.conv_bias_stats(x, wt, bias, 2))):
            raise AssertionError("conv3x3_bias_stats: two calls differ")
        if dtype == bf:
            n, h, w, c, co = shape
            bnd, by = bound(2 * (x.numel() + wt.numel() + n * h * w * co) + 4 * (co + 4 * co),
                            flops=conv_flops(*shape))
            xc, wc = cl(x, wt)
            rows["conv3x3_bias_stats"] = dict(
                max_abs_err=e, tolerance=tl, shape=f"x{tuple(x.shape)} w{tuple(wt.shape)} bf16, "
                                                   "2 batch rows",
                ms=time_ms(lambda: fb.conv_bias_stats(x, wt, bias, 2)),
                plain_ms=time_ms(lambda: fb.conv_bias_stats_reference(x, wt, bias, 2), iters=3),
                # no one call computes conv + bias + the statistics; what the
                # conv alone costs in cuDNN stands beside it
                library_ms=None, conv_alone_ms=library_time(
                    "conv3x3_bias_stats", lambda: F.conv2d(xc, wc, padding=1)),
                bound_ms=bnd, bound_by=by)
        del x, wt, got, want

    # row 9: the fused block's GroupNorm-FiLM-SiLU backward on the conv
    # output, the row-4 kernel counted under its own entry
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
        e, tl = rel("fused_block_gn_bwd", f"{label} {dtype} B={b} L={l} C={c}", ("dy", "dA", "dB"),
                    gn.groupnorm_film_bwd(*args, kernel=fb.GN_BWD_KERNEL),
                    gn.groupnorm_film_bwd_reference(*args),
                    rtol=tol[dtype]["rtol"], atol_frac=1e-5 if dtype == torch.float32 else 1e-3)
        if dtype == bf:
            bnd, by = bound(3 * y.numel() * 2)  # read y and g, write dy
            rows["fused_block_gn_bwd"] = dict(
                max_abs_err=e, tolerance=tl, shape=f"y{tuple(y.shape)} bf16",
                ms=time_ms(lambda: gn.groupnorm_film_bwd(*args, kernel=fb.GN_BWD_KERNEL)),
                plain_ms=time_ms(lambda: gn.groupnorm_film_bwd_reference(*args), iters=3),
                library_ms=None, bound_ms=bnd, bound_by=by)
        del y, gy
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------- phase 3
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


# --------------------------------------------------------------- phase 4
# The main paths: the full-width celebv_text cascade at the 90-frame recipe,
# bf16 unets, CFG batch 2, driven through the serving engine. "serve" is
# the kernel path of PRs 1-2 (groupnorm_impl pallas); "serve_conv" the
# opt-in conv paths (groupnorm_impl fused, spatial_conv_impl pallas_small),
# cut to fewer requests and steps to keep the script well inside its limit.
# per_step: each kernel's launches per DDIM step of one group -- one CFG
# forward per unet: flash once (mid_attn); GroupNorm twice per
# ResnetBlock3D (27 / 33 blocks); cross-attention once per conditioned
# block (17 / 22); on the conv paths the fused block at 44 / 19 sites and
# the conv kernel at 7 / 0 (every other site is the plain conv and the
# plain GroupNorm: tests/test_torch_port_convpaths.py counts them).
SERVE_PATHS = {
    "serve": dict(
        knobs=["groupnorm_impl=pallas"], requests=REQUESTS, steps=STEPS,
        per_step={"flash_mqa_fwd": 2, "groupnorm_film_silu_fwd": 54 + 66,
                  "cross_attention_fwd": 17 + 22}),
    "serve_conv": dict(
        knobs=["groupnorm_impl=fused", "spatial_conv_impl=pallas_small"], requests=2, steps=20,
        per_step={"flash_mqa_fwd": 2, "conv3x3_bias_stats": 44 + 19, "conv3x3": 7 + 0,
                  "cross_attention_fwd": 17 + 22}),
}


def serve(dev, torch, path: str, profile: bool = False):
    import logging
    from concurrent.futures import wait

    import numpy as np

    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.serve.engine import GenerationEngine, GenRequest
    from dalle2_video_tpu_torch.serve.stack import build_generate_batch
    from dalle2_video_tpu_torch.utils.config import load_config

    spec = SERVE_PATHS[path]
    requests, steps = spec["requests"], spec["steps"]
    knobs = [f"unet{u}.{k}" for u in (1, 2) for k in spec["knobs"]]
    cfg = load_config(None, [
        "frame_numbers=[90,90]", *knobs,
        "unet1.cross_attention_impl=flash", "unet2.cross_attention_impl=flash",
        "sample_compute_dtype=bfloat16", "sample_seed=0",
    ])
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
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t_submit = time.time()
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

    for i, res in enumerate(results):
        vid = res["video"]
        if vid.shape != (90, 128, 128, 3):
            raise AssertionError(f"{path} request {i}: shape {vid.shape}")
        if not (np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
            raise AssertionError(f"{path} request {i}: values not finite in [0, 1]")
        log(f"{path} request {i}: batch {res['batch_size']} (bucket {res['bucket']}) "
            f"group time {res['device_ms'] / 1e3:.2f} s -> {90 / (res['device_ms'] / 1e3):.2f} "
            f"frames/s; mean {float(vid.mean()):.3f} std {float(vid.std()):.3f}")
    groups = stats["batches"]
    want = {k.name: groups * steps * spec["per_step"].get(k.name, 0) for k in kernels}
    log(f"{path}: {requests} requests in {groups} groups, {steps} DDIM steps per stage, "
        f"wall {wall:.2f} s, {90 * requests / wall:.2f} frames/s overall, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{path}: launches {launches} expected {want}")
    if launches != want:
        raise AssertionError(f"{path}: kernel launch counts differ from the unet structure's")
    diff = float(np.mean(results[0]["video"] != results[1]["video"]))
    log(f"{path}: share of values that differ between requests 0 and 1: {diff:.3f}")
    if profile:
        profile_request(cfg, dev, torch, steps=10, label=path)
    return launches


# --------------------------------------------------------------- phase 5
TRAIN_BATCH = 2
# The training paths at the same widths and recipe (attention_impl auto ->
# flash at the 5760-token bottlenecks, cross_attention_impl xla, bf16
# compute over f32 masters, batch 2). Each has its knobs, its steps per
# unet, and whether it makes the checkpoint round trip.
TRAIN_PATHS = {
    "train": dict(knobs=["groupnorm_impl=pallas"], steps=4, checkpoint=True),
    "train_conv": dict(knobs=["groupnorm_impl=fused", "spatial_conv_impl=pallas_small"],
                       steps=3, checkpoint=False),
}
CONV_SITES = {1: (44, 7), 2: (19, 0)}  # (fused blocks, pallas_small convs) per forward


def train_expected(path, u, backward, recompute):
    """One forward (and backward) of unet u: flash once (mid_attn) and its
    backward; "train": GroupNorm twice per ResnetBlock3D (27 / 33 blocks)
    and its backward; "train_conv": kernel 8 at each fused site, and in the
    backward the GroupNorm backward (row 9), the conv dx (kernel 6) and the
    weight gradient (kernel 7) there; kernel 6 forward at each pallas_small
    site, whose backward is the plain conv's. A checkpointed block runs its
    forward again in the backward."""
    rf = 2 if recompute else 1
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
    """A decoder training path at the full celebv_text widths on 90-frame
    synthetic videos (numpy, seeded): its steps of TRAIN_BATCH, each
    training unet 1 then unet 2 (as train_decoder does), one eval_loss per
    unet, and (if the path says so) one checkpoint save -> load round trip.
    Every kernel's launches are counted per step and must equal what the
    unet structure predicts."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from dalle2_video_tpu_torch.engine.decoder import build_decoder
    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.train import load_checkpoint, save_checkpoint
    from dalle2_video_tpu_torch.train.__main__ import SyntheticVideos, build_trainer
    from dalle2_video_tpu_torch.utils.config import load_config

    spec = TRAIN_PATHS[path]
    n_steps = spec["steps"]
    knobs = [f"unet{u}.{k}" for u in (1, 2) for k in spec["knobs"]]
    cfg = load_config(None, [
        "frame_numbers=[90,90]", *knobs,
        "unet1.cross_attention_impl=xla", "unet2.cross_attention_impl=xla",
        "decoder.bf16_compute=true", f"decoder.batch_size={TRAIN_BATCH}",
    ])
    b = TRAIN_BATCH
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
            k.launches = 0
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.time() - t) * 1e3
        got = {k.name: k.launches for k in kernels}
        if got != want:
            raise AssertionError(f"{path}: launches {got}, the unet structure predicts {want}")
        return out, ms, got

    as_dev = lambda a: torch.as_tensor(a, device=dev)
    totals = {k.name: 0 for k in kernels}
    ms = {1: [], 2: []}
    for step in range(n_steps):
        batch = data.batch_items(np.arange(step * b, (step + 1) * b))
        vid, emb = as_dev(batch["videos"]), as_dev(batch["video_embeds"])
        for u in (1, 2):
            loss, t_ms, got = run(lambda: trainer.train_step(vid, video_embed=emb, unet_number=u),
                                  expected(u, backward=True))
            loss = float(loss)
            if not np.isfinite(loss):
                raise AssertionError(f"{path}: unet {u} step {step} loss {loss}")
            ms[u].append(t_ms)
            for k, v in got.items():
                totals[k] += v
            log(f"{path}: step {step} unet {u}: loss {loss:.4f}, {t_ms:.1f} ms")
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
    log(f"{path}: launches over {n_steps} + {n_steps} steps {totals}")
    if profile:
        batch = data.batch_items(np.arange(b))
        vid, emb = as_dev(batch["videos"]), as_dev(batch["video_embeds"])
        for u in (1, 2):
            profile_device(f"{path} step unet {u}", torch, lambda: trainer.train_step(
                vid, video_embed=emb, unet_number=u))
    del trainer
    torch.cuda.empty_cache()
    return totals


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
    groups = {"flash_mqa_fwd": ("flash_mqa_fwd",),
              "flash_mqa_bwd": ("flash_mqa_bwd",),
              "groupnorm_film_silu_fwd": ("gn_stats_kernel", "gn_apply_kernel"),
              "groupnorm_film_silu_bwd / fused_block_gn_bwd": ("gn_bwd_",),
              "cross_attention_fwd": ("cross_attention_kernel",),
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
        vemb, t_prior = timed(lambda: wrapper._prior_embeds(k_prior, embed, 1.0, None))
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
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    try:
        from dalle2_video_tpu_torch.ops import _cuda
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 2
    from dalle2_video_tpu_torch.utils.device import resolve_device

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
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")

    rows = check_conv_kernels(dev, torch, check_backward_kernels(dev, torch,
                                                                 check_kernels(dev, torch)))
    for case in MODULE_CASES:
        check_modules(dev, torch, case)
        check_module_grads(dev, torch, case)
    # each main path's own run: its counts set to 0 before it, read after it
    runs = {path: serve(dev, torch, path, args.profile) for path in SERVE_PATHS}
    runs.update({path: train(dev, torch, path, args.profile) for path in TRAIN_PATHS})

    out = []
    for k in _cuda.all_kernels():
        r = rows[k.name]
        # launches: over every main path's run, each run's count beside it
        row = {"name": k.name, "route": "cuda",
               "source": f"dalle2_video_tpu_torch/csrc/{k.source}",
               "replaces": k.replaces,
               "launches": sum(counts[k.name] for counts in runs.values()),
               "launches_by_run": {path: counts[k.name] for path, counts in runs.items()},
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"],
               "check": "ok", "tolerance": r["tolerance"], "shape": r["shape"]}
        if "conv_alone_ms" in r:
            row["conv_alone_ms"] = r["conv_alone_ms"]
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
