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
     (bf16, and one f32 case each).
  3. module check: a small UNet3D with the kernel impls against the same
     weights on the plain impls, f32 and bf16; then one loss's gradients
     through both, bf16 compute over f32 masters;
  4. serve: the full-width celebv_text stack at the 90-frame recipe
     (frame_numbers [90, 90], groupnorm_impl pallas, cross_attention_impl
     flash, bf16 unets, random weights from a seed) behind GenerationEngine
     with buckets (1, 2); REQUESTS requests at cond_scale 3.0 and STEPS DDIM
     steps per stage must each return a finite (90, 128, 128, 3) video in
     [0, 1], and every kernel's launch count over this run must equal what
     the unet structure predicts (no backward kernel);
  5. train: the decoder training path at the same widths and recipe
     (groupnorm_impl pallas, attention_impl auto -> flash at the 5760-token
     bottlenecks, cross_attention_impl xla, bf16 compute, batch 2) on
     synthetic 90x128x128 videos: TRAIN_STEPS steps of each unet, one
     eval_loss each, a checkpoint round trip; finite losses, every
     parameter moved, EMA step counts, and every step's launch counts as
     the unet structure predicts. Prints ms per step, samples/s and peak
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
        ref = xa.cross_attention_reference(q, k, v, d**-0.5)
        # f32 math on the same bf16 inputs: only the output rounding differs
        e, tol = check("cross_attention_fwd", f"{label} b={b} n={n} m={m}", out, ref,
                       atol=1e-3, rtol=1e-2)
        bnd, by = bound(2 * (2 * q.numel() + 2 * k.numel()), flops=4.0 * b * h * n * m * d)
        if i == 0:
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            rows["cross_attention_fwd"] = dict(
                max_abs_err=e, tolerance=tol, shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16",
                ms=time_ms(lambda: xa.cross_attention(q, k, v, sm_scale=d**-0.5)),
                plain_ms=time_ms(lambda: xa.cross_attention_reference(q, k, v, d**-0.5), iters=3),
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

    def rel(name, label, parts, outs, refs, rtol, atol_frac):
        """check() on every output; atol is atol_frac of that output's
        largest plain value (the f32 sums' order error scales with it)."""
        errs = []
        for part, o, r in zip(parts, outs, refs):
            atol = atol_frac * float(r.float().abs().max())
            errs.append(check(name, f"{label} {part}", o, r, atol=atol, rtol=rtol)[0])
        return max(errs), f"{atol_frac:g}*max|ref| + {rtol:g}*|ref|"

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


def check_modules(dev, torch):
    """Small UNet3D: kernel impls vs plain impls on the same weights."""
    from dalle2_video_tpu_torch.models.unet3d import UNet3D, UNet3DConfig

    kw = dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, attn_heads=16,
              attn_dim_head=32, video_embed_dim=32, cond_on_video_embeds=True)
    torch.manual_seed(0)
    plain = _small_unet(UNet3D, UNet3DConfig, kw, dev)
    fast = UNet3D(UNet3DConfig(**kw, attention_impl="flash", groupnorm_impl="pallas",
                               cross_attention_impl="flash")).to(dev).eval()
    fast.load_state_dict(plain.state_dict())
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(2, 4, 32, 32, 3, generator=g, device=dev)
    ve = torch.randn(2, 32, generator=g, device=dev)
    t = torch.tensor([10, 700], device=dev)
    # bf16: 4e-2 of the output scale, about 3.5x the 3e-2 measured on an H100
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 4e-2)):
        p, f = plain.to(dtype), fast.to(dtype)
        with torch.no_grad():
            a = f(x.to(dtype), t, video_embed=ve.to(dtype)).float()
            b = p(x.to(dtype), t, video_embed=ve.to(dtype)).float()
        e = float((a - b).abs().max())
        scale = max(1.0, float(b.abs().max()))
        log(f"UNet3D kernels vs plain ({dtype}): max_abs_err={e:.3e} "
            f"(tol {tol} x output scale {scale:.2f})")
        if not (torch.isfinite(a).all() and e <= tol * scale):
            raise AssertionError("UNet3D with kernels disagrees with the plain impls")


# relative L2 error per parameter tensor: f32 is the same math summed in
# another order (1e-3); bf16 rounds activations and gradients (2^-8
# relative) at other places on the two sides -- the flash forward's P, the
# kernels' f32 sums -- and through ~20 layers that reaches 3e-2 on a
# LayerNorm weight even on the CPU, where both sides run the plain
# versions; 0.1 leaves room for it while a dropped or mis-scaled gradient
# (error ~1) fails.
GRAD_RTOL = {"float32": 1e-3, "bfloat16": 0.1}


def check_module_grads(dev, torch):
    """The same small UNet3D with gradients: one loss's gradients with the
    kernel impls (flash attention and its backward, the fused GroupNorm and
    its backward) and with the plain impls, on the same weights and the
    same draws, in f32 and in bf16 compute over f32 masters (as the trainer
    runs it). Every parameter tensor must get a nonzero gradient on both
    sides, within GRAD_RTOL of the plain one."""
    from dalle2_video_tpu_torch.models.unet3d import UNet3D, UNet3DConfig

    kw = dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, attn_heads=16,
              attn_dim_head=32, video_embed_dim=32, cond_on_video_embeds=True)
    torch.manual_seed(0)
    plain = _small_unet(UNet3D, UNet3DConfig, kw, dev)
    fast = UNet3D(UNet3DConfig(**kw, attention_impl="flash", groupnorm_impl="pallas")).to(dev)
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
            out = torch.func.functional_call(unet, cast, (x.to(dtype), t), dict(
                video_embed=ve.to(dtype), video_keep_mask=keep))
            ((out.float() - target) ** 2).mean().backward()
            grads.append({k: p.grad for k, p in unet.named_parameters()})
        worst, worst_name = 0.0, ""
        for name, gp in grads[0].items():
            gf = grads[1][name]
            if gp is None or gf is None or float(gp.norm()) == 0 or float(gf.norm()) == 0:
                raise AssertionError(f"module grads: {name} has no gradient on one side")
            rel = float((gf - gp).norm() / gp.norm())
            if rel > worst:
                worst, worst_name = rel, name
        tol = GRAD_RTOL[str(dtype).split(".")[-1]]
        log(f"UNet3D gradients, kernels vs plain ({dtype} compute, f32 masters): "
            f"{len(grads[0])} tensors, worst relative L2 error {worst:.3e} ({worst_name}); "
            f"tol {tol}")
        if not worst <= tol:
            raise AssertionError("UNet3D gradients with kernels disagree with the plain impls")


# --------------------------------------------------------------- phase 4
def serve(dev, torch, profile: bool = False):
    import logging
    from concurrent.futures import wait

    import numpy as np

    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.serve.engine import GenerationEngine, GenRequest
    from dalle2_video_tpu_torch.serve.stack import build_generate_batch
    from dalle2_video_tpu_torch.utils.config import load_config

    cfg = load_config(None, [
        "frame_numbers=[90,90]",
        "unet1.groupnorm_impl=pallas", "unet2.groupnorm_impl=pallas",
        "unet1.cross_attention_impl=flash", "unet2.cross_attention_impl=flash",
        "sample_compute_dtype=bfloat16", "sample_seed=0",
    ])
    t0 = time.time()
    generate_batch = build_generate_batch(cfg, logging.getLogger("chip_smoke"), dev)
    log(f"serve: stack built in {time.time() - t0:.1f} s "
        f"(frame_sizes {cfg['frame_sizes']}, frame_numbers {cfg['frame_numbers']}, "
        f"unet dims {cfg['unet1']['dim']}/{cfg['unet2']['dim']})")
    engine = GenerationEngine(generate_batch, buckets=(1, 2), max_wait_ms=50.0,
                              default_cond_scale=3.0, default_ddim_steps=STEPS)
    kernels = all_kernels()
    try:
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t_submit = time.time()
        futs = [engine.submit(GenRequest(f"a person smiling #{i}", seed=100 + i,
                                         cond_scale=3.0, ddim_steps=STEPS))
                for i in range(REQUESTS)]
        done, _ = wait(futs, timeout=900)
        if len(done) != REQUESTS:
            raise AssertionError("serve: requests did not finish")
        results = [f.result() for f in futs]
        wall = time.time() - t_submit
        launches = {k.name: k.launches for k in kernels}
        stats = engine.stats()
    finally:
        engine.close()

    for i, res in enumerate(results):
        vid = res["video"]
        if vid.shape != (90, 128, 128, 3):
            raise AssertionError(f"request {i}: shape {vid.shape}")
        if not (np.isfinite(vid).all() and vid.min() >= 0.0 and vid.max() <= 1.0):
            raise AssertionError(f"request {i}: values not finite in [0, 1]")
        log(f"request {i}: batch {res['batch_size']} (bucket {res['bucket']}) "
            f"group time {res['device_ms'] / 1e3:.2f} s -> {90 / (res['device_ms'] / 1e3):.2f} "
            f"frames/s; mean {float(vid.mean()):.3f} std {float(vid.std()):.3f}")
    groups = stats["batches"]
    # per forward: flash once per unet (mid_attn); GroupNorm twice per
    # ResnetBlock3D (27 / 33 blocks); cross-attention once per conditioned
    # block (17 / 22); one forward per DDIM step per stage
    want = {"flash_mqa_fwd": groups * STEPS * 2, "flash_mqa_bwd": 0,
            "groupnorm_film_silu_fwd": groups * STEPS * (54 + 66),
            "groupnorm_film_silu_bwd": 0,
            "cross_attention_fwd": groups * STEPS * (17 + 22)}
    log(f"serve: {REQUESTS} requests in {groups} groups, {STEPS} DDIM steps per stage, "
        f"wall {wall:.2f} s, {90 * REQUESTS / wall:.2f} frames/s overall, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"serve: launches {launches} expected {want}")
    if launches != want:
        raise AssertionError("kernel launch counts differ from the unet structure's")
    diff = float(np.mean(results[0]["video"] != results[1]["video"]))
    log(f"serve: share of values that differ between requests 0 and 1: {diff:.3f}")
    if profile:
        profile_request(cfg, dev, torch, steps=10)
    return launches


# --------------------------------------------------------------- phase 5
TRAIN_STEPS = 4  # optimizer steps per unet, one batch each
TRAIN_BATCH = 2
TRAIN_OVERRIDES = [
    "frame_numbers=[90,90]",
    "unet1.groupnorm_impl=pallas", "unet2.groupnorm_impl=pallas",
    "unet1.cross_attention_impl=xla", "unet2.cross_attention_impl=xla",
    "decoder.bf16_compute=true", f"decoder.batch_size={TRAIN_BATCH}",
]


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


def train(dev, torch, profile: bool = False):
    """The decoder training path at the full celebv_text widths on 90-frame
    synthetic videos (numpy, seeded): TRAIN_STEPS batches of TRAIN_BATCH,
    each training unet 1 then unet 2 (as train_decoder does), one
    eval_loss per unet, one checkpoint save -> load round trip. Every
    kernel's launches are counted per step and must equal what the unet
    structure predicts."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from dalle2_video_tpu_torch.engine.decoder import build_decoder
    from dalle2_video_tpu_torch.ops._cuda import all_kernels
    from dalle2_video_tpu_torch.train import load_checkpoint, save_checkpoint
    from dalle2_video_tpu_torch.train.__main__ import SyntheticVideos, build_trainer
    from dalle2_video_tpu_torch.utils.config import load_config

    cfg = load_config(None, TRAIN_OVERRIDES)
    b = TRAIN_BATCH
    t0 = time.time()
    data = SyntheticVideos(b * (TRAIN_STEPS + 1), cfg["frame_numbers"][-1],
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
    log(f"train: data and trainer built in {time.time() - t0:.1f} s; unet params "
        f"{n_params[0] / 1e6:.2f}M / {n_params[1] / 1e6:.2f}M; batch {b} of "
        f"{tuple(data.videos.shape[1:])} videos")
    start = [{k: p.detach().clone() for k, p in trainer.params(i).items()} for i in range(2)]
    kernels = all_kernels()

    def expected(u, backward: bool):
        """Per forward: flash once (mid_attn), GroupNorm twice per
        ResnetBlock3D (27 / 33 blocks); a checkpointed block runs its
        forward again in the backward."""
        blocks = {1: 27, 2: 33}[u]
        recompute = backward and cfg[f"unet{u}"].get("checkpoint_during_training", False)
        return {"flash_mqa_fwd": 1, "flash_mqa_bwd": int(backward),
                "groupnorm_film_silu_fwd": 2 * blocks * (2 if recompute else 1),
                "groupnorm_film_silu_bwd": 2 * blocks * int(backward),
                "cross_attention_fwd": 0}

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
            raise AssertionError(f"train: launches {got}, the unet structure predicts {want}")
        return out, ms, got

    as_dev = lambda a: torch.as_tensor(a, device=dev)
    totals = {k.name: 0 for k in kernels}
    ms = {1: [], 2: []}
    for step in range(TRAIN_STEPS):
        batch = data.batch_items(np.arange(step * b, (step + 1) * b))
        vid, emb = as_dev(batch["videos"]), as_dev(batch["video_embeds"])
        for u in (1, 2):
            loss, t_ms, got = run(lambda: trainer.train_step(vid, video_embed=emb, unet_number=u),
                                  expected(u, backward=True))
            loss = float(loss)
            if not np.isfinite(loss):
                raise AssertionError(f"train: unet {u} step {step} loss {loss}")
            ms[u].append(t_ms)
            for k, v in got.items():
                totals[k] += v
            log(f"train: step {step} unet {u}: loss {loss:.4f}, {t_ms:.1f} ms")
    batch = data.batch_items(np.arange(TRAIN_STEPS * b, (TRAIN_STEPS + 1) * b))
    vid, emb = as_dev(batch["videos"]), as_dev(batch["video_embeds"])
    for u in (1, 2):
        val, t_ms, _ = run(lambda: trainer.eval_loss(vid, video_embed=emb, unet_number=u),
                           expected(u, backward=False))
        if not np.isfinite(float(val)):
            raise AssertionError(f"train: unet {u} eval loss {float(val)}")
        log(f"train: eval_loss unet {u}: {float(val):.4f}, {t_ms:.1f} ms")
    peak = torch.cuda.max_memory_allocated() / 2**30

    if trainer.steps != [TRAIN_STEPS] * 2 or [e.step for e in trainer.ema] != [TRAIN_STEPS] * 2:
        raise AssertionError(f"train: steps {trainer.steps}, EMA steps "
                             f"{[e.step for e in trainer.ema]}")
    for i in range(2):
        still = [k for k, p in trainer.params(i).items() if torch.equal(p.detach(), start[i][k])]
        if still:
            raise AssertionError(f"train: unet {i + 1} params that never moved: {still[:5]}")
    with tempfile.TemporaryDirectory() as tmp:
        state = trainer.state_dict()
        t = time.time()
        save_checkpoint(str(Path(tmp) / "ckpt"), state)
        _same_state(state, load_checkpoint(str(Path(tmp) / "ckpt"), map_location=dev))
        log(f"train: checkpoint save -> load round trip equal ({time.time() - t:.1f} s)")

    steady = {u: sum(ms[u][1:]) / max(len(ms[u]) - 1, 1) for u in (1, 2)}
    log(f"train: ms per step (first, then mean of the rest): unet 1 {ms[1][0]:.1f} / "
        f"{steady[1]:.1f}, unet 2 {ms[2][0]:.1f} / {steady[2]:.1f}; samples/s unet 1 "
        f"{b / steady[1] * 1e3:.2f}, unet 2 {b / steady[2] * 1e3:.2f}, both "
        f"{b / (steady[1] + steady[2]) * 1e3:.2f}; peak memory {peak:.2f} GiB")
    log(f"train: launches over {TRAIN_STEPS} + {TRAIN_STEPS} steps {totals}")
    if profile:
        batch = data.batch_items(np.arange(b))
        vid, emb = as_dev(batch["videos"]), as_dev(batch["video_embeds"])
        for u in (1, 2):
            profile_device(f"train step unet {u}", torch, lambda: trainer.train_step(
                vid, video_embed=emb, unet_number=u))
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
    groups = {"flash_mqa_fwd": ("flash_mqa_fwd",),
              "flash_mqa_bwd": ("flash_mqa_bwd",),
              "groupnorm_film_silu_fwd": ("gn_stats_kernel", "gn_apply_kernel"),
              "groupnorm_film_silu_bwd": ("gn_bwd_",),
              "cross_attention_fwd": ("cross_attention_kernel",),
              "convolution (cuDNN / cutlass)": ("cudnn", "conv2d", "xmma_fprop", "implicit_gemm",
                                                "convolve", "dgrad", "wgrad")}
    for name, pats in groups.items():
        ms = sum(r[0] for r in rows if any(p in r[2] for p in pats))
        log(f"  {name}: {ms:.2f} ms ({100 * ms / max(total, 1e-9):.1f}% of device time)")


def profile_request(cfg, dev, torch, steps: int):
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
        log(f"profile: 1 request, {steps} DDIM steps per stage: text tower {t_text:.1f} ms, "
            f"prior ({cfg['prior']['sample_timesteps']} DDIM steps, best-of-2) {t_prior:.1f} ms, "
            f"stage 1 (64 px) "
            f"{t_s0:.1f} ms = {t_s0 / steps:.1f} ms/step, stage 2 (128 px) {t_s1:.1f} ms "
            f"= {t_s1 / steps:.1f} ms/step")
        profile_device("cascade", torch, lambda: dec.sample(
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

    rows = check_backward_kernels(dev, torch, check_kernels(dev, torch))
    check_modules(dev, torch)
    check_module_grads(dev, torch)
    served = serve(dev, torch, args.profile)
    trained = train(dev, torch, args.profile)

    out = []
    for k in _cuda.all_kernels():
        r = rows[k.name]
        # launches: the training run where the kernel is on that path, else
        # the serving run; both runs' counts beside it
        out.append({"name": k.name, "route": "cuda",
                    "source": f"dalle2_video_tpu_torch/csrc/{k.source}",
                    "replaces": k.replaces,
                    "launches": trained[k.name] or served.get(k.name, 0),
                    "launches_by_run": {"serve": served.get(k.name, 0),
                                        "train": trained[k.name]},
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    "check": "ok", "tolerance": r["tolerance"], "shape": r["shape"]})
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
