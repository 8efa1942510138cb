"""Rows 3, 4 and 9 -- the GroupNorm -> FiLM -> SiLU forward
(``d2v_groupnorm_film_silu_fwd``), its backward
(``d2v_groupnorm_film_silu_bwd``) and the fused Block3D's GroupNorm backward
(row 4's kernel under ``fused_block_gn_bwd``) -- at every shape the main
paths give them, from any checkout of this repository:

    python dalle2_video_tpu_torch/probes/gn_rows.py [--root DIR] [--measure]

``--root`` (default: this checkout) is put first on the import path, so
the same shapes time another tree's kernels (a parent commit unpacked
beside this one): compare two trees in turns within one call. One ``RESULT
{json}`` line per (kernel, batch, shape) with the device time (CUDA events,
``probes.time_ms``), its byte bound, its calls per step on each path and
the card; then row 3 summed over one serve DDIM step at each CFG batch
beside that step's bound. ``--measure`` adds, per shape, how far the kernel
is from this checkout's plain version and from the f64 oracle
(``measure_fwd`` / ``measure_bwd``) on well-conditioned inputs, and at
MEAN30_SHAPES on inputs of mean 30 and spread 1, with the verdict of this
checkout's hold on each (``hold_fwd`` / ``hold_bwd``: "FAILS: ..." where
the tree's kernel does not pass it). All appended to
``runs/torch_gn_rows.jsonl``.

The map lives here (``chip_smoke.py`` and the card tests import it): the
sites are counted by routing the full-width celebv_text unets at the
90-frame recipe on meta tensors -- ``groupnorm_film_silu`` at
``groupnorm_impl: pallas`` (rows 3 and 4: each site once per forward and,
in training, once per backward), ``fused_block3d`` at ``groupnorm_impl:
fused`` (row 9: once per fused site per backward) -- at the CFG batch of a
group of one or two requests (serve) and at train's batch 2. So do the
checks both hold the kernels with (``hold_fwd``, ``hold_bwd``).
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import sys
from collections import Counter
from pathlib import Path
from typing import Dict, Tuple

FRAMES = 90
SERVE_BATCHES = (2, 4)  # the CFG batch of a group of 1 or 2 requests
TRAIN_BATCH = 2
GROUPS = 8
EPS = 1e-5
HBM_BYTES_PER_S = 3.35e12
FWD, BWD, ROW9 = "groupnorm_film_silu_fwd", "groupnorm_film_silu_bwd", "fused_block_gn_bwd"


# ------------------------------------------------------------------ the map
def _count(ucfg, frames: int, size: int):
    """One forward of a unet of config ``ucfg`` on meta tensors at
    (1, frames, size, size, channels): (Counter{(L, C, G): GroupNorm sites}
    -- the groupnorm_film_silu calls, or the fused_block3d calls (L = T H
    W, C = Co) --, Counter{(n, h, d, m): cross-attention sites})."""
    from unittest import mock

    import torch

    from dalle2_video_tpu_torch.models import layers
    from dalle2_video_tpu_torch.models.unet3d import UNet3D

    with torch.device("meta"):
        unet = UNet3D(ucfg).to(torch.bfloat16)
    seen, xattn = Counter(), Counter()

    def gn_site(x, gamma, beta, scale, shift, groups, eps):
        seen[(x.shape[1], x.shape[2], groups)] += 1
        return torch.empty_like(x)

    def fused_site(x, w, bias, gamma, beta, scale, shift, groups, eps):
        b, t, h, wd, _ = x.shape
        seen[(t * h * wd, w.shape[0], groups)] += 1
        return x.new_empty(b, t, h, wd, w.shape[0])

    def conv_site(x, w):
        return x.new_empty(*x.shape[:-1], w.shape[0])

    def xattn_site(q, k, v, **_):
        xattn[(*q.shape[1:], k.shape[1])] += 1
        return torch.empty_like(q)

    x = torch.empty(1, frames, size, size, ucfg.channels, device="meta", dtype=torch.bfloat16)
    kw = {}
    if ucfg.cond_on_video_embeds:
        kw["video_embed"] = torch.empty(1, ucfg.video_embed_dim, device="meta",
                                        dtype=torch.bfloat16)
    if ucfg.lowres_cond:
        kw["lowres_cond_video"] = torch.empty_like(x)
    if ucfg.lowres_noise_cond:
        kw["lowres_noise_level"] = torch.zeros(1, dtype=torch.long, device="meta")
    with mock.patch.object(layers, "groupnorm_film_silu", gn_site), \
            mock.patch.object(layers, "fused_block3d", fused_site), \
            mock.patch.object(layers, "conv3x3_spatial_xbwd", conv_site), \
            mock.patch.object(layers, "cross_attention", xattn_site), \
            mock.patch.object(layers, "groupnorm_film_silu_as_jax",
                              lambda x, *a, **k: torch.empty_like(x)), \
            torch.no_grad():
        unet(x, torch.zeros(1, dtype=torch.long, device="meta"), **kw)
    return seen, xattn


@functools.lru_cache(maxsize=None)
def sites(impl: str) -> Dict[int, Counter]:
    """{unet: Counter{(L, C, G): sites per forward}} of the full-width
    celebv_text unets at 90 frames: the groupnorm_film_silu calls at
    ``impl`` "pallas", the fused_block3d calls (L = T H W, C = Co) at
    "fused"."""
    from unittest import mock

    import torch

    from dalle2_video_tpu_torch.engine import decoder
    from dalle2_video_tpu_torch.utils.config import load_config

    knobs = {"pallas": ["groupnorm_impl=pallas"],
             "fused": ["groupnorm_impl=fused", "spatial_conv_impl=pallas_small"]}[impl]
    cfg = load_config(None, [f"frame_numbers=[{FRAMES},{FRAMES}]",
                             *(f"unet{u}.{k}" for u in (1, 2) for k in knobs)])
    with mock.patch.object(decoder, "UNet3D", lambda c: torch.nn.Identity()):
        cfgs = decoder.build_decoder(cfg, "cpu").unet_configs
    return {u: _count(ucfg, FRAMES, size)[0]
            for u, (ucfg, size) in enumerate(zip(cfgs, cfg["frame_sizes"]), start=1)}


# The latent stage (chip_smoke.py's "latent"): scripts/train_latent90.py's
# unet (engine/decoder.py::latent90_decoder) on 90 x 32 x 32 x 4 latents at
# celebv_text's kernel settings, trained at TRAIN_BATCH and sampled at the
# CFG batch of one request (LATENT_SERVE_BATCH); its unet key is "latent"
LATENT = "latent"
LATENT_SERVE_BATCH = 2
LATENT_GRID = 32


@functools.lru_cache(maxsize=None)
def latent_sites():
    """(GroupNorm sites (L, C, G), cross-attention sites (n, h, d, m)) of
    one forward of the latent recipe's unet at ``groupnorm_impl: pallas``
    and ``cross_attention_impl: flash``."""
    from unittest import mock

    import torch

    from dalle2_video_tpu_torch.engine import decoder
    from dalle2_video_tpu_torch.models.vqvae import VQVAE

    with mock.patch.object(decoder, "UNet3D", lambda c: torch.nn.Identity()):
        dec = decoder.latent90_decoder(VQVAE(base_dim=8, device="cpu"), "cpu",
                                       attention_impl="auto", groupnorm_impl="pallas",
                                       cross_attention_impl="flash")
    return _count(dec.unet_configs[0], FRAMES, LATENT_GRID)


def calls(kernel: str, batch: int, unet) -> Counter:
    """{(batch, L, C, G): launches} of ``kernel`` in one forward (FWD) or
    one backward (BWD, ROW9) of ``unet`` (1, 2 or LATENT) at ``batch``."""
    if unet == LATENT:
        per = latent_sites()[0]
    else:
        per = sites("fused" if kernel == ROW9 else "pallas")[unet]
    return Counter({(batch, *key): n for key, n in per.items()})


def serve_step(batch: int) -> Counter:
    """Row 3's launches by (batch, L, C, G) in one DDIM step of a serve
    group at CFG batch ``batch`` (one forward of each unet)."""
    return calls(FWD, batch, 1) + calls(FWD, batch, 2)


def all_shapes() -> Dict[str, Tuple]:
    """Every (batch, L, C, G) each kernel takes on the paths: row 3 on
    serve (SERVE_BATCHES) and train (TRAIN_BATCH), row 4 on train, row 9
    on train_conv; rows 3 and 4 on the latent stage (its training and
    sampling batches)."""
    fwd = set()
    for b in {*SERVE_BATCHES, TRAIN_BATCH}:
        fwd |= set(serve_step(b))
    for b in {LATENT_SERVE_BATCH, TRAIN_BATCH}:
        fwd |= set(calls(FWD, b, LATENT))
    bwd = set(calls(BWD, TRAIN_BATCH, 1) + calls(BWD, TRAIN_BATCH, 2)
              + calls(BWD, TRAIN_BATCH, LATENT))
    row9 = set(calls(ROW9, TRAIN_BATCH, 1) + calls(ROW9, TRAIN_BATCH, 2))
    return {FWD: tuple(sorted(fwd)), BWD: tuple(sorted(bwd)), ROW9: tuple(sorted(row9))}


def bound_ms(kernel: str, b: int, l: int, c: int) -> float:
    """Bytes over the card's memory rate, bf16: the forward reads x and
    writes y, the backward reads x and g and writes dx (the (B, C) vectors
    are below 0.1% of it)."""
    return (2 if kernel == FWD else 3) * 2.0 * b * l * c / HBM_BYTES_PER_S * 1e3


# --------------------------------------------------------------- the holds
# Rows 3, 4 and 9 compute the JAX kernels' function: one-pass f32 group
# statistics (sums of x and x^2, var = E[x^2] - mean^2), then elementwise
# math in f32 rounded once to bf16. The plain versions compute the same
# function with the sums in the JAX kernel's block order, the kernels in
# their own fixed order. The two agree up to f32 roundings, so a bf16
# output differs only where its f32 value lies within such a rounding of a
# bf16 midpoint, by one step; steps are counted at the
# value or at STEP_FLOOR of its (batch, channel)'s largest |value|,
# whichever is larger (an f32 error is relative to the terms of z, not to a
# z that cancels to near 0). The bounds are set from what the kernels the
# one-launch design replaced (two launches per forward, three per
# backward) measured on an H100 at every mapped shape on ``inputs``' draws
# (PERF.md section 6): at most 0.0172% of values differing from the plain
# version (MAX_SHARE 0.025%), at most 0.0098 points further from the f64
# oracle (the plain version with work=torch.float64) than the plain
# version (ORACLE_MARGIN 0.02 points), mean within 4.4e-8 standard
# deviations and rstd within 1.8e-7 of the oracle's (STATS_TOL 1e-6), dA
# and dB within 3.7e-7 of the oracle's largest |value| (GRAD_TOL 2e-6).
# Inputs of mean 30 and spread 1 make the one-pass variance lose bits to
# cancellation: there every f32 one-pass implementation differs from the
# oracle in a share of the forward's values (the JAX kernel too); the
# forward is held at MEAN30_SHAPES to the replaced kernel's share there
# (MEAN30_BASELINE) plus MEAN30_MARGIN, the backward (given the forward's
# statistics) to the standing checks.
STEP_FLOOR = 2.0**-8
MAX_SHARE = 2.5e-4
ORACLE_MARGIN = 2e-4
STATS_TOL = 1e-6
GRAD_TOL = 2e-6
MEAN30_BASELINE = {(2, FRAMES * 128 * 128, 8): 0.00747554, (2, FRAMES * 64 * 64, 64): 0.01891361}
MEAN30_SHAPES = tuple(MEAN30_BASELINE)
MEAN30_MARGIN = 0.0025


def inputs(dev, b: int, l: int, c: int, kind: str = "normal", dtype=None, seed: int = 0):
    """x (b, l, c) and the FiLM parameters, as the kernels see them (bf16
    unless asked), from a generator seeded with ``seed`` (the same draws on
    every run at a shape): x = 2 randn + 0.3 ("normal") or 30 + randn
    ("mean30"); gamma 1 + 0.1 randn, beta, scale, shift 0.1 randn."""
    import torch

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    x = r(b, l, c) * 2 + 0.3 if kind == "normal" else r(b, l, c) + 30.0
    return (x.to(dtype), (1 + 0.1 * r(c)).to(dtype), (0.1 * r(c)).to(dtype),
            (0.1 * r(b, c)).to(dtype), (0.1 * r(b, c)).to(dtype))


def bf16_steps(out, ref):
    """Share of values that differ, and the largest difference in bf16
    steps of the larger of the two values, taken at no less than
    STEP_FLOOR of the (batch, channel)'s largest |ref| over L."""
    import torch

    out, ref = out.float(), ref.float()
    differ = out != ref
    if not bool(differ.any()):
        return 0.0, 0.0
    floor = STEP_FLOOR * ref.abs().amax(1, keepdim=True)
    scale = torch.maximum(torch.maximum(out.abs(), ref.abs()), floor)
    _, e = torch.frexp(scale)
    step = torch.ldexp(torch.ones_like(scale), e - 8)
    return float(differ.float().mean()), float(((out - ref).abs() / step)[differ].max())


def _share(a, b) -> float:
    return float((a != b).float().mean())


def _rel(got, want) -> float:
    """max |got - want| over max |want|, per batch row."""
    import torch

    got, want = got.double(), want.double()
    scale = want.abs().amax(-1, keepdim=True).clamp_min(torch.finfo(torch.float64).tiny)
    return float(((got - want).abs() / scale).max())


def measure_fwd(run, ref_mod, x, gamma, beta, scale, shift, groups: int = GROUPS) -> dict:
    """The kernel's forward ``run(x, gamma, beta, scale, shift, groups)`` ->
    (y, mean, rstd) against ``ref_mod``'s plain version and f64 oracle:
    shares that differ, bf16 steps, the statistics' errors."""
    import torch

    y, mean, rstd = run(x, gamma, beta, scale, shift, groups)
    ref = ref_mod.groupnorm_film_reference(x, gamma, beta, scale, shift, groups, EPS)
    oy, om, orstd = ref_mod.groupnorm_film_reference(x, gamma, beta, scale, shift, groups, EPS,
                                                     return_stats=True, work=torch.float64)
    share, steps = bf16_steps(y, ref)
    again = run(x, gamma, beta, scale, shift, groups)
    return dict(share=share, steps=steps, max_abs_err=float((y.float() - ref.float()).abs().max()),
                oracle_share=_share(y, oy), plain_oracle_share=_share(ref, oy),
                mean_err=float(((mean.double() - om).abs() * orstd).max()),
                rstd_err=float((rstd.double() / orstd - 1).abs().max()),
                finite=bool(torch.isfinite(y).all()),
                bit_equal=all(torch.equal(a, b_) for a, b_ in zip((y, mean, rstd), again)))


def measure_bwd(run, ref_mod, x, g, a_vec, b_vec, mean, rstd, groups: int = GROUPS) -> dict:
    """The kernel's backward ``run(x, g, a_vec, b_vec, mean, rstd, groups)``
    -> (dx, dA, dB) against ``ref_mod``'s plain version and f64 oracle."""
    import torch

    args = (x, g, a_vec, b_vec, mean, rstd, groups)
    dx, da, db = run(*args)
    rdx, rda, rdb = ref_mod.groupnorm_film_bwd_reference(*args)
    odx, oda, odb = ref_mod.groupnorm_film_bwd_reference(*args, work=torch.float64)
    share, steps = bf16_steps(dx, rdx)
    again = run(*args)
    return dict(share=share, steps=steps,
                max_abs_err=float((dx.float() - rdx.float()).abs().max()),
                oracle_share=_share(dx, odx), plain_oracle_share=_share(rdx, odx),
                da_err=_rel(da, oda), db_err=_rel(db, odb),
                plain_da_err=_rel(rda, oda), plain_db_err=_rel(rdb, odb),
                finite=bool(torch.isfinite(dx).all()),
                bit_equal=all(torch.equal(a, b_) for a, b_ in zip((dx, da, db), again)))


def _text(m: dict) -> str:
    keys = ("share", "oracle_share", "plain_oracle_share")
    return ", ".join([f"{k} {100 * m[k]:.4f}%" for k in keys]
                     + [f"{k} {v:.3g}" for k, v in m.items()
                        if k not in keys and not isinstance(v, bool)])


def hold_fwd(m: dict, kind: str = "normal", shape=None) -> str:
    """Raises AssertionError unless the forward's measures ``m``
    (measure_fwd) pass the hold for inputs of ``kind`` at ``shape`` (b, l,
    c); returns its text."""
    text = _text(m)
    if not (m["finite"] and m["bit_equal"]):
        raise AssertionError(f"not finite, or two calls differ: {text}")
    if kind == "mean30":
        limit = MEAN30_BASELINE[tuple(shape)] + MEAN30_MARGIN
        if m["oracle_share"] > limit:
            raise AssertionError(f"more than {100 * limit:.4f}% from the f64 oracle: {text}")
        return text
    if m["steps"] > 1.0 or m["share"] > MAX_SHARE:
        raise AssertionError(f"beyond one bf16 step or {MAX_SHARE} differing: {text}")
    if m["oracle_share"] > m["plain_oracle_share"] + ORACLE_MARGIN:
        raise AssertionError(f"farther from the f64 oracle than the plain version: {text}")
    if m["mean_err"] > STATS_TOL or m["rstd_err"] > STATS_TOL:
        raise AssertionError(f"mean / rstd beyond {STATS_TOL} of the oracle: {text}")
    return text


def hold_bwd(m: dict) -> str:
    """As hold_fwd for the backward's measures (measure_bwd), whatever the
    inputs."""
    text = _text(m)
    if not (m["finite"] and m["bit_equal"]):
        raise AssertionError(f"not finite, or two calls differ: {text}")
    if m["steps"] > 1.0 or m["share"] > MAX_SHARE:
        raise AssertionError(f"beyond one bf16 step or {MAX_SHARE} differing: {text}")
    if m["oracle_share"] > m["plain_oracle_share"] + ORACLE_MARGIN:
        raise AssertionError(f"farther from the f64 oracle than the plain version: {text}")
    if m["da_err"] > GRAD_TOL or m["db_err"] > GRAD_TOL:
        raise AssertionError(f"dA / dB beyond {GRAD_TOL} of the oracle: {text}")
    return text


def held(fn, *args, **kw) -> str:
    """``fn``'s text, or "FAILS: ..." where it raises (the probe records a
    hold's verdict on any tree without stopping)."""
    try:
        return fn(*args, **kw)
    except AssertionError as exc:
        return f"FAILS: {exc}"


def bwd_inputs(gn_mod, dev, b: int, l: int, c: int, kind: str = "normal", dtype=None,
               seed: int = 0):
    """(x, g, A, B, mean, rstd) of the backward: x and the FiLM parameters
    from ``inputs``, g = randn (seeded ``seed`` + 1), the statistics from
    the forward of ``gn_mod`` (the kernel's own, as the backward gets
    them)."""
    import torch

    x, gamma, beta, s_, t_ = inputs(dev, b, l, c, kind, dtype, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    gy = torch.randn(b, l, c, generator=gen, device=dev).to(x.dtype)
    _, mean, rstd = gn_mod.groupnorm_film_silu(x, gamma, beta, s_, t_, GROUPS, EPS,
                                               return_stats=True)
    a_vec, b_vec = gn_mod.fold_ab(gamma, beta, s_, t_, x.dtype, b)
    return x, gy, a_vec, b_vec, mean, rstd


# ------------------------------------------------------------------ the run
def _own_reference():
    """This checkout's ops/groupnorm_film.py (its plain versions and their
    f64 oracle), whichever tree ``--root`` imports the kernels from."""
    path = Path(__file__).resolve().parents[1] / "ops" / "groupnorm_film.py"
    spec = importlib.util.spec_from_file_location("d2v_gn_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="rows 3, 4 and 9 at the paths' shapes")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose kernels are timed (default: this one)")
    ap.add_argument("--measure", action="store_true",
                    help="also measure each kernel against the plain version and the oracle")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    shapes = all_shapes()  # this checkout's map, before --root shadows the package
    step_calls = {b: serve_step(b) for b in SERVE_BATCHES}
    train_calls = {k: calls(k, TRAIN_BATCH, 1) + calls(k, TRAIN_BATCH, 2) for k in (BWD, ROW9)}
    ref_mod = _own_reference()
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.startswith("dalle2_video_tpu_torch")]:
        del sys.modules[name]
    import torch

    from dalle2_video_tpu_torch.ops import fused_block as fb
    from dalle2_video_tpu_torch.ops import groupnorm_film as gn
    from dalle2_video_tpu_torch.probes import card_line, time_ms
    from dalle2_video_tpu_torch.utils.device import resolve_device

    if not gn.__file__.startswith(root):
        raise SystemExit(f"gn_rows: imported {gn.__file__}, not the checkout at {root}")
    dev = resolve_device("cuda")
    card = card_line()
    fwd_run = lambda *a: gn.groupnorm_film_silu(*a, EPS, return_stats=True)  # noqa: E731
    records = []

    def emit(rec):
        rec.update(root=root, card=card)
        print("RESULT", json.dumps(rec), flush=True)
        records.append(rec)

    fwd_ms = {}
    for b, l, c, groups in shapes[FWD]:
        x, gamma, beta, s_, t_ = inputs(dev, b, l, c)
        rec = {"kernel": FWD, "shape": [b, l, c, groups],
               "ms": time_ms(lambda: gn.groupnorm_film_silu(x, gamma, beta, s_, t_, groups)),
               "bound_ms": bound_ms(FWD, b, l, c),
               "serve_calls_per_step": step_calls.get(b, {}).get((b, l, c, groups), 0)}
        fwd_ms[(b, l, c, groups)] = rec["ms"]
        if args.measure:
            rec["normal"] = measure_fwd(fwd_run, ref_mod, x, gamma, beta, s_, t_, groups)
            rec["hold"] = held(hold_fwd, rec["normal"])
            if (b, l, c) in MEAN30_SHAPES:
                rec["mean30"] = measure_fwd(fwd_run, ref_mod,
                                            *inputs(dev, b, l, c, "mean30"), groups)
                rec["hold_mean30"] = held(hold_fwd, rec["mean30"], "mean30", (b, l, c))
        emit(rec)
        del x
        torch.cuda.empty_cache()
    for b in SERVE_BATCHES:
        emit({"kernel": FWD, "serve_step_batch": b, "calls": sum(step_calls[b].values()),
              "ms": sum(n * fwd_ms[key] for key, n in step_calls[b].items()),
              "bound_ms": sum(n * bound_ms(FWD, *key[:3]) for key, n in step_calls[b].items())})
    for kernel in (BWD, ROW9):
        entry = gn.BWD_KERNEL if kernel == BWD else fb.GN_BWD_KERNEL
        bwd_run = lambda *a: gn.groupnorm_film_bwd(*a, kernel=entry)  # noqa: E731
        for b, l, c, groups in shapes[kernel]:
            bargs = bwd_inputs(gn, dev, b, l, c)
            rec = {"kernel": kernel, "shape": [b, l, c, groups],
                   "ms": time_ms(lambda: bwd_run(*bargs, groups)),
                   "bound_ms": bound_ms(kernel, b, l, c),
                   "train_calls_per_step": train_calls[kernel][(b, l, c, groups)]}
            if args.measure:
                rec["normal"] = measure_bwd(bwd_run, ref_mod, *bargs, groups)
                rec["hold"] = held(hold_bwd, rec["normal"])
                if (b, l, c) in MEAN30_SHAPES:
                    rec["mean30"] = measure_bwd(
                        bwd_run, ref_mod, *bwd_inputs(gn, dev, b, l, c, "mean30"), groups)
                    rec["hold_mean30"] = held(hold_bwd, rec["mean30"])
            emit(rec)
            del bargs
            torch.cuda.empty_cache()
    os.makedirs("runs", exist_ok=True)
    with open("runs/torch_gn_rows.jsonl", "a") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
