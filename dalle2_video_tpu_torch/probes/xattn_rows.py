"""Row 5 -- the cross-attention forward (``d2v_cross_attention_fwd``) --
timed at every shape the serving paths give it, beside SDPA, from any
checkout of this repository:

    python dalle2_video_tpu_torch/probes/xattn_rows.py [--root DIR] [--text]

``--root`` (default: this checkout) is put first on the import path, so
the same shapes time another tree's kernel (a parent commit unpacked
beside this one): compare two trees in turns within one call. For each CFG
batch in BATCHES, one ``RESULT {json}`` line per shape with the device times
(CUDA events, ``probes.time_ms``), its bound and the card, then one line
with the sum over one DDIM step's calls beside that step's bound; all
appended to ``runs/torch_xattn_rows.jsonl``. ``--text`` times the shapes of
serving with text encodings and per-frame embeds (TEXT_SITES) instead.

The serving paths' cross-attention sites live here (``chip_smoke.py`` and
the card tests import them): every conditioned ResnetBlock3D of the
full-width celebv_text unets at the 90-frame recipe, q (B, n, 8, 64) against
m context keys (unet 1: 2 time tokens, 4 video-embed tokens and the null kv;
unet 2: 2 time tokens and the null kv), counted by routing both unets on
meta tensors, at the CFG batch B of a group of one or two requests. With
text encodings (``max_text_len`` 256) the two middle blocks of each unet
also attend to the 256 text tokens, and with per-frame embeds of 90 frames
unet 1 has one video token a frame in place of the 4 (``TEXT_REQUESTS``).
So does the bf16 check both hold the kernel with (``hold_bf16``). The rows
also carry the wrapper's host time per call (``host_us``, at the smallest
shape).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter
from pathlib import Path

FRAMES = 90
HEADS, DIM_HEAD = 8, 64
# the CFG-doubled batch of a group of 1 or 2 requests (the serving engine's
# buckets (1, 2) in chip_smoke.py)
BATCHES = (2, 4)
# (unet, tokens n, context keys m, sites per forward)
SERVE_SITES = [(1, FRAMES * 32 * 32, 7, 5), (1, FRAMES * 16 * 16, 7, 5),
               (1, FRAMES * 8 * 8, 7, 7),
               (2, FRAMES * 64 * 64, 3, 5), (2, FRAMES * 32 * 32, 3, 5),
               (2, FRAMES * 16 * 16, 3, 5), (2, FRAMES * 8 * 8, 3, 7)]
# serving with text encodings (serve_text): the same sites, the middle
# blocks' two at 1 + 2 + (4 video tokens | 90 frame tokens) + 256 text
# tokens; request "a" a global video embed, "b" per-frame embeds of 90
# frames (unet 1 only: the SR unet takes no video embed)
TEXT_LEN = 256
TEXT_REQUESTS = {
    "a": [(1, FRAMES * 32 * 32, 7, 5), (1, FRAMES * 16 * 16, 7, 5), (1, FRAMES * 8 * 8, 7, 5),
          (1, FRAMES * 8 * 8, 7 + TEXT_LEN, 2)],
    "b": [(1, FRAMES * 32 * 32, 3 + FRAMES, 5), (1, FRAMES * 16 * 16, 3 + FRAMES, 5),
          (1, FRAMES * 8 * 8, 3 + FRAMES, 5), (1, FRAMES * 8 * 8, 3 + FRAMES + TEXT_LEN, 2)],
}
TEXT_UNET2 = [(2, FRAMES * 64 * 64, 3, 5), (2, FRAMES * 32 * 32, 3, 5),
              (2, FRAMES * 16 * 16, 3, 5), (2, FRAMES * 8 * 8, 3, 5),
              (2, FRAMES * 8 * 8, 3 + TEXT_LEN, 2)]
for _r in TEXT_REQUESTS.values():
    _r.extend(TEXT_UNET2)
# every distinct (unet, n, m, sites) of the two requests
TEXT_SITES = sorted({s for r in TEXT_REQUESTS.values() for s in r})
# context lengths the checks hold the kernel at: the short route's edge
# (16), one past it, the tile edges, the serve_text lengths, two staged
# chunks (1000, past the kernel's 512-key chunk); most not multiples of 8
LONG_MS = (16, 17, 32, 33, 93, 259, 263, 349, 1000)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
EXP_PER_S = 132 * 16 * 1.98e9


def serve_shapes(batch: int) -> Counter:
    """{(batch, n, h, d, m): calls per DDIM step} of one group at CFG batch
    ``batch`` on the serving paths (serve, serve_conv)."""
    return Counter({(batch, n, HEADS, DIM_HEAD, m): sites for _, n, m, sites in SERVE_SITES})


def text_shapes(batch: int, request: str) -> Counter:
    """The same for one serve_text request ("a" or "b", TEXT_REQUESTS)."""
    out = Counter()
    for _, n, m, sites in TEXT_REQUESTS[request]:
        out[(batch, n, HEADS, DIM_HEAD, m)] += sites
    return out


def sites_per_step() -> int:
    """Cross-attention launches per DDIM step of one group (both unets)."""
    return sum(s[3] for s in SERVE_SITES)


def bound(b: int, n: int, h: int, d: int, m: int):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate (read q, k, v once, write out once, bf16) and the
    operations over their peak rates -- the two products (4 m d flops a
    (token, head) row) at the bf16 tensor-core rate, or the m exponentials a
    row at the special-function units' rate (132 SMs x 16 a clock x 1.98
    GHz), whichever is slower. At m <= 16 the bytes bound it; at m in the
    hundreds the three come level."""
    t = {"bytes": 2.0 * (2 * b * n * h * d + 2 * b * m * h * d) / HBM_BYTES_PER_S,
         "operations": max(4.0 * b * n * h * m * d / BF16_FLOP_PER_S,
                           1.0 * b * n * h * m / EXP_PER_S)}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


# Row 5's bf16 check (hold_bf16). Kernel and plain version compute the JAX
# kernel's function in f32 in two orders, so their probabilities agree up to
# f32 roundings before p is rounded to bf16. A p that sits that close to a
# bf16 rounding midpoint may round either way; one such flip moves an output
# by one bf16 step of p times |v| at that key, which near a zero output
# exceeds the standing tolerance. NEAR_MIDPOINT (relative to p) is more
# than three times the f32 error of p that the plain version's order leaves
# against f64 at the serving widths (tests/test_torch_port_kernels.py holds
# it there); only keys whose f64 p lies that close to a midpoint earn the
# flip. MAX_SHARE and ORACLE_MARGIN are about ten times the shares
# measured on an H100 at the serving shapes (at most 0.0035% differing,
# 0.0047% from the oracle), and never less than one (token, head) row's d
# values, which one flip can move. They were set at the short route's
# contexts (m <= LIMIT_KEYS); a row's chance to hold a key that flips grows
# with its keys, so past LIMIT_KEYS both grow in proportion to m (on an
# H100 at m = 259: 0.063% differing, the kernel 0.0552% from the oracle and
# the plain version 0.0481%, against 30.5% of the rows holding a key near a
# midpoint).
NEAR_MIDPOINT = 2.0**-18
MAX_SHARE = 5e-4
ORACLE_MARGIN = 5e-4
LIMIT_KEYS = 16
ORACLE_ROWS = 2048  # tokens held to the f64 oracle
SLAB = 1 << 15  # tokens a slab of the check


def flip_allowance(q, k, v, sm_scale: float):
    """(b, n, h, d): the sum over the keys whose f64 p lies within
    NEAR_MIDPOINT of a bf16 rounding midpoint of one bf16 step of p times
    |v| at that key, what such flips may move each output by; and the
    number of (token, head) rows with such a key."""
    import torch

    s = torch.einsum("bnhd,bmhd->bnhm", q.double(), k.double()) * sm_scale
    p = torch.softmax(s, -1)
    _, e = torch.frexp(p)
    step = torch.ldexp(torch.ones_like(p), e - 8)  # bf16: 8 significant bits
    frac = p / step
    near = (frac - frac.floor() - 0.5).abs() * step <= NEAR_MIDPOINT * p
    allow = torch.einsum("bnhm,bmhd->bnhd", torch.where(near, step, 0.0), v.double().abs())
    return allow.float(), int(near.any(-1).sum())


def _steps(out, ref, slack):
    """Per value: |out - ref| less ``slack``, in bf16 steps of the larger
    value taken at no less than the row's largest |value|."""
    import torch

    scale = torch.maximum(torch.maximum(out.abs(), ref.abs()), ref.abs().amax(-1, keepdim=True))
    _, e = torch.frexp(scale)
    return ((out - ref).abs() - slack).clamp_min(0) / torch.ldexp(torch.ones_like(scale), e - 8)


def hold_bf16(out, ref, q, k, v, sm_scale: float, oracle_rows: int = ORACLE_ROWS) -> dict:
    """Holds the bf16 kernel's ``out`` to the plain version's ``ref``
    (``fused_cross_attention_reference``) on the inputs q, k, v; raises
    AssertionError at the first check that fails. Per value: |out - ref| <=
    1e-3 + 1e-2 |ref| + the flips its row's probabilities may take
    (flip_allowance), and at most one bf16 step of the row's scale besides
    those flips. At most MAX_SHARE of the values differ, and on the leading
    ``oracle_rows`` tokens the kernel's share differing from the f64 oracle
    is at most the plain version's + ORACLE_MARGIN (both shares floored at
    one row's d values, and times m / LIMIT_KEYS past LIMIT_KEYS keys).
    Returns the numbers and the tolerance's text."""
    import torch

    from dalle2_video_tpu_torch.ops.cross_attention import fused_cross_attention_reference

    b, n, h, d = out.shape
    m = k.shape[1]
    per_keys = max(1.0, m / LIMIT_KEYS)
    max_share, margin = MAX_SHARE * per_keys, ORACLE_MARGIN * per_keys
    floor = d / out.numel()
    err = worst = steps = 0.0
    differ = flagged = 0
    for t in range(0, n, SLAB):
        sl = slice(t, t + SLAB)
        o, r = out[:, sl].float(), ref[:, sl].float()
        allow, rows = flip_allowance(q[:, sl], k, v, sm_scale)
        flagged += rows
        diff = (o - r).abs()
        err = max(err, float(diff.max()))
        worst = max(worst, float((diff / (1e-3 + 1e-2 * r.abs() + allow)).max()))
        steps = max(steps, float(_steps(o, r, allow).max()))
        differ += int((o != r).sum())
        del o, r, allow, diff
    share = differ / out.numel()
    rows = min(oracle_rows, n)
    oracle = fused_cross_attention_reference(q[:, :rows], k, v, sm_scale, work=torch.float64)
    kern_o = float((out[:, :rows] != oracle).float().mean())
    plain_o = float((ref[:, :rows] != oracle).float().mean())
    res = dict(max_abs_err=err, worst_share=worst, steps=steps, share=share,
               flagged_rows=flagged / (b * n * h), oracle_share=kern_o, plain_oracle_share=plain_o,
               tolerance=f"1e-3 + 1e-2*|ref| + p flips within {NEAR_MIDPOINT:g} of a bf16 "
                         f"midpoint, <= 1 bf16 step besides, share <= {max_share:g}, oracle "
                         f"share <= plain's + {margin:g}")
    text = (f"max_abs_err {err:.3e}, worst share of the tolerance {worst:.3f}, {steps:.2f} "
            f"bf16 steps, {100 * share:.4f}% differ, {100 * res['flagged_rows']:.4f}% of rows "
            f"near a midpoint, from the f64 oracle {100 * kern_o:.4f}% (plain "
            f"{100 * plain_o:.4f}%)")
    res["text"] = text
    if not worst <= 1.0:
        raise AssertionError(f"beyond the tolerance: {text}")
    if steps > 1.0:
        raise AssertionError(f"beyond one bf16 step: {text}")
    if share > max(max_share, floor):
        raise AssertionError(f"too many values differ: {text}")
    if kern_o > plain_o + max(margin, d / oracle.numel()):
        raise AssertionError(f"farther from the f64 oracle than the plain version: {text}")
    return res


def host_us(fn, iters: int = 200) -> float:
    """The host's time per call of ``fn``, in microseconds: the calls are
    enqueued behind a ~50 ms spin kernel, so none waits for the card."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="row 5 at the serving paths' shapes")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose kernel is timed (default: this one)")
    ap.add_argument("--text", action="store_true",
                    help="serve_text's shapes (TEXT_SITES) in place of SERVE_SITES")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from dalle2_video_tpu_torch.ops import cross_attention as xa
    from dalle2_video_tpu_torch.probes import card_line, time_ms
    from dalle2_video_tpu_torch.utils.device import resolve_device

    if not xa.__file__.startswith(root):
        raise SystemExit(f"xattn_rows: imported {xa.__file__}, not the checkout at {root}")
    dev = resolve_device("cuda")
    card = card_line()
    g = torch.Generator(device=dev).manual_seed(0)
    sites_of = TEXT_SITES if args.text else SERVE_SITES
    # the DDIM steps summed: one per request of serve_text, else the serving paths'
    steps_of = ({f"request {r}": sites for r, sites in TEXT_REQUESTS.items()} if args.text
                else {"serving": SERVE_SITES})
    records = []
    for b in BATCHES:
        by_site = {}
        for unet, n, m, sites in sites_of:
            h, d = HEADS, DIM_HEAD
            q = torch.randn(b, n, h, d, generator=g, device=dev).to(torch.bfloat16)
            k, v = (torch.randn(b, m, h, d, generator=g, device=dev).to(q.dtype) for _ in range(2))
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            run = lambda: xa.cross_attention(q, k, v, sm_scale=d**-0.5)  # noqa: E731
            bnd, by = bound(b, n, h, d, m)
            rec = by_site[(unet, n, m, sites)] = {
                "kernel": "cross_attention_fwd", "unet": unet, "shape": [b, n, h, d, m],
                "sites": sites, "root": root, "card": card, "ms": time_ms(run),
                "sdpa_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
                "bound_ms": bnd, "bound_by": by}
            if b == BATCHES[0] and n == min(s[1] for s in sites_of):
                rec["host_us"] = host_us(run)
            print("RESULT", json.dumps(rec), flush=True)
            records.append(rec)
            del q, k, v, qt, kt, vt
        for label, sites in steps_of.items():
            step = {key: sum(s[3] * by_site[s][key] for s in sites)
                    for key in ("ms", "sdpa_ms", "bound_ms")}
            rec = {"kernel": "cross_attention_fwd", "batch": b, "step": label,
                   "per_ddim_step": sum(s[3] for s in sites), "root": root, "card": card,
                   **step}
            print("RESULT", json.dumps(rec), flush=True)
            records.append(rec)
    os.makedirs("runs", exist_ok=True)
    with open("runs/torch_xattn_rows.jsonl", "a") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
