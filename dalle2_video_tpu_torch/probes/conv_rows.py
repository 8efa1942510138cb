"""Rows 6 and 8 -- the bf16 3x3 conv (``d2v_conv3x3``) and the conv + bias
+ statistics of the fused Block3D (``d2v_conv3x3_bias_stats``) -- timed at
every shape the conv paths give them, beside cuDNN's conv, from any
checkout of this repository:

    python dalle2_video_tpu_torch/probes/conv_rows.py [--root DIR]

``--root`` (default: this checkout) is put first on the import path, so
the same shapes time another tree's kernels (a parent commit unpacked
beside this one): compare two trees in turns within one call. One ``RESULT
{json}`` line per (kernel, shape) with the device times (CUDA events,
``probes.time_ms``), the card and the plan where the tree has one,
appended to ``runs/torch_conv_rows.jsonl``.

The conv paths' sites live here (``chip_smoke.py`` imports them): the
fused Block3D's (H, W, C, Co) per unet at the celebv_text recipe, and unet
1's seven ``pallas_small`` convs.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path
from typing import Dict, Iterable, Set, Tuple

FRAMES = 90  # per batch row, the 90-frame recipe
TRAIN_BT = 2 * FRAMES  # train_conv: batch 2
FUSED_SITES = {
    1: [(64, 64, 64, 64), (64, 64, 128, 64), (32, 32, 64, 64), (32, 32, 128, 128),
        (32, 32, 192, 128), (16, 16, 128, 128), (16, 16, 256, 256), (16, 16, 384, 256),
        (8, 8, 256, 256)],
    2: [(16, 16, 64, 64), (8, 8, 64, 64), (8, 8, 128, 128), (8, 8, 192, 128)],
}
SMALL_SITES = [(8, 8, 512, 512)]
KERNELS = ("conv3x3", "conv3x3_wgrad", "conv3x3_bias_stats")


def conv_path_shapes(path: str, bts: Iterable[int] = (TRAIN_BT,)) -> Dict[str, Set[Tuple]]:
    """The shapes each conv kernel takes on a path's run at B*T = `bts`
    frames (a serve_conv group of k requests is CFG batch 2k, 180k
    frames): train_conv's forward (row 8 in its batch rows), dx (row 6 on
    the fused sites' dy, H, W, Co -> C) and weight gradient, the
    pallas_small forwards (row 6); serve_conv's forwards; none elsewhere.
    Keys: conv3x3 (x's shape, Co), conv3x3_wgrad (x's shape, Co),
    conv3x3_bias_stats (x's shape, Co, batch rows)."""
    sites = [st for stages in FUSED_SITES.values() for st in stages]
    out = {k: set() for k in KERNELS}
    if path not in ("train_conv", "serve_conv"):
        return out
    for bt in bts:
        out["conv3x3_bias_stats"] |= {(bt, *st, bt // FRAMES) for st in sites}
        out["conv3x3"] |= {(bt, *st) for st in SMALL_SITES}
        if path == "train_conv":
            out["conv3x3"] |= {(bt, h, w, co, c) for h, w, c, co in sites}
            out["conv3x3_wgrad"] |= {(bt, *st) for st in sites}
    return out


def all_shapes() -> Dict[str, Set[Tuple]]:
    """Every shape of train_conv (batch 2) and serve_conv (groups of 1 and
    2 requests)."""
    train, serve = conv_path_shapes("train_conv"), conv_path_shapes("serve_conv", (180, 360))
    return {k: train[k] | serve[k] for k in KERNELS}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="rows 6 and 8 at the conv paths' shapes")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose kernels are timed (default: this one)")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from dalle2_video_tpu_torch.ops import fused_block as fb
    from dalle2_video_tpu_torch.ops import spatial_conv as sc
    from dalle2_video_tpu_torch.probes import card_line, time_ms
    from dalle2_video_tpu_torch.utils.device import resolve_device

    if not sc.__file__.startswith(root):
        raise SystemExit(f"conv_rows: imported {sc.__file__}, not the checkout at {root}")
    dev = resolve_device("cuda")
    card = card_line()
    g = torch.Generator(device=dev).manual_seed(0)
    plan = getattr(sc, "conv_plan", None)
    shapes = all_shapes()
    records = []
    for name in ("conv3x3", "conv3x3_bias_stats"):
        for shape in sorted(shapes[name]):
            n, h, w, c, co = shape[:5]
            x = torch.randn(n, h, w, c, generator=g, device=dev).to(torch.bfloat16)
            wt = (torch.randn(co, c, 3, 3, generator=g, device=dev) / math.sqrt(9 * c)).to(x.dtype)
            if name == "conv3x3":
                run = lambda: sc.conv3x3(x, wt)  # noqa: E731
            else:
                bias = torch.randn(co, generator=g, device=dev)
                run = lambda: fb.conv_bias_stats(x, wt, bias, shape[5])  # noqa: E731
            xc, wc = x.permute(0, 3, 1, 2), wt.contiguous(memory_format=torch.channels_last)
            rec = {"kernel": name, "shape": shape, "root": root, "card": card, "ms": time_ms(run),
                   "cudnn_conv_ms": time_ms(lambda: F.conv2d(xc, wc, padding=1)),
                   "plan": list(plan(*shape)) if plan else None}
            print("RESULT", json.dumps(rec), flush=True)
            records.append(rec)
            del x, wt, xc, wc
    os.makedirs("runs", exist_ok=True)
    with open("runs/torch_conv_rows.jsonl", "a") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
