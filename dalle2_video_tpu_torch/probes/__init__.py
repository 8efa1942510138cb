"""The flash-forward probes (port of scripts/perf_r3_probe8.py and
scripts/perf_r3_probe9.py), with the JAX file names:

    python -m dalle2_video_tpu_torch.probes.perf_r3_probe8
    python -m dalle2_video_tpu_torch.probes.perf_r3_probe9 [--check]

Each runs its rows at the JAX probes' geometry -- the 4-level SR unet's
joint bottleneck at 90 frames: B = 2, 23,040 tokens x 16 heads folded into
368,640 query rows, 23,041 keys (null kv first), d = 32, bf16 -- on inputs
from a seeded generator, and prints one ``RESULT {json}`` line per row with
its device time, TF/s (4 B n_q n_kv d / time, the JAX probes' count) and the
card's name and power limit, appending the same line to
``runs/torch_perf_r3_probe{8,9}.jsonl``.

Times are CUDA events around back-to-back calls queued behind a spin
kernel (``time_ms``), so they are the device's, not the wrappers'. The JAX
probes' scan harness existed to defeat the TPU's asynchronous dispatch and
has no counterpart here. The probes run on the card; ``--device cpu`` runs
only probe 9's ``--check`` (the plain versions), since a time taken on the
CPU is no device time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from typing import Callable, Dict, List, Optional

import torch

B, SEQ, HEADS, D = 2, 23040, 16, 32
N_Q = SEQ * HEADS  # heads folded into the query rows
N_KV = SEQ + 1  # null kv prepended: never tile-aligned
SCALE = D**-0.5
ITERS = 10


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn: Callable, iters: int = ITERS, warmup: int = 2) -> float:
    """Device time per call: CUDA events around ``iters`` back-to-back calls.
    A ~50 ms spin kernel is queued first so the host has enqueued every call
    before the device reaches them; the events then time the device, not
    the wrappers' host cost."""
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


def inputs(device, dtype=torch.bfloat16, seed: int = 0, shape=(B, N_Q, N_KV, D)):
    """q (b, n_q, d), k, v (b, n_kv, d): standard normals from a seeded
    generator on the device, as the JAX probes draw them."""
    b, n_q, n_kv, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(b, n, d, generator=g, device=device).to(dtype)
                 for n in (n_q, n_kv, n_kv))


def sdpa_row(q, k, v) -> Callable:
    """The library yardstick: SDPA with the shared kv expanded per head."""
    import torch.nn.functional as F

    b, n_q, d = q.shape
    qh = q.view(b, n_q // HEADS, HEADS, d).transpose(1, 2)
    kh = k[:, None].expand(b, HEADS, k.shape[1], d).contiguous()
    vh = v[:, None].expand(b, HEADS, k.shape[1], d).contiguous()
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=SCALE)


def run_rows(rows: List[Dict], q, k, v, card: str) -> List[Dict]:
    """Time each row {"name", "kind", "fn"[, "iters"]} and return its RESULT
    records (a row whose call raises is recorded with its error, as the JAX
    probes record a VMEM overflow)."""
    flops = 4.0 * q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2]
    out = []
    for row in rows:
        rec = {"name": row["name"], "kind": row["kind"], "card": card}
        try:
            ms = time_ms(row["fn"], iters=row.get("iters", ITERS))
            rec.update(ms=ms, tf_s=flops / ms / 1e9)
        except RuntimeError as exc:
            rec["error"] = str(exc)[:300]
        print("RESULT", json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(name: str, rows_fn: Callable, check: Optional[Callable] = None,
         argv: Optional[List[str]] = None) -> None:
    """The command line shared by both probes: ``--device``, ``--check``."""
    from dalle2_video_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=f"flash-forward probe {name}")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu (--check only)")
    if check is not None:
        ap.add_argument("--check", action="store_true",
                        help="the small exactness check instead of the timed rows")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if check is not None and args.check:
        check(device)
        return
    if device.type != "cuda":
        raise SystemExit(f"{name}: the timed rows need the card (--device cpu runs --check)")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(device)} ({card})", flush=True)
    records = rows_fn(device, card)
    os.makedirs("runs", exist_ok=True)
    with open(f"runs/torch_{name}.jsonl", "a") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    print(f"probe {name} complete", flush=True)
