"""Serving entry point: text -> video over HTTP on the GPU.

    python -m dalle2_video_tpu_torch.serve [config.yaml] [key=value ...]
    python -m dalle2_video_tpu_torch.serve smoke=true serve_port=8000

Same config keys as scripts/serve.py (the built-in celebv_text settings
when no YAML is given), plus ``device`` (default cuda) and the sampling
knobs ``unetN.groupnorm_impl=pallas`` (or ``fused``: the fused conv +
GroupNorm block kernels), ``unetN.spatial_conv_impl=pallas_small`` (the 3x3
conv kernel at small-spatial sites), ``unetN.cross_attention_impl=flash``
(or the plain ``xla``, which guided inpainting needs: the kernel has no
backward), ``flash_attention_sampling=true`` and ``sampler=dpmpp``
(DPM-Solver++(2M) in place of DDIM). A request may carry a negative
prompt, a video to inpaint (``replace`` or ``guided``) or a frame count
beyond the window (long video): see serve/server.py. Endpoints: POST
/v1/generate, GET /healthz, GET /v1/stats.
"""

from __future__ import annotations

import logging

import torch

from dalle2_video_tpu_torch.serve.engine import GenerationEngine
from dalle2_video_tpu_torch.serve.server import serve_forever
from dalle2_video_tpu_torch.serve.stack import apply_smoke, build_generate_batch
from dalle2_video_tpu_torch.utils.config import config_from_argv
from dalle2_video_tpu_torch.utils.device import resolve_device


def main() -> None:
    cfg = config_from_argv()
    logging.basicConfig(level=cfg.get("log_level", "INFO"))
    log = logging.getLogger("serve")
    if bool(cfg.get("smoke", False)):
        cfg = apply_smoke(cfg)
    device = resolve_device(cfg.get("device"))
    generate_batch = build_generate_batch(cfg, log, device)
    engine = GenerationEngine(
        generate_batch,
        buckets=tuple(cfg.get("serve_buckets", (1, 2, 4))),
        max_wait_ms=float(cfg.get("serve_max_wait_ms", 25.0)),
        default_cond_scale=float(cfg.get("cond_scale", 1.0)),
        default_ddim_steps=(
            int(cfg["serve_ddim_steps"]) if cfg.get("serve_ddim_steps") else None
        ),
    )
    if cfg.get("warmup", True):
        log.info("warmup timings: %s", engine.warmup())
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    host, port = cfg.get("serve_host", "127.0.0.1"), int(cfg.get("serve_port", 8000))
    log.info("serving on http://%s:%d (device %s)", host, port, name)
    serve_forever(engine, host, port, device_name=name)


if __name__ == "__main__":
    main()
