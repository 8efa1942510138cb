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

Data-parallel serving over every card of a host:

    torchrun --nproc_per_node=4 -m dalle2_video_tpu_torch.serve serve_data_parallel=true

Each rank builds the stack on ``cuda:LOCAL_RANK`` (NCCL; gloo with
``device=cpu``); rank 0 serves HTTP, its buckets rounded up to multiples of
the ranks, and every group is split over them (serve/stack.py::
DataParallelGenerate).
"""

from __future__ import annotations

import logging

import torch

import torch.distributed as dist

from dalle2_video_tpu_torch.parallel.mesh import create_mesh, maybe_init_distributed, rank_device
from dalle2_video_tpu_torch.parallel.sharded import data_parallel_buckets
from dalle2_video_tpu_torch.serve.engine import GenerationEngine
from dalle2_video_tpu_torch.serve.server import serve_forever
from dalle2_video_tpu_torch.serve.stack import (
    DataParallelGenerate,
    apply_smoke,
    build_generate_batch,
    serve_worker,
)
from dalle2_video_tpu_torch.utils.config import config_from_argv
from dalle2_video_tpu_torch.utils.device import resolve_device


def main(argv=None) -> None:
    cfg = config_from_argv(argv)
    logging.basicConfig(level=cfg.get("log_level", "INFO"))
    log = logging.getLogger("serve")
    if bool(cfg.get("smoke", False)):
        cfg = apply_smoke(cfg)
    if not bool(cfg.get("serve_data_parallel", False)):
        device = resolve_device(cfg.get("device"))
        _serve(cfg, log, device, build_generate_batch(cfg, log, device),
               tuple(cfg.get("serve_buckets", (1, 2, 4))))
        return
    device = resolve_device(rank_device(cfg.get("device")))
    maybe_init_distributed(True, device=device)
    try:
        mesh = create_mesh(device=device)
        dp = DataParallelGenerate(build_generate_batch(cfg, log, device), mesh)
        if mesh.rank != 0:
            log.info("rank %d served %d groups", mesh.rank, serve_worker(dp))
            return
        buckets = data_parallel_buckets(cfg.get("serve_buckets", (1, 2, 4)), mesh.data)
        log.info("data-parallel serving over %d ranks, buckets %s", mesh.data, buckets)
        try:
            _serve(cfg, log, device, dp, buckets)
        finally:
            dp.stop()
    finally:
        dist.destroy_process_group()


def _serve(cfg, log, device, generate_batch, buckets) -> None:
    engine = GenerationEngine(
        generate_batch,
        buckets=buckets,
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
