"""Dependency-free HTTP JSON API over the GenerationEngine.

Endpoints (stdlib ThreadingHTTPServer — each request blocks its own
thread on the engine Future while the micro-batcher coalesces):

  POST /v1/generate   {"prompt": str, "seed": int?, "cond_scale": float?,
                       "ddim_steps": int?, "format": "npy_b64"|"meta",
                       "inpaint_video_b64": <base64 .npy>?,
                       "inpaint_mask_b64": <base64 .npy>?,
                       "inpaint_method": "replace"|"guided"?,
                       "inpaint_guidance_weight": float?,
                       "negative_prompt": str?,
                       "n_frames": int?, "overlap": int?}
      omitted cond_scale/ddim_steps fall back to the engine's configured
      defaults (the trace key warmup() pre-compiled); ddim_steps=0
      explicitly requests the full DDPM schedule. `seed` is reproducible
      PER REQUEST: the sampler uses per-row PRNG keys (utils/keys.py), so
      the same (prompt, seed, cond_scale, ddim_steps) returns the same
      video regardless of micro-batch grouping or padding.
      Conditional generation: inpaint_video_b64 is a base64 .npy
      (T, H, W, C) float video in [0, 1]; inpaint_mask_b64 a base64 .npy
      mask broadcastable to (T, H, W, 1), 1 = known region kept exactly
      (video extension / temporal interpolation / spatial inpainting —
      see engine/decoder.py)
      Long video: n_frames beyond the decoder's training window generates
      by sliding-window extension (engine/longvideo.py; optional overlap,
      default a quarter window). Mutually exclusive with inpaint_video.
      -> {"shape": [...], "dtype": str, "batch_size": n, "bucket": b,
          "device_ms": ms, "data_b64": <base64 .npy>?}
  GET  /healthz       -> {"status": "ok", "device": "..."}
  GET  /v1/stats      -> batching counters (requests, batches, mean size)

``format: "meta"`` skips the payload (health probes / load tests);
``npy_b64`` returns the full video tensor as a base64-encoded .npy;
``gif_b64`` returns a base64 GIF of the clip (optional ``fps``, demo use).
"""

from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from dalle2_video_tpu_torch.serve.engine import GenerationEngine, GenRequest


def _npy_b64(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, arr)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _b64_npy(s: str, name: str, ndim: int = 4) -> np.ndarray:
    try:
        arr = np.load(io.BytesIO(base64.b64decode(s)), allow_pickle=False)
    except Exception as exc:  # noqa: BLE001 — any decode failure is a 400
        raise ValueError(f"{name} is not a base64 .npy payload: {exc}")
    if arr.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {arr.shape}")
    return np.asarray(arr, np.float32)


def _gif_b64(video: np.ndarray, fps: int = 8) -> str:
    """(T, H, W, C) float video in [0, 1] -> base64 GIF (demo payload)."""
    import imageio.v2 as imageio

    frames = (np.clip(video, 0.0, 1.0) * 255).astype(np.uint8)
    buf = io.BytesIO()
    imageio.mimwrite(buf, list(frames), format="gif", duration=1.0 / fps)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def make_server(
    engine: GenerationEngine,
    host: str = "127.0.0.1",
    port: int = 8000,
    device_name: str = "unknown",
) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        # quiet request logging (JSONL metrics cover serving logs)
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "device": device_name})
            elif self.path == "/v1/stats":
                self._json(200, engine.stats())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/v1/generate":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("payload must be a JSON object")
                # omitted fields fall back to the ENGINE's configured
                # defaults — the trace key warmup() pre-compiled; a client
                # passing ddim_steps=0 explicitly requests the full DDPM
                # schedule (None)
                if "ddim_steps" in payload:
                    ds = payload["ddim_steps"]
                    ddim_steps = int(ds) if ds else None
                else:
                    ddim_steps = engine.default_ddim_steps
                inpaint_video = inpaint_mask = None
                if payload.get("inpaint_video_b64"):
                    inpaint_video = _b64_npy(
                        payload["inpaint_video_b64"], "inpaint_video"
                    )
                    if not payload.get("inpaint_mask_b64"):
                        raise ValueError("inpaint_video requires inpaint_mask")
                    inpaint_mask = _b64_npy(
                        payload["inpaint_mask_b64"], "inpaint_mask"
                    )
                req = GenRequest(
                    prompt=str(payload["prompt"]),
                    seed=int(payload.get("seed") or 0),
                    cond_scale=float(
                        payload.get("cond_scale", engine.default_cond_scale)
                    ),
                    ddim_steps=ddim_steps,
                    inpaint_video=inpaint_video,
                    inpaint_mask=inpaint_mask,
                    inpaint_method=str(
                        payload.get("inpaint_method", "replace")
                    ),
                    inpaint_guidance_weight=float(
                        payload.get("inpaint_guidance_weight", 10.0)
                    ),
                    negative_prompt=(
                        str(payload["negative_prompt"])
                        if payload.get("negative_prompt") else None
                    ),
                    n_frames=(
                        int(payload["n_frames"])
                        if payload.get("n_frames") else None
                    ),
                    overlap=(
                        int(payload["overlap"])
                        if payload.get("overlap") else None
                    ),
                )
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as exc:
                self._json(400, {"error": f"bad request: {exc}"})
                return
            try:
                res = engine.generate(req, timeout=payload.get("timeout"))
            except ValueError as exc:  # request-level validation -> 400
                self._json(400, {"error": f"bad request: {exc}"})
                return
            except Exception as exc:  # noqa: BLE001 — surface as 500
                self._json(500, {"error": str(exc)})
                return
            video = res["video"]
            out = {
                "shape": list(video.shape),
                "dtype": str(video.dtype),
                "batch_size": res["batch_size"],
                "bucket": res["bucket"],
                "device_ms": res["device_ms"],
            }
            fmt = payload.get("format", "npy_b64")
            if fmt == "npy_b64":
                out["data_b64"] = _npy_b64(video)
            elif fmt == "gif_b64":
                out["gif_b64"] = _gif_b64(
                    np.asarray(video, np.float32),
                    fps=int(payload.get("fps", 8)),
                )
            self._json(200, out)

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever(
    engine: GenerationEngine,
    host: str = "127.0.0.1",
    port: int = 8000,
    device_name: str = "unknown",
    ready_event: Optional[threading.Event] = None,
) -> None:
    httpd = make_server(engine, host, port, device_name)
    if ready_event is not None:
        ready_event.set()
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
