"""Generation engine: bucketed, batched text -> video sampling (the port's
copy of dalle2_video_tpu/serve/engine.py).

Owns the model-facing callable and its static-shape discipline:

  * requests are grouped by their *trace key* (cond_scale, ddim_steps) —
    one sampler call runs one guidance scale and one step grid, so mixing
    them in one batch is impossible
  * each dispatched group is padded up to the nearest batch *bucket*
    (default 1/2/4/8) by repeating the last request, so steady-state
    serving touches a finite set of shapes; padded rows are sliced off
    before the response
  * ``warmup()`` runs every bucket once for the default trace key (kernel
    builds, cuDNN algorithm choice) before the first user request

The model callable has the signature
    generate_batch(prompts, seeds, *, cond_scale, ddim_steps) -> (b, ...)
(prompts: list[str], seeds: np.uint32 array) and is built from real
prior+decoder checkpoints by scripts/serve.py — or any test double.
Inpainting requests additionally pass stacked ``inpaint_video`` /
``inpaint_mask`` (b, ...) arrays plus ``inpaint_method`` /
``inpaint_guidance_weight`` keywords — only when the group has them, so
plain callables need not accept them.
"""

from __future__ import annotations

import queue
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np

from dalle2_video_tpu_torch.serve.batcher import MicroBatcher


@dataclass(frozen=True)
class GenRequest:
    prompt: str
    seed: int = 0
    cond_scale: float = 1.0
    ddim_steps: Optional[int] = None  # None -> full DDPM schedule
    # conditional generation (engine/decoder.py inpainting): per-request
    # known video (T, H, W, C) in [0, 1] + mask broadcastable to
    # (T, H, W, 1) with 1 = known. Data, not config: rows with the SAME
    # inpaint signature (shapes/method/weight — anything trace-static)
    # batch together; their tensors ride the dispatch as stacked args.
    inpaint_video: Optional[np.ndarray] = None
    inpaint_mask: Optional[np.ndarray] = None
    inpaint_method: str = "replace"
    inpaint_guidance_weight: float = 10.0
    # negative prompting (CFG away from a concept; see engine/decoder.py).
    # The negative prompt is per-row DATA like the prompt; only its
    # PRESENCE is trace-static (the extra prior/text-tower pass).
    negative_prompt: Optional[str] = None
    # long video (engine/longvideo.py): n_frames beyond the decoder window
    # via sliding-window extension. Trace-static — the window schedule and
    # the response shape are baked per (n_frames, overlap) group; the
    # underlying per-window compiled programs are SHARED across n_frames.
    n_frames: Optional[int] = None
    overlap: Optional[int] = None

    @property
    def trace_key(self) -> Tuple:
        inp = None
        if self.inpaint_video is not None:
            inp = (
                tuple(self.inpaint_video.shape),
                None if self.inpaint_mask is None
                else tuple(self.inpaint_mask.shape),
                str(self.inpaint_method),
                float(self.inpaint_guidance_weight),
            )
        return (float(self.cond_scale), self.ddim_steps, inp,
                self.negative_prompt is not None,
                self.n_frames, self.overlap)


def _next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class GenerationEngine:
    """``generate_batch`` may be ONE callable (single chip) or a sequence
    of callables, one per device replica (e.g. the same sampler built on
    ``cuda:i``, or per-host endpoints). Replicas
    live in an idle pool; up to ``len(replicas)`` trace-key groups run
    concurrently, so distinct keys no longer serialize behind one device
    lock the day multi-chip serving exists. One replica == the original
    fully serialized behavior."""

    def __init__(
        self,
        generate_batch: Union[Callable[..., np.ndarray],
                              Sequence[Callable[..., np.ndarray]]],
        *,
        buckets: Sequence[int] = (1, 2, 4, 8),
        max_wait_ms: float = 10.0,
        default_cond_scale: float = 1.0,
        default_ddim_steps: Optional[int] = None,
    ):
        fns = (list(generate_batch)
               if isinstance(generate_batch, (list, tuple))
               else [generate_batch])
        if not fns:
            raise ValueError("generate_batch: need at least one callable")
        self._n_replicas = len(fns)
        # FIFO pool: get/put rotates, so sequential groups round-robin
        # across replicas (and warmup visits every one)
        self._replicas: "queue.Queue" = queue.Queue()
        for fn in fns:
            self._replicas.put(fn)
        self._buckets = tuple(sorted(buckets))
        self._default_key = (
            float(default_cond_scale), default_ddim_steps, None, False,
            None, None,
        )
        self._batcher = MicroBatcher(
            self._run_group,
            max_batch=self._buckets[-1],
            max_wait_ms=max_wait_ms,
            key_fn=lambda req: req.trace_key,
            dispatch_workers=self._n_replicas,
        )

    # ------------------------------------------------------------- #
    @property
    def default_cond_scale(self) -> float:
        return self._default_key[0]

    @property
    def default_ddim_steps(self) -> Optional[int]:
        return self._default_key[1]

    def submit(self, req: GenRequest) -> Future:
        """Returns a Future resolving to a dict: video (np.ndarray for
        THIS request), batch_size it rode in, device_ms of the call."""
        if req.inpaint_video is not None and req.inpaint_mask is None:
            raise ValueError("inpaint_video requires inpaint_mask")
        if req.n_frames is not None and req.inpaint_video is not None:
            raise ValueError(
                "n_frames (long video) and inpaint_video are mutually "
                "exclusive — the long-video path drives the inpainting "
                "machinery itself"
            )
        if req.overlap is not None and req.n_frames is None:
            raise ValueError("overlap requires n_frames")
        return self._batcher.submit(req)

    def generate(self, req: GenRequest, timeout: Optional[float] = None) -> dict:
        return self.submit(req).result(timeout=timeout)

    def warmup(self) -> dict:
        """Run every bucket at the default trace key on EVERY replica;
        returns per-bucket seconds summed over replicas."""
        cond_scale, steps = self._default_key[:2]
        timings: dict = {}
        # replicas INSIDE buckets: n_replicas consecutive _run_group calls
        # rotate through the whole FIFO pool, so each bucket shape runs
        # on every replica (outer-loop order would alias rotation parity)
        for b in self._buckets:
            for _ in range(self._n_replicas):
                reqs = [
                    GenRequest("warmup", seed=i, cond_scale=cond_scale,
                               ddim_steps=steps)
                    for i in range(b)
                ]
                t0 = time.time()
                # drive through the group runner directly (bypass the queue
                # so warmup shapes are exactly the bucket shapes)
                self._run_group(self._default_key, reqs)
                timings[b] = round(
                    timings.get(b, 0.0) + time.time() - t0, 3
                )
        return timings

    def stats(self) -> dict:
        return self._batcher.stats.snapshot()

    def close(self) -> None:
        self._batcher.close()

    # ------------------------------------------------------------- #
    def _run_group(self, key, reqs) -> list:
        cond_scale, ddim_steps, inp, has_negative, n_frames, overlap = key
        n = len(reqs)
        bucket = _next_bucket(n, self._buckets)
        padded = list(reqs) + [reqs[-1]] * (bucket - n)
        prompts = [r.prompt for r in padded]
        seeds = np.asarray([r.seed for r in padded], dtype=np.uint32)
        extra = {}
        if inp is not None:
            # the trace key pins shapes/method/weight, so stacking is safe;
            # padding repeats the last row's tensors like its prompt/seed
            extra = dict(
                inpaint_video=np.stack(
                    [np.asarray(r.inpaint_video, np.float32) for r in padded]
                ),
                inpaint_mask=np.stack(
                    [np.asarray(r.inpaint_mask, np.float32) for r in padded]
                ),
                inpaint_method=inp[2],
                inpaint_guidance_weight=inp[3],
            )
        if has_negative:
            extra["negative_prompts"] = [r.negative_prompt for r in padded]
        if n_frames is not None:
            extra["n_frames"] = n_frames
            extra["overlap"] = overlap
        # draw an idle replica (blocks when all are busy — the batcher's
        # dispatch semaphore matches the pool size, so this only briefly
        # races between dispatch threads)
        fn = self._replicas.get()
        try:
            t0 = time.time()
            videos = fn(
                prompts, seeds, cond_scale=cond_scale, ddim_steps=ddim_steps,
                **extra,
            )
            device_ms = (time.time() - t0) * 1e3
        finally:
            self._replicas.put(fn)
        videos = np.asarray(videos)[:n]
        return [
            {"video": videos[i], "batch_size": n, "bucket": bucket,
             "device_ms": round(device_ms, 1)}
            for i in range(n)
        ]
