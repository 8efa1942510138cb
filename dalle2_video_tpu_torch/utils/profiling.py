"""Tracing and per-step timing (port of dalle2_video_tpu/utils/profiling.py).

  * ``trace(logdir)``: a context manager around ``torch.profiler`` (CPU and,
    where a card is present, CUDA activities) that writes a trace
    TensorBoard's profile plugin loads (``*.pt.trace.json``).
  * ``StepTimer``: wall-clock time per step with percentile summaries and
    a throughput; one ``perf_counter`` a step, and a device sync only for
    a result handed to ``stop``.
  * ``flops_of(fn, *args)``: the FLOPs of one call as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them: matmuls,
    convolutions and attention seen by the dispatcher (elementwise work is
    not counted; a kernel launched outside the dispatcher is not seen).
    It runs ``fn`` once. The one deviation from the JAX function: where no
    count can be had it raises, where the JAX one returns 0.0, since an
    MFU would divide by a count that silently read 0.
  * ``mfu``: achieved FLOP/s over a peak the caller gives.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, List, Mapping, Optional, Set

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def _cuda_devices(result: Any, found: Set[torch.device]) -> Set[torch.device]:
    """The CUDA devices of the tensors in ``result`` (a tensor, or a tree of
    lists, tuples and dicts of them)."""
    if isinstance(result, torch.Tensor):
        if result.device.type == "cuda":
            found.add(result.device)
    elif isinstance(result, Mapping):
        for v in result.values():
            _cuda_devices(v, found)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _cuda_devices(v, found)
    return found


def wait_for(result: Any) -> None:
    """Block until the work that produces ``result`` is done: a
    ``torch.cuda.synchronize`` per CUDA device in it, nothing for CPU
    tensors (their work is done when the call returns). Nothing is copied
    to the host."""
    for dev in _cuda_devices(result, set()):
        torch.cuda.synchronize(dev)


class StepTimer:
    def __init__(self, window: int = 100):
        self.window = window
        self._times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        """Record one step; pass the step's output to wait for it first."""
        if result is not None:
            wait_for(result)
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return dt

    @contextlib.contextmanager
    def step(self):
        self.start()
        out: Dict[str, Any] = {}
        yield out
        self.stop(out.get("result"))

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        a = np.asarray(self._times)
        return {
            "step_time_mean_s": float(a.mean()),
            "step_time_p50_s": float(np.percentile(a, 50)),
            "step_time_p90_s": float(np.percentile(a, 90)),
            "steps_per_sec": float(1.0 / a.mean()),
        }


def flops_of(fn, *args, **kwargs) -> float:
    """FLOPs of one call of ``fn(*args, **kwargs)`` (run once under
    FlopCounterMode; see the module docstring). Raises where the count is
    0: no matmul, convolution or attention reached the dispatcher."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    total = counter.get_total_flops()
    if not total:
        raise ValueError(f"flops_of: FlopCounterMode counted no operation of "
                         f"{getattr(fn, '__name__', fn)!r} (no matmul, convolution or "
                         f"attention reached the dispatcher)")
    return float(total)


def mfu(flops_per_step: float, step_time_s: float, peak_flops: float) -> float:
    """Model FLOPs utilisation: flops_per_step / step_time_s / peak_flops
    (0.0 if any is 0 or missing); the peak is the caller's, for its card
    and number format."""
    if not flops_per_step or not step_time_s or not peak_flops:
        return 0.0
    return flops_per_step / step_time_s / peak_flops
